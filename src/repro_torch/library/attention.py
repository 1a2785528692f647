"""Attention Library Nodes (paper §3): decode attention over paged KV.

``PagedAttnDecode`` abstracts one serving decode step of attention for a
whole batch: q is (B, H, Dh), the context K/V — gathered from the paged
KV pool via the block table — is (B, C, H, Dh) with C the context
bucket, and ``pos`` (B,) carries each sequence's absolute position for
causal/window masking. Expansion levels, most specialized first (the
reference's names in brackets):

  * ``flash``   -- delegate to the hand-written CUDA kernel
                   (``kernels.attention.decode_attention``), the paper's
                   'vendor library' level;
  * ``cuda``    -- [``pallas``] a generic (b, h) mapped tasklet whose
                   affine memlets let MapTiling + GridConversion derive a
                   generated grid kernel (the serving default: the
                   attention step shows up in ``report['grid_kernels']``,
                   one row program per (b, h));
  * ``torch``   -- [``xla``] one tasklet of whole-array PyTorch ops;
  * ``generic`` -- the (b, h) map, as ``cuda``.

All share one masking contract: key j participates iff ``j <= pos[b]``
(and ``j > pos[b] - window`` when sliding-window), so unwritten pages and
the null page of inactive slots never reach the softmax regardless of
what they hold.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..codegen import vocab
from ..core.memlet import Memlet, Range, Subset
from ..core.sdfg import LibraryNode, SDFG, State
from ..core.symbolic import Expr, sym
from .util import in_edge, out_edge, replace_with_tasklet

NEG_INF = -1e30


def _operand_shape(sdfg: SDFG, state: State, node, conn: str):
    e = in_edge(state, node, conn)
    desc = sdfg.arrays[e.memlet.data]
    return tuple(int(Expr.wrap(s).evaluate(sdfg.symbol_values))
                 for s in desc.shape)


def _out_dtype(sdfg: SDFG, state: State, node) -> str:
    return sdfg.arrays[out_edge(state, node, "out").memlet.data].dtype.name


def _expand_torch(node: "PagedAttnDecode", sdfg: SDFG, state: State):
    _, ctx, _, dh = _operand_shape(sdfg, state, node, "k")
    scale = 1.0 / math.sqrt(dh)
    window = node.window

    def attn(q, k, v, pos):
        s = torch.einsum("bhd,bchd->bhc", q.float(), k.float()) * scale
        j = torch.arange(ctx, device=q.device)[None, None, :]
        p = pos.long()[:, None, None]
        mask = j <= p
        if window is not None:
            mask &= j > p - window
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
        prob = torch.softmax(s, dim=-1)
        out = torch.einsum("bhc,bchd->bhd", prob, v.float())
        return {"out": out.to(q.dtype)}

    replace_with_tasklet(node, sdfg, state, attn, "torch")


def _expand_flash(node: "PagedAttnDecode", sdfg: SDFG, state: State):
    window = node.window

    def attn(q, k, v, pos):
        from ..kernels.attention import decode_attention
        return {"out": decode_attention(q, k, v, pos, window=window)}

    replace_with_tasklet(node, sdfg, state, attn, "flash")


def _expand_grid(node: "PagedAttnDecode", sdfg: SDFG, state: State):
    """Generic (b, h) map over per-head attention rows.

    Every memlet is affine in the map parameters (the context and head-dim
    extents move as whole dims), so GridConversion can factor them; each
    iteration reads a (C, Dh) K and V window, which makes the traced body
    a row program (``cuda_backend._RowEmitter``): one program per (b, h),
    K and V streamed through in chunks, the softmax's max and normalizer
    by a running-max loop, then p @ V.
    """
    eq = in_edge(state, node, "q")
    ek = in_edge(state, node, "k")
    ev = in_edge(state, node, "v")
    ep = in_edge(state, node, "pos")
    eo = out_edge(state, node, "out")
    b_n, h_n, dh = _operand_shape(sdfg, state, node, "q")
    _, ctx, _, _ = _operand_shape(sdfg, state, node, "k")
    scale = 1.0 / math.sqrt(dh)
    window = node.window
    out_dtype = _out_dtype(sdfg, state, node)

    def attn_row(q, k, v, pos):
        qf = vocab.to_f32(q)
        kf = vocab.to_f32(k)
        s = (kf @ qf) * scale                       # (C,)
        j = vocab.iota(ctx, like=kf)
        mask = j <= pos
        if window is not None:
            mask = mask & (j > pos - window)
        s = vocab.where(mask, s, NEG_INF)
        p = vocab.softmax(s)
        out = p @ vocab.to_f32(v)
        return {"out": vocab.cast(out, out_dtype)}

    b, h = sym("b"), sym("h")
    qd, kd, vd = eq.memlet.data, ek.memlet.data, ev.memlet.data
    pd, od = ep.memlet.data, eo.memlet.data
    state.remove_node(node)
    state.add_mapped_tasklet(
        f"{node.label}_grid", {"b": (0, b_n), "h": (0, h_n)},
        inputs={
            "q": Memlet.simple(qd, Subset([Range.index(b), Range.index(h),
                                           Range.make(0, dh)])),
            "k": Memlet.simple(kd, Subset([Range.index(b),
                                           Range.make(0, ctx),
                                           Range.index(h),
                                           Range.make(0, dh)])),
            "v": Memlet.simple(vd, Subset([Range.index(b),
                                           Range.make(0, ctx),
                                           Range.index(h),
                                           Range.make(0, dh)])),
            "pos": Memlet.simple(pd, Subset([Range.index(b)])),
        },
        outputs={
            "out": Memlet.simple(od, Subset([Range.index(b), Range.index(h),
                                             Range.make(0, dh)])),
        },
        fn=attn_row,
        input_nodes={qd: eq.src, kd: ek.src, vd: ev.src, pd: ep.src},
        output_nodes={od: eo.dst},
    )


class PagedAttnDecode(LibraryNode):
    """Batched single-token decode attention over a gathered context.

    Connectors: q (B, H, Dh), k/v (B, C, H, Dh) — already GQA-repeated to
    H heads by the page gather — pos (B,) int32 -> out (B, H, Dh).
    """

    expansions = {
        "flash": _expand_flash,
        "cuda": _expand_grid,
        "torch": _expand_torch,
        "generic": _expand_grid,
    }
    default_expansion = "torch"

    def __init__(self, name: str, window: Optional[int] = None):
        super().__init__(name, inputs=["q", "k", "v", "pos"],
                         outputs=["out"])
        self.window = window
