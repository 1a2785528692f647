"""The compiled serving decode step.

One whole decode step — embed, every layer's attention + FFN over the
paged KV cache (or its Mamba block + FFN, or its RWKV block, over per-slot
state rows), final norm + logits — is built as a single ``@dc_program``
SDFG and lowered through ``default_pipeline("cuda")``. The attention of
each layer enters the graph as a :class:`~repro_torch.library.
PagedAttnDecode` Library Node whose ``cuda`` expansion is a (b, h) mapped
tasklet, so MapTiling + GridConversion turn it into a generated grid
kernel inside the compiled step (``attn{li}_grid_tiled`` in
``Compiled.report["grid_kernels"]``). Everything around it — QKV
projection + RoPE, the paged KV write, the page gather, the FFN, the
Mamba and RWKV blocks, the head — are whole-array tasklets replicating
``models.blocks`` decode math, so the compiled step matches
``TransformerLM.decode_step`` token for token.
With ``expansion_level="flash"`` the attention is the hand-written
``decode_attention`` CUDA kernel instead.

Shape bucketing: the step is specialized on ``(B, ctx)`` — the padded
batch bucket and the context bucket (a multiple of the page size covering
the longest live sequence). Each bucket is one SDFG whose content hash
keys the process-wide ``COMPILATION_CACHE``; re-entering a bucket is a
cache hit, no re-lowering. Padding lanes ride along: their block-table
rows are zero, so their KV writes land on the pool's null page and their
attention reads pages that the ``j <= pos`` mask never admits.

Buffers: the weights are step inputs, read where they lie (no copy). The
reference donates the page and state arrays through
``jax.jit(donate_argnums=...)``; here the KV-write and recurrent tasklets
write them in place, so a donating step consumes last step's pages and states
and returns this step's without a copy. A step built with
``donate=False`` (the fault-tolerant mode) writes into copies instead and
leaves its inputs intact, so a failed step can rerun from them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codegen.torch_backend import classify_arguments
from ..core.memlet import Memlet
from ..frontends.api import Program, TensorHandle, dc_program
from ..library import PagedAttnDecode
from ..models import blocks
from ..models.layers import apply_rope, layer_norm, rms_norm
from ..pipeline.cache import COMPILATION_CACHE, CompilationCache
from ..pipeline.passes import (ExpandLibraryNodesPass, GridConversionPass,
                               MapFusionPass, MapTilingPass, PassManager,
                               PipelineFusionPass, SetExpansionPreferencePass,
                               VectorizationPass, default_pipeline)
from .faults import degrades
from .graphs import CapturedStep, StepGraphs
from .pages import dtype_name


def _no_shards(n_shards: int):
    if n_shards > 1:
        raise NotImplementedError(
            "sharded serving (n_shards > 1) is ROADMAP step 10c: the "
            "partition analysis (ShardMapPass) is ported, but the sharded "
            "decode step and its mesh are not yet")


# ---------------------------------------------------------------------------
# Model introspection: flat layer order, weight/state naming
# ---------------------------------------------------------------------------
def flat_layer_specs(model) -> List:
    """Layer specs in execution order: periods unrolled, then the tail."""
    return list(model.layer_specs)


def attention_layer_shapes(model) -> Dict[int, Tuple[int, int]]:
    """flat layer index -> (n_kv_heads, head_dim) for every attn layer."""
    cfg = model.cfg
    return {li: (cfg.n_kv_heads, cfg.head_dim)
            for li, spec in enumerate(flat_layer_specs(model))
            if spec.kind == "attn"}


def flatten_params(model, params) -> Dict[str, torch.Tensor]:
    """The parameter tree -> flat ``L{li}__{group}__{key}`` tensors (+
    embed and head), the same names and order as the reference's, so two
    flattenings of one model build identical SDFGs. No tensor is copied."""
    out: Dict[str, torch.Tensor] = {"embed": params["embed"]}
    for li, layer in enumerate(params["layers"]):
        for gname, gdict in layer.items():
            for k, a in gdict.items():
                out[f"L{li}__{gname}__{k}"] = a
    out["final_scale"] = params["final_scale"]
    if "final_bias" in params:
        out["final_bias"] = params["final_bias"]
    if not model.cfg.tie_embeddings:
        out["lm_head"] = params["lm_head"]
    return out


def state_specs(model) -> Dict[str, Tuple[int, Tuple[int, ...], str]]:
    """Per-slot recurrent-state rows of the RWKV and Mamba layers:
    ``st{li}__{key}`` -> (flat layer index, per-row shape, dtype), the
    reference's names and dtype strings. Attention layers have none."""
    cfg = model.cfg
    out: Dict[str, Tuple[int, Tuple[int, ...], str]] = {}
    for li, spec in enumerate(flat_layer_specs(model)):
        if spec.kind == "rwkv":
            one = blocks.rwkv_cache_init(cfg, 1, device="meta")
        elif spec.kind == "mamba":
            one = blocks.mamba_cache_init(cfg, 1, device="meta")
        else:
            continue
        for key in sorted(one):
            a = one[key]
            out[f"st{li}__{key}"] = (li, tuple(a.shape[1:]),
                                     dtype_name(a.dtype))
    return out


# ---------------------------------------------------------------------------
# Building the step's SDFG
# ---------------------------------------------------------------------------
def _tasklet(p: Program, label: str, ins: Dict[str, TensorHandle],
             outs: Dict[str, object], fn) -> Dict[str, TensorHandle]:
    """Wire one tasklet. ``outs`` values are either an existing handle (an
    in/out container — gets a fresh access-node version) or a
    ``(shape, dtype)`` tuple (a new transient)."""
    st = p.state
    t = st.add_tasklet(label, list(ins), list(outs), fn)
    for conn, h in ins.items():
        st.add_edge(h.read_node(), None, t, conn, Memlet.simple(h.name))
    res = {}
    for conn, spec in outs.items():
        if isinstance(spec, tuple):
            h = p.temp(spec[0], spec[1], name=f"{label}_{conn}")
        else:
            h = spec
        st.add_edge(t, conn, h.fresh_write_node(), None,
                    Memlet.simple(h.name))
        res[conn] = h
    return res


@dc_program
def serving_decode_step(p: Program, model=None, wspecs=None, B=None,
                        ctx=None, page_size=None, n_pages=None,
                        cache_dtype="bfloat16"):
    """One full decode step over the paged cache, specialized on (B, ctx).

    Inputs: tokens (B,1) i32, positions (B,) i32, block_table
    (B, ctx/page_size) i32, flat weights, per-attention-layer page arrays
    kp{li}/vp{li}, per-recurrent-layer state rows st{li}__*. Outputs:
    logits (B, V) plus the updated page and state containers (written in
    place by the KV-write and recurrent tasklets).
    """
    cfg = model.cfg
    adt = cfg.activation_dtype
    D = cfg.d_model
    vocab_padded = model.vocab_padded
    specs = flat_layer_specs(model)
    sspecs = state_specs(model)

    tokens = p.input("tokens", (B, 1), "int32")
    positions = p.input("positions", (B,), "int32")
    bt = p.input("block_table", (B, ctx // page_size), "int32")
    wh = {name: p.input(name, shape, dt)
          for name, (shape, dt) in wspecs.items()}
    kph, vph = {}, {}
    for li, spec in enumerate(specs):
        if spec.kind == "attn":
            shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
            kph[li] = p.input(f"kp{li}", shape, cache_dtype)
            vph[li] = p.input(f"vp{li}", shape, cache_dtype)
    sth = {name: p.input(name, (B,) + shape, dt)
           for name, (li, shape, dt) in sspecs.items()}

    def embed_fn(tokens, embed):
        return {"x": embed[tokens[:, 0].long()].to(getattr(torch, adt))}

    x = _tasklet(p, "embed", {"tokens": tokens, "embed": wh["embed"]},
                 {"x": ((B, D), adt)}, embed_fn)["x"]

    for li, spec in enumerate(specs):
        def w(g, k, li=li):
            return wh[f"L{li}__{g}__{k}"]
        if spec.kind == "attn":
            x = _attn_layer(p, cfg, li, spec, x, positions, bt, w,
                            kph[li], vph[li], B, ctx, page_size)
            x = _ffn_layer(p, cfg, li, spec, x, w, B, D)
        elif spec.kind == "mamba":
            x = _recurrent_layer(p, cfg, li, "mamba", blocks.mamba_apply,
                                 x, w, sth, sspecs, B, D)
            x = _ffn_layer(p, cfg, li, spec, x, w, B, D)
        elif spec.kind == "rwkv":
            x = _recurrent_layer(p, cfg, li, "rwkv", blocks.rwkv_apply,
                                 x, w, sth, sspecs, B, D)
        else:
            raise ValueError(f"unknown layer kind {spec.kind!r}")

    head_ins = {"x": x, "final_scale": wh["final_scale"]}
    if cfg.norm == "layernorm":
        head_ins["final_bias"] = wh["final_bias"]
    if cfg.tie_embeddings:
        head_ins["embed"] = wh["embed"]
    else:
        head_ins["lm_head"] = wh["lm_head"]

    def head_fn(x, final_scale, final_bias=None, embed=None, lm_head=None):
        xs = x[:, None, :]
        if cfg.norm == "rmsnorm":
            xs = rms_norm(xs, final_scale)
        else:
            xs = layer_norm(xs, final_scale + 1.0, final_bias)
        tadt = getattr(torch, adt)
        head = embed.T if cfg.tie_embeddings else lm_head
        lg = torch.matmul(xs.to(tadt), head.to(tadt))
        if cfg.tie_embeddings:
            # a filled scalar, not a host tensor copied over: nothing in
            # the step may read or write host memory while it is captured
            lg = lg * torch.full((), float(np.float32(
                1.0 / np.sqrt(cfg.d_model))), dtype=torch.float32,
                device=lg.device).to(lg.dtype)
        if vocab_padded != cfg.vocab:
            pad = torch.arange(vocab_padded, device=lg.device) >= cfg.vocab
            lg = torch.where(pad, torch.full((), -1e30, dtype=lg.dtype,
                                             device=lg.device), lg)
        return {"logits": lg[:, 0]}

    lg = _tasklet(p, "head", head_ins,
                  {"logits": ((B, vocab_padded), adt)}, head_fn)["logits"]
    p.output("logits", lg)

    # the reference's partition hints for ShardMapPass (inert here: the
    # sharded step, ROADMAP step 10c, is not ported), kept so the SDFGs
    # carry the same metadata: per-slot containers split on the batch dim,
    # page arrays on the page dim, weights replicate
    declared = {"tokens": 0, "positions": 0, "block_table": 0, "logits": 0}
    declared.update({name: None for name in wspecs})
    for li in kph:
        declared[f"kp{li}"] = 0
        declared[f"vp{li}"] = 0
    declared.update({name: 0 for name in sspecs})
    p.sdfg.metadata["shard_declared"] = declared


def _attn_layer(p, cfg, li, spec, x, positions, bt, w, kp, vp, B, ctx, ps):
    """QKV -> paged KV write -> page gather -> PagedAttnDecode -> proj.

    The tasklet math mirrors ``blocks.attn_apply``'s decode branch (same
    casts, same op order), so the compiled step reproduces
    ``decode_step`` on the positions the mask admits.
    """
    adt = cfg.activation_dtype
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    D = cfg.d_model
    cache_dtype = p.sdfg.arrays[kp.name].dtype.name

    qkv_ins = {"x": x, "positions": positions, "wq": w("attn", "wq"),
               "wk": w("attn", "wk"), "wv": w("attn", "wv"),
               "ln_scale": w("attn", "ln_scale")}
    if cfg.norm == "layernorm":
        qkv_ins["ln_bias"] = w("attn", "ln_bias")

    def qkv_fn(x, positions, wq, wk, wv, ln_scale, ln_bias=None):
        tadt = getattr(torch, adt)
        pn = {"ln_scale": ln_scale}
        if ln_bias is not None:
            pn["ln_bias"] = ln_bias
        xs = x[:, None, :]
        h = blocks._norm(cfg, xs, pn, "ln").to(tadt)
        q = torch.matmul(h, wq.to(tadt)).reshape(-1, 1, H, dh)
        k = torch.matmul(h, wk.to(tadt)).reshape(-1, 1, Hkv, dh)
        v = torch.matmul(h, wv.to(tadt)).reshape(-1, 1, Hkv, dh)
        pos2 = positions[:, None]
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)
        cdt = getattr(torch, cache_dtype)
        return {"q": q[:, 0], "k_new": k[:, 0].to(cdt),
                "v_new": v[:, 0].to(cdt)}

    qkv = _tasklet(p, f"qkv{li}", qkv_ins,
                   {"q": ((B, H, dh), adt),
                    "k_new": ((B, Hkv, dh), cache_dtype),
                    "v_new": ((B, Hkv, dh), cache_dtype)}, qkv_fn)

    def kvw_fn(kp, vp, k_new, v_new, bt, positions):
        # in place: the step owns (or, not donating, was handed copies of)
        # the page arrays
        pos = positions.long()
        page = torch.gather(bt.long(), 1, (pos // ps)[:, None])[:, 0]
        off = pos % ps
        kp[page, off] = k_new
        vp[page, off] = v_new
        return {"kp_out": kp, "vp_out": vp}

    _tasklet(p, f"kvw{li}",
             {"kp": kp, "vp": vp, "k_new": qkv["k_new"],
              "v_new": qkv["v_new"], "bt": bt, "positions": positions},
             {"kp_out": kp, "vp_out": vp}, kvw_fn)

    def gather_fn(kp, vp, bt):
        tadt = getattr(torch, adt)
        rep = H // Hkv

        def expand(pages):
            c = pages[bt.long()].reshape(-1, ctx, Hkv, dh)
            if rep > 1:
                b = c.shape[0]
                c = c[:, :, :, None, :].expand(b, ctx, Hkv, rep, dh).reshape(
                    b, ctx, H, dh)
            return c.to(tadt)

        return {"ck": expand(kp), "cv": expand(vp)}

    g = _tasklet(p, f"gather{li}", {"kp": kp, "vp": vp, "bt": bt},
                 {"ck": ((B, ctx, H, dh), adt),
                  "cv": ((B, ctx, H, dh), adt)}, gather_fn)

    node = PagedAttnDecode(f"attn{li}", window=spec.window)
    attn = p.add_op(node, {"q": qkv["q"], "k": g["ck"], "v": g["cv"],
                           "pos": positions},
                    out_shapes={"out": (B, H, dh)},
                    out_dtypes={"out": adt})

    def proj_fn(x, attn, wo):
        tadt = getattr(torch, adt)
        out = torch.matmul(attn.reshape(-1, 1, H * dh), wo.to(tadt))
        return {"x": (x[:, None, :] + out.to(x.dtype))[:, 0]}

    return _tasklet(p, f"proj{li}",
                    {"x": x, "attn": attn, "wo": w("attn", "wo")},
                    {"x": ((B, D), adt)}, proj_fn)["x"]


def _ffn_layer(p, cfg, li, spec, x, w, B, D):
    adt = cfg.activation_dtype
    is_moe = spec.is_moe
    keys = sorted(k for k in p.sdfg.arrays
                  if k.startswith(f"L{li}__ffn__"))
    short = [k.split("__", 2)[2] for k in keys]

    def ffn_fn(x, **pw):
        y, _ = blocks.ffn_apply(cfg, pw, x[:, None, :], is_moe)
        return {"x": y[:, 0]}

    ins = {"x": x}
    ins.update({s: w("ffn", s) for s in short})
    return _tasklet(p, f"ffn{li}", ins, {"x": ((B, D), adt)}, ffn_fn)["x"]


def _recurrent_layer(p, cfg, li, kind, apply_fn, x, w, sth, sspecs, B, D):
    """RWKV / Mamba layer: one whole-array tasklet running ``apply_fn``
    (``blocks.rwkv_apply`` or ``blocks.mamba_apply``) on the step's token,
    reading and writing its per-slot state rows ``st{li}__*`` in place (as
    the KV-write tasklets write the pages).

    Rows are independent under both blocks (per-position norms, products
    over feature dims only), so padding lanes evolve garbage state in
    their own rows without touching live slots.
    """
    adt = cfg.activation_dtype
    skeys = [name for name, (sli, _, _) in sspecs.items() if sli == li]
    short = {name: name.split("__", 1)[1] for name in skeys}
    pkeys = sorted(k for k in p.sdfg.arrays
                   if k.startswith(f"L{li}__{kind}__"))
    pshort = [k.split("__", 2)[2] for k in pkeys]
    cache_keys = sorted(short.values())

    def rec_fn(x, **kw):
        cache = {ck: kw.pop(ck) for ck in cache_keys}
        y, nc = apply_fn(cfg, kw, x[:, None, :], cache=cache)
        out = {"x": y[:, 0]}
        for ck in cache_keys:
            # in place: the step owns (or, not donating, was handed copies
            # of) the state rows
            cache[ck].copy_(nc[ck])
            out[f"{ck}_out"] = cache[ck]
        return out

    ins = {"x": x}
    ins.update({s: w(kind, s) for s in pshort})
    ins.update({short[name]: sth[name] for name in skeys})
    outs = {"x": ((B, D), adt)}
    outs.update({f"{short[name]}_out": sth[name] for name in skeys})
    return _tasklet(p, f"{kind}{li}", ins, outs, rec_fn)["x"]


# ---------------------------------------------------------------------------
# Pipelines + bucketed compile wrapper
# ---------------------------------------------------------------------------
def decode_pipeline(dtype_aware_sublanes: bool = False, n_shards: int = 1,
                    expansion_level: Optional[str] = None) -> PassManager:
    """The serving lowering pipeline: ``default_pipeline("cuda")``. With
    ``dtype_aware_sublanes`` the second-minor tile is MapTiling's per-scope
    dtype-aware row count (fp32 -> 16 rows, bf16 -> 32) whatever a
    calibrated tile table says — the port's default does the same while
    ``GridConversionPass.CALIBRATED_TILES`` is empty. ``expansion_level``
    forces a PagedAttnDecode level (``"flash"``: the hand-written kernel).
    ``n_shards > 1`` (sharded serving, ROADMAP step 10c) raises."""
    _no_shards(n_shards)
    if not dtype_aware_sublanes:
        return default_pipeline("cuda", expansion_level=expansion_level)
    tiles = GridConversionPass.default_tiles("cuda")
    return PassManager([
        SetExpansionPreferencePass(("cuda", "torch", "generic")),
        PipelineFusionPass(),
        ExpandLibraryNodesPass(level=expansion_level),
        MapFusionPass(),
        VectorizationPass(),
        MapTilingPass(tile_size=tiles.get("minor"), second_size=None),
        GridConversionPass(),
    ], name="cuda_serve_dtype")


class CompiledDecodeStep:
    """One (B, ctx) bucket: the compiled step called with the arguments in
    ``Compiled.argument_names()`` order.

    ``donate=True`` hands the step the live page and state arrays, which
    its KV writes and recurrent tasklets update in place (the reference's
    buffer donation).
    ``donate=False`` (the fault-tolerant mode) hands it copies, so a
    failed step can be re-run from the same inputs. ``rung`` names the
    degradation-ladder level this step was compiled at (``"grid"`` for the
    cuda pipeline, ``"jit"`` for the torch interpreter fallback).
    With ``graphs`` (a :class:`~.graphs.StepGraphs`, the grid rung on the
    card) the first call runs eagerly and captures the step; every later
    call replays it (:mod:`.graphs`, the reference's ``jax.jit`` of the
    bucket). ``captured`` is None until then.
    """

    def __init__(self, compiled, donate_names, donate: bool = True,
                 rung: str = "grid", graphs: Optional[StepGraphs] = None):
        self.compiled = compiled
        self.report = compiled.report
        self.donate = donate
        self.rung = rung
        self.graphs = graphs
        self.captured: Optional[CapturedStep] = None
        self.arg_names, self.output_names = classify_arguments(compiled.sdfg)
        self.donate_names = set(donate_names) & set(self.arg_names)

    def eager(self, args: Dict[str, torch.Tensor]) -> Dict:
        """The step run op by op, as on the CPU."""
        if not self.donate:
            args = dict(args)
            for n in self.donate_names:
                args[n] = args[n].clone()
        return self.compiled.fn(**args)

    def __call__(self, kwargs: Dict[str, torch.Tensor]) -> Dict:
        args = {n: kwargs[n] for n in self.arg_names}
        if self.graphs is None:
            return self.eager(args)
        if self.captured is None:
            out = self.graphs.warm(self.eager, args)
            self.captured = CapturedStep(
                self.graphs, lambda a: self.compiled.fn(**a), args,
                self.donate_names, self.donate)
            return out
        return self.captured(args)


class DecodeStepCompiler:
    """Shape-bucketed compiles of the serving decode step.

    Owns the flattened weights and hands back a :class:`CompiledDecodeStep`
    per (B, ctx) bucket. Lowered SDFGs are served by the (shared, LRU)
    ``CompilationCache``: identical buckets — across scheduler restarts or
    separate compiler instances sharing a cache — hit without re-lowering.

    Graceful degradation: a bucket whose grid compile raises is served by
    the torch-interpreter fallback (same SDFG, ``backend="torch"`` — token
    for token the same step) instead of killing the server — on the CPU,
    and on the card only for a planted fault (:func:`~.faults.degrades`):
    there a real compile error raises. Every
    degradation is a typed entry in ``events`` (``compile_fallback`` /
    ``compile_retry_failed`` / ``compile_recovered``), and subsequent
    hits on the bucket retry the grid compile with capped exponential
    backoff (1, 2, 4, ... ``max_compile_backoff`` bucket hits between
    attempts). ``compile_fault`` is the injection seam: a callable
    ``(B, ctx) -> None`` invoked before each grid compile (the
    fault-injection harness installs one that raises). ``device`` is
    ``cuda`` unless given; ``expansion_level`` forces a PagedAttnDecode
    level in the grid rung (``"flash"``: the hand-written kernel).
    On a CUDA device each grid-rung bucket's step is captured as CUDA
    graphs on first use (:mod:`.graphs`); the CPU has no graphs and runs
    every step op by op (``CompiledDecodeStep.eager`` runs one step op by
    op on the card).
    """

    def __init__(self, model, params, *, page_size: int, n_pages: int,
                 cache_dtype="bfloat16", dtype_aware_sublanes: bool = False,
                 cache: Optional[CompilationCache] = None,
                 donate: bool = True, max_compile_backoff: int = 32,
                 n_shards: int = 1, device=None,
                 expansion_level: Optional[str] = None):
        _no_shards(n_shards)
        on_card = torch.device(
            "cuda" if device is None else device).type == "cuda"
        #: shared by the captured buckets; raises where there is no card
        self.graphs = StepGraphs(device or "cuda") if on_card else None
        self.model = model
        self.page_size = page_size
        self.n_pages = n_pages
        self.cache_dtype = dtype_name(cache_dtype)
        self.dtype_aware_sublanes = dtype_aware_sublanes
        self.cache = COMPILATION_CACHE if cache is None else cache
        self.donate = donate
        self.max_compile_backoff = max_compile_backoff
        self.n_shards = 1
        self.device = device
        self.expansion_level = expansion_level
        self.compile_fault = None  # optional fn(B, ctx) raising to inject
        self.events: List[dict] = []
        self.flat_weights = flatten_params(model, params)
        self._wspecs = {n: (tuple(int(s) for s in a.shape),
                            dtype_name(a.dtype))
                        for n, a in self.flat_weights.items()}
        self._steps: Dict[Tuple[int, int], CompiledDecodeStep] = {}
        self._fallbacks: Dict[Tuple[int, int], CompiledDecodeStep] = {}
        #: per-bucket grid-compile failure state for the backoff retry
        self._fail: Dict[Tuple[int, int], dict] = {}
        self._donate = ({f"kp{li}" for li in attention_layer_shapes(model)} |
                        {f"vp{li}" for li in attention_layer_shapes(model)} |
                        set(state_specs(model)))

    def _lowered(self, B: int, ctx: int):
        low = serving_decode_step.lower(
            model=self.model, wspecs=self._wspecs, B=B, ctx=ctx,
            page_size=self.page_size, n_pages=self.n_pages,
            cache_dtype=self.cache_dtype)
        # the donation intent, on the SDFG, as the reference records it
        # for its static verifier (DON001/DON002)
        low.sdfg.metadata["donated"] = sorted(self._donate)
        return low

    def _compile_grid(self, B: int, ctx: int) -> CompiledDecodeStep:
        if self.compile_fault is not None:
            self.compile_fault(B, ctx)
        compiled = self._lowered(B, ctx).compile(
            backend="cuda", cache=self.cache, device=self.device,
            pipeline=decode_pipeline(self.dtype_aware_sublanes,
                                     expansion_level=self.expansion_level))
        return CompiledDecodeStep(compiled, self._donate,
                                  donate=self.donate, rung="grid",
                                  graphs=self.graphs)

    def _compile_jit(self, B: int, ctx: int,
                     donate: bool) -> CompiledDecodeStep:
        compiled = self._lowered(B, ctx).compile(
            backend="torch", cache=self.cache, device=self.device,
            pipeline=default_pipeline("torch"))
        return CompiledDecodeStep(compiled, self._donate, donate=donate,
                                  rung="jit")

    def fallback_for(self, B: int, ctx: int) -> CompiledDecodeStep:
        """The interpreter rung for a bucket, never donating — a failed
        grid step is re-run through it from the still-live inputs."""
        fb = self._fallbacks.get((B, ctx))
        if fb is None:
            fb = self._compile_jit(B, ctx, donate=False)
            self._fallbacks[(B, ctx)] = fb
        return fb

    def step_for(self, B: int, ctx: int) -> CompiledDecodeStep:
        if ctx % self.page_size:
            raise ValueError(f"ctx bucket {ctx} not a multiple of the "
                             f"page size {self.page_size}")
        key = (B, ctx)
        step = self._steps.get(key)
        fail = self._fail.get(key)
        if step is not None and fail is not None:
            # degraded bucket: retry the grid compile with capped backoff
            fail["hits_since"] += 1
            if fail["hits_since"] >= fail["backoff"]:
                try:
                    step = self._compile_grid(B, ctx)
                    self._steps[key] = step
                    self.events.append({
                        "kind": "compile_recovered", "bucket": key,
                        "after_failures": fail["failures"]})
                    del self._fail[key]
                except Exception as e:  # noqa: BLE001 - stays degraded
                    if not degrades(e, self.device or "cuda"):
                        raise
                    fail["failures"] += 1
                    fail["hits_since"] = 0
                    fail["backoff"] = min(fail["backoff"] * 2,
                                          self.max_compile_backoff)
                    self.events.append({
                        "kind": "compile_retry_failed", "bucket": key,
                        "error": repr(e),
                        "next_retry_after": fail["backoff"]})
            return self._steps[key]
        if step is None:
            try:
                step = self._compile_grid(B, ctx)
            except Exception as e:  # noqa: BLE001 - degrade, don't die
                if not degrades(e, self.device or "cuda"):
                    raise
                self.events.append({"kind": "compile_fallback",
                                    "bucket": key, "error": repr(e),
                                    "rung": "jit"})
                self._fail[key] = {"failures": 1, "hits_since": 0,
                                   "backoff": 1}
                step = self._compile_jit(B, ctx, donate=self.donate)
            self._steps[key] = step
        return step
