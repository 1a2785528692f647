"""Composable model layers for the dense and MoE paths, in PyTorch.

The counterparts of the reference package's ``repro/models/layers.py``
for the families this package runs (dense, GQA, RoPE, sliding window,
GShard-style mixture of experts):
the same math in the same dtypes — norms and softmax in float32, products
in the activation dtype — so a model carried across by
``models.transformer.lm_params_from_reference`` computes the reference's
function. The reference's sharding constraints (``psc``) have no
counterpart: the port runs on one card.

``attention`` selects the implementation like the reference's dual-path
selector: ``"torch"`` (the reference's ``"xla"``) is the einsum
formulation; ``"cuda"`` (the reference's ``"pallas"``) reaches the
prefill flash-attention kernel, as ``attention_chunked`` (the model's
``attention_impl="chunked"``) does on CUDA tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.attention import flash_attention, flash_attention_ref
from ..kernels.attention.ref import gqa_repeat

#: masked attention scores, as the reference writes them: a padded context
#: softmaxes to exactly 0
NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    d = xf - mu
    var = torch.mean(d * d, dim=-1, keepdim=True)
    out = d * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)             # (Dh/2,)
    positions = torch.as_tensor(positions, device=x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)         # (..., S, 1, Dh/2)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, optional sliding window)
# ---------------------------------------------------------------------------
def _mask(sq, sk, causal, window, q_offset, device):
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention_xla(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, q_offset=0):
    """q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh). The einsum formulation
    (the reference's name); supports decode (Sq = 1 against a cache) via
    ``q_offset``."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    k = gqa_repeat(k, n_rep)
    v = gqa_repeat(v, n_rep)
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset=0,
                      bk: int = 1024):
    """Online-softmax chunked attention, the (Sq, Sk) score matrix never
    materialized: on CUDA tensors the hand-written flash-attention kernel
    (which picks its own tiles), on CPU tensors its plain version, the
    loop over K/V in bk-chunks with a running (max, sum, acc) in float32.
    Differentiable: on CUDA tensors its gradient is the flash backward
    kernel, on CPU tensors autograd through the plain version."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, bk=bk)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def attention(q, k, v, *, causal=True, window=None, q_offset=0,
              impl: str = "torch"):
    """``impl="torch"`` is the einsum formulation (the reference's
    ``"xla"``); ``impl="cuda"`` is the reference's ``"pallas"``: the
    prefill flash-attention kernel (its plain version on CPU tensors).
    Unlike the reference's ``"pallas"`` path, it keeps ``q_offset``."""
    if impl == "torch" or q.shape[1] == 1:
        return attention_xla(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if impl == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    raise ValueError(impl)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------
def swiglu(x, w_gate, w_up, w_down):
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    h = torch.matmul(x, w_in) + b_in
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, w_out) + b_out


# ---------------------------------------------------------------------------
# Mixture of Experts: GShard-style capacity-based dispatch (static shapes).
# Top-k routing with an optional shared expert.
# ---------------------------------------------------------------------------
def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot(idx, n, dtype=dtype)``: a comparison with an
    ``arange``, so no value of ``idx`` is read on the host (an index
    outside [0, n) gives a zero row, as in the reference)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values lower index first. ``torch.topk``
    promises no order among equal values on CUDA; a stable sort keeps
    equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(n_tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float, drop_tokens: bool) -> int:
    """Slots an expert's buffer holds: ``max(ceil(k T cf / E), 4)`` when
    tokens may drop, else T (no (token, expert) pair can overflow)."""
    if not drop_tokens:
        return n_tokens
    return max(int(np.ceil(top_k * n_tokens * capacity_factor / n_experts)),
               4)


def moe_block(x, router_w, w_gate, w_up, w_down, *, top_k: int,
              capacity_factor: float = 1.25,
              shared: Optional[dict] = None, dispatch: str = "onehot",
              drop_tokens: bool = True):
    """x: (B, S, D); router_w: (D, E); expert weights stacked (E, D, F) /
    (E, F, D). Returns (out, aux_loss), as the reference's ``moe_block``.

    ``dispatch="onehot"`` is the GShard formulation (one-hot einsums,
    O(T^2) dispatch work); ``"sort"`` scatters tokens into the expert
    buffers and gathers them back (:func:`_moe_apply_scatter`).
    ``drop_tokens=False`` is eval mode: capacity = T, so decode matches
    the forward token for token. The capacity comes from the static
    shapes only, and nothing reads a device value on the host, so the
    block runs inside a captured CUDA graph. The one-hot products multiply
    every token by 0, and 0 x NaN is NaN: a non-finite row reaches every
    row, as in the reference."""
    b, s, d = x.shape
    e = router_w.shape[1]
    n_tokens = b * s
    xt = x.reshape(n_tokens, d)
    logits = torch.matmul(xt.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, experts_idx = _top_k(probs, top_k)            # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    capacity = moe_capacity(n_tokens, top_k, e, capacity_factor, drop_tokens)

    # position of each (token, k) pair within its expert's buffer
    onehot = _one_hot(experts_idx, e, torch.int32)              # (T, k, E)
    flat = onehot.reshape(n_tokens * top_k, e)
    pos_in_expert = torch.cumsum(flat, dim=0) * flat - 1        # (T*k, E)
    pos = pos_in_expert.amax(-1).reshape(n_tokens, top_k)
    keep = pos < capacity
    gate_vals = gate_vals * keep

    me = probs.mean(0)
    ce = _one_hot(experts_idx[:, 0], e, torch.float32).mean(0)
    aux = e * torch.sum(me * ce)        # load balancing (Switch-style)

    if dispatch == "sort":
        out = _moe_apply_scatter(xt, experts_idx, pos, keep, gate_vals,
                                 w_gate, w_up, w_down, e, capacity, d)
    else:
        # dispatch and combine tensors over (E, T, C): 0/1 products, exact
        # in any dtype; at most one k of a token names an expert, so the
        # gates folded into the one-hot before the sum over k are the
        # reference's three-operand einsum. The dispatch tensor and the
        # expert inputs are temporaries, freed once used.
        pos_oh = _one_hot(torch.where(keep, pos, capacity), capacity,
                          xt.dtype)                              # (T, k, C)
        oh = onehot.to(xt.dtype)
        expert_out = _experts(                                   # (E, C, D)
            torch.matmul(torch.einsum("tke,tkc->ect", oh, pos_oh), xt),
            w_gate, w_up, w_down)
        combine = torch.einsum("tke,tkc->etc",
                               oh * gate_vals.to(xt.dtype)[..., None],
                               pos_oh)
        out = torch.einsum("etc,ecd->td", combine, expert_out)
    if shared is not None:
        out = out + swiglu(xt[None], shared["w_gate"], shared["w_up"],
                           shared["w_down"])[0]
    return out.reshape(b, s, d), aux


def _experts(expert_in, w_gate, w_up, w_down):
    """The experts' SwiGLU FFNs over their (E, C, D) inputs, silu in
    float32 and back to the inputs' dtype, as the reference's. Each buffer
    is freed once used (the inputs too, when the caller holds no other
    reference) and the gate product is taken in place on silu's fresh
    output, the same values: at eval capacity C = T each is GBs at full
    width."""
    g = torch.matmul(expert_in, w_gate)
    u = torch.matmul(expert_in, w_up)
    del expert_in
    h = F.silu(g.float()).to(u.dtype)
    del g
    h.mul_(u)
    del u
    return torch.matmul(h, w_down)


def _moe_apply_scatter(xt, experts_idx, pos, keep, gate_vals,
                       w_gate, w_up, w_down, e, capacity, d):
    """Scatter/gather MoE dispatch: tokens copy into (E C, D) expert
    buffers by (expert, slot) index and the outputs gather back. Slots are
    unique by construction (pos is a per-expert running count); every
    dropped pair lands on one sink row past the buffers, never read."""
    n_tokens, top_k = experts_idx.shape
    slot = experts_idx * capacity + pos                          # (T, k)
    slot = torch.where(keep, slot, torch.full((), e * capacity,
                                              dtype=slot.dtype,
                                              device=slot.device))
    flat_slot = slot.reshape(-1)
    src = xt[:, None, :].expand(n_tokens, top_k, d).reshape(
        n_tokens * top_k, d)
    buf = torch.zeros((e * capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf.index_copy_(0, flat_slot, src)
    expert_out = _experts(buf[:-1].reshape(e, capacity, d), w_gate, w_up,
                          w_down)
    flat_out = torch.cat([expert_out.reshape(e * capacity, d),
                          torch.zeros((1, d), dtype=xt.dtype,
                                      device=xt.device)], dim=0)
    gathered = flat_out[flat_slot].reshape(n_tokens, top_k, d)
    return torch.sum(gathered * gate_vals[..., None].to(xt.dtype), dim=1)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, scale=None,
               dtype=torch.float32, device=None):
    """Normal weights scaled by 1/sqrt(fan_in) (or ``scale``), drawn from
    ``generator`` on its device. The draws differ from the reference's
    ``jax.random`` ones; tests carry the reference's weights across."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    device = generator.device if device is None else device
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)
