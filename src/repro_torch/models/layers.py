"""Composable model layers for the dense path, in PyTorch.

The counterparts of the reference package's ``repro/models/layers.py``
for the families this package runs (dense, GQA, RoPE, sliding window):
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
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
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
    loop over K/V in bk-chunks with a running (max, sum, acc) in float32."""
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
