"""Layer blocks: attention (GQA + RoPE + optional sliding window), the
dense FFN and the RWKV6 (Finch) time-mix + channel-mix block, as (init,
apply) pairs over explicit parameter dicts with optional decode-cache
threading — the counterparts of those parts of the reference's
``repro/models/blocks.py``.

The reference's other blocks (MoE FFNs, the Mamba selective SSM) are not
ported yet; asking for them raises :class:`FamilyNotPortedError`, which
names the ROADMAP item that carries them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv import wkv_chunked, wkv_ref
from ..kernels.rwkv.kernel import CHUNK
from .layers import (apply_rope, attention_chunked, attention_xla,
                     dense_init, gelu_mlp, layer_norm, rms_norm, swiglu)


class FamilyNotPortedError(NotImplementedError):
    """A block of a model family this package does not run yet."""

    def __init__(self, what: str):
        super().__init__(
            f"{what} is not ported to the torch package yet (ROADMAP queue 1 "
            f"item 7, the model zoo: MoE, Mamba, VLM and enc-dec "
            f"families)")
        self.what = what


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _norm(cfg: ModelConfig, x, p, prefix: str):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p[f"{prefix}_scale"])
    return layer_norm(x, p[f"{prefix}_scale"] + 1.0, p[f"{prefix}_bias"])


def _norm_init(cfg: ModelConfig, d: int, device) -> Dict:
    out = {"_scale": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        out["_bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return out


def _with_prefix(d: Dict, prefix: str) -> Dict:
    return {prefix + k: v for k, v in d.items()}


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------
def attn_init(cfg: ModelConfig, generator: torch.Generator,
              device=None) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    dt = _dtype(cfg.param_dtype)
    device = generator.device if device is None else device
    g = generator
    p = {
        "wq": dense_init(g, (d, cfg.n_heads * hd), dtype=dt, device=device),
        "wk": dense_init(g, (d, cfg.n_kv_heads * hd), dtype=dt,
                         device=device),
        "wv": dense_init(g, (d, cfg.n_kv_heads * hd), dtype=dt,
                         device=device),
        "wo": dense_init(g, (cfg.n_heads * hd, d),
                         scale=1.0 / math.sqrt(cfg.n_heads * hd * 2
                                               * cfg.n_layers),
                         dtype=dt, device=device),
    }
    p.update(_with_prefix(_norm_init(cfg, d, device), "ln"))
    return p


def _update_slice(cache, new, pos: int):
    """``cache`` with ``new`` written along dim 1 from ``pos`` (clamped so
    the slab fits, as ``dynamic_update_slice`` clamps), out of place."""
    s = new.shape[1]
    start = max(0, min(int(pos), cache.shape[1] - s))
    out = cache.clone()
    out[:, start:start + s] = new.to(cache.dtype)
    return out


def attn_apply(cfg: ModelConfig, p: Dict, x, *, window: Optional[int],
               cache: Optional[Dict] = None, positions=None,
               kv_override: Optional[Tuple] = None, causal: bool = True):
    """x: (B, S, D). cache: {'k','v'} (B, Smax, Hkv, Dh) + 'pos' (an int).
    kv_override: cross-attention (encoder memory)."""
    b, s, d = x.shape
    hd = cfg.head_dim
    adt = _dtype(cfg.activation_dtype)
    h = _norm(cfg, x, p, "ln").to(adt)
    q = torch.matmul(h, p["wq"].to(adt)).reshape(b, s, cfg.n_heads, hd)
    if kv_override is None:
        k = torch.matmul(h, p["wk"].to(adt)).reshape(b, s, cfg.n_kv_heads, hd)
        v = torch.matmul(h, p["wv"].to(adt)).reshape(b, s, cfg.n_kv_heads, hd)
    else:
        k, v = kv_override

    if positions is None:
        base = int(cache["pos"]) if cache is not None else 0
        positions = (base + torch.arange(s, device=x.device))[None, :]
        positions = positions.expand(b, s)
    if kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and kv_override is None:
        # decode: insert the new k/v at the position, attend over the cache
        pos = int(cache["pos"])
        ck = _update_slice(cache["k"], k, pos)
        cv = _update_slice(cache["v"], v, pos)
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
        out = attention_xla(q, ck.to(adt), cv.to(adt), causal=True,
                            window=window, q_offset=pos)
    elif cfg.attention_impl == "chunked" and s > 1:
        out = attention_chunked(q, k, v,
                                causal=causal and kv_override is None,
                                window=window)
    else:
        out = attention_xla(q, k, v, causal=causal and kv_override is None,
                            window=window)
    out = out.reshape(b, s, cfg.n_heads * hd)
    out = torch.matmul(out, p["wo"].to(adt))
    return x + out.to(x.dtype), new_cache


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> Dict:
    hd = cfg.head_dim
    shape = (batch, max_seq, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=_dtype(dtype), device=device),
            "v": torch.zeros(shape, dtype=_dtype(dtype), device=device),
            "pos": 0}


# ---------------------------------------------------------------------------
# FFN sublayer (dense)
# ---------------------------------------------------------------------------
def ffn_init(cfg: ModelConfig, generator: torch.Generator, is_moe: bool,
             device=None) -> Dict:
    if is_moe:
        raise FamilyNotPortedError("the MoE FFN block")
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    device = generator.device if device is None else device
    g = generator
    down = 1.0 / math.sqrt(f * 2 * cfg.n_layers)
    p: Dict = {}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(g, (d, f), dtype=dt, device=device)
        p["w_up"] = dense_init(g, (d, f), dtype=dt, device=device)
        p["w_down"] = dense_init(g, (f, d), scale=down, dtype=dt,
                                 device=device)
    else:
        p["w_in"] = dense_init(g, (d, f), dtype=dt, device=device)
        p["b_in"] = torch.zeros((f,), dtype=dt, device=device)
        p["w_out"] = dense_init(g, (f, d), scale=down, dtype=dt,
                                device=device)
        p["b_out"] = torch.zeros((d,), dtype=dt, device=device)
    p.update(_with_prefix(_norm_init(cfg, d, device), "ln"))
    return p


def ffn_apply(cfg: ModelConfig, p: Dict, x, is_moe: bool,
              training: bool = False):
    """Returns (x + FFN(norm(x)), aux) with aux 0 (a dense FFN has no
    load-balancing loss)."""
    if is_moe:
        raise FamilyNotPortedError("the MoE FFN block")
    adt = _dtype(cfg.activation_dtype)
    h = _norm(cfg, x, p, "ln").to(adt)
    if cfg.act == "swiglu":
        out = swiglu(h, p["w_gate"].to(adt), p["w_up"].to(adt),
                     p["w_down"].to(adt))
    else:
        out = gelu_mlp(h, p["w_in"].to(adt), p["b_in"].to(adt),
                       p["w_out"].to(adt), p["b_out"].to(adt))
    return x + out.to(x.dtype), torch.zeros((), dtype=torch.float32,
                                            device=x.device)


# ---------------------------------------------------------------------------
# RWKV6 block (Finch): data-dependent decay time-mix + channel mix
# ---------------------------------------------------------------------------
def rwkv_init(cfg: ModelConfig, generator: torch.Generator,
              device=None) -> Dict:
    d, L = cfg.d_model, cfg.n_layers
    H, hd = cfg.n_heads, cfg.head_dim
    dt = _dtype(cfg.param_dtype)
    device = generator.device if device is None else device

    def init(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dt,
                          device=device)

    p = {
        "mix_rkvwg": init((5, d), 0.1),
        "wr": init((d, d)),
        "wk": init((d, d)),
        "wv": init((d, d)),
        "wg": init((d, d)),
        "w_decay": init((d,), 1.0),
        "u_bonus": init((H, hd), 0.5),
        "wo": init((d, d), 1.0 / math.sqrt(d * 2 * L)),
        # channel mix
        "cm_wk": init((d, cfg.d_ff)),
        "cm_wv": init((cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff * 2 * L)),
        "cm_mix": init((d,), 0.1),
    }
    p.update(_with_prefix(_norm_init(cfg, d, device), "ln1"))
    p.update(_with_prefix(_norm_init(cfg, d, device), "ln2"))
    return p


#: WKV chunk length: bounded so exp(sum log w) stays in fp32 range
#: (|log w| <= 3.5 per step by construction -> 3.5 * 16 = 56 < 88)
WKV_CHUNK = CHUNK

#: the sequential WKV6 recurrence (decode steps and sequences that are not
#: a multiple of the chunk): r, k, v, w (B, S, H, hd), u (H, hd), state
#: (B, H, hd, hd) -> (out, state)
_wkv_scan = wkv_ref


def _wkv_chunked(r, k, v, w, u, state0):
    """The chunkwise WKV6 of ``_wkv_scan``, from ``state0`` (None: a zero
    state): the hand-written CUDA kernel on CUDA tensors, its plain version
    on CPU tensors (``kernels.rwkv.wkv_chunked`` decides by the device)."""
    return wkv_chunked(r, k, v, w, u, state0)


def rwkv_apply(cfg: ModelConfig, p: Dict, x, *, cache: Optional[Dict] = None):
    """x (B, S, D) -> (x + time mix + channel mix, new cache). cache:
    {'shift1', 'shift2' (B, 1, D), 'wkv' (B, H, hd, hd)}, the state after
    the previous position; without one the sequence starts from zeros."""
    b, s, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    adt = _dtype(cfg.activation_dtype)
    f32 = torch.float32

    def zeros_row():
        return torch.zeros((b, 1, d), dtype=f32, device=x.device)

    # --- time mix ---
    h = _norm(cfg, x, p, "ln1").to(f32)
    prev_tm = cache["shift1"].to(f32) if cache is not None else zeros_row()
    shifted = torch.cat([prev_tm, h[:, :-1]], dim=1)
    mix = torch.sigmoid(p["mix_rkvwg"].to(f32))  # (5, d)

    def lerp(i):
        return h + (shifted - h) * mix[i]

    r = torch.matmul(lerp(0).to(adt), p["wr"].to(adt))
    k = torch.matmul(lerp(1).to(adt), p["wk"].to(adt))
    v = torch.matmul(lerp(2).to(adt), p["wv"].to(adt))
    g = torch.matmul(lerp(4).to(adt), p["wg"].to(adt))
    # data-dependent decay (Finch), in (e^-3.5, e^-0.5)
    wdec = torch.sigmoid(lerp(3) * p["w_decay"].to(f32))
    w = torch.exp(-0.5 - 3.0 * wdec)

    rs = r.reshape(b, s, H, hd).to(f32)
    ks_ = k.reshape(b, s, H, hd).to(f32)
    vs = v.reshape(b, s, H, hd).to(f32)
    ws = w.reshape(b, s, H, hd)
    state0 = cache["wkv"].to(f32) if cache is not None else None
    ub = p["u_bonus"].to(f32)
    if s > 1 and s % WKV_CHUNK == 0:
        out, new_state = _wkv_chunked(rs, ks_, vs, ws, ub, state0)
    else:
        if state0 is None:
            state0 = torch.zeros((b, H, hd, hd), dtype=f32, device=x.device)
        out, new_state = _wkv_scan(rs, ks_, vs, ws, ub, state0)
    out = out.reshape(b, s, d)
    out = out * F.silu(g.to(f32))
    x = x + torch.matmul(out.to(adt), p["wo"].to(adt)).to(x.dtype)

    # --- channel mix ---
    h2 = _norm(cfg, x, p, "ln2").to(f32)
    prev_cm = cache["shift2"].to(f32) if cache is not None else zeros_row()
    shifted2 = torch.cat([prev_cm, h2[:, :-1]], dim=1)
    mix2 = torch.sigmoid(p["cm_mix"].to(f32))
    hk = h2 + (shifted2 - h2) * mix2
    kk = torch.matmul(hk.to(adt), p["cm_wk"].to(adt))
    kk = torch.square(torch.clamp(kk.to(f32), min=0.0)).to(adt)
    out2 = torch.matmul(kk, p["cm_wv"].to(adt))
    x = x + out2.to(x.dtype)

    new_cache = None
    if cache is not None:
        new_cache = {
            "shift1": h[:, -1:].to(cache["shift1"].dtype),
            "shift2": h2[:, -1:].to(cache["shift2"].dtype),
            "wkv": new_state.to(cache["wkv"].dtype),
        }
    return x, new_cache


def rwkv_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None) -> Dict:
    dt = _dtype(dtype)
    return {
        "shift1": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                              device=device),
        "shift2": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                              device=device),
        "wkv": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                           dtype=dt, device=device),
    }


# ---------------------------------------------------------------------------
# Blocks of the families that wait for the model-zoo slice
# ---------------------------------------------------------------------------
def mamba_init(*args, **kwargs):
    raise FamilyNotPortedError("the Mamba selective-SSM block")


def mamba_apply(*args, **kwargs):
    raise FamilyNotPortedError("the Mamba selective-SSM block")


def mamba_cache_init(*args, **kwargs):
    raise FamilyNotPortedError("the Mamba selective-SSM block")
