"""Layer blocks: attention (GQA + RoPE + optional sliding window), the
Mamba selective-SSM block, the dense and MoE FFNs and the RWKV6 (Finch)
time-mix + channel-mix block, as (init, apply) pairs over explicit
parameter dicts with optional decode-cache threading — the counterparts
of the reference's ``repro/models/blocks.py``.

The Mamba block is plain PyTorch, as the reference's is jnp with no
kernel of its own.
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
                     dense_init, gelu_mlp, layer_norm, moe_block, rms_norm,
                     swiglu)


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
# Mamba selective-SSM block (Jamba's recurrent layer)
# ---------------------------------------------------------------------------
def mamba_init(cfg: ModelConfig, generator: torch.Generator,
               device=None) -> Dict:
    d = cfg.d_model
    d_in = cfg.expand * d
    n = cfg.d_state
    dt = _dtype(cfg.param_dtype)
    device = generator.device if device is None else device

    def init(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dt,
                          device=device)

    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    p = {
        "w_in": init((d, 2 * d_in)),
        "conv_w": init((cfg.d_conv, d_in), 0.5),
        "w_bcdt": init((d_in, 2 * n + 1)),
        "dt_bias": torch.full((d_in,), -4.6, dtype=dt,
                              device=device),  # softplus^-1(0.01)
        "A_log": torch.log(a.expand(d_in, n).contiguous()).to(dt),
        "D": torch.ones((d_in,), dtype=dt, device=device),
        "w_out": init((d_in, d), 1.0 / math.sqrt(d_in * 2 * cfg.n_layers)),
    }
    p.update(_with_prefix(_norm_init(cfg, d, device), "ln"))
    return p


#: mamba chunk length; per-step log-decay is clamped to >= -5 so the
#: exp(cumsum) within a chunk stays in fp32 range (5 * 16 = 80 < 88)
SSM_CHUNK = 16


def _ssm_scan_ref(u, ldA, dBu, C, state0):
    """The selective scan step by step over time (the reference scans
    associatively; PyTorch has no such primitive): h_t = exp(ldA_t) h_{t-1}
    + dBu_t, y_t = h_t . C_t, with ``state0`` folded into step 0. Returns
    (y (B, S, Din), the last state (B, Din, N)). Used where a length is
    not a multiple of SSM_CHUNK."""
    dA = torch.exp(ldA)                                  # (B, S, Din, N)
    first = dBu[:, 0]
    if state0 is not None:
        first = first + dA[:, 0] * state0
    state, ys = first, []
    for t in range(ldA.shape[1]):
        if t:
            state = dA[:, t] * state + dBu[:, t]
        ys.append(torch.einsum("bdn,bn->bd", state, C[:, t]))
    return torch.stack(ys, dim=1), state


def _ssm_scan_chunked(u, ldA, dBu, C, state0, chunk: int = SSM_CHUNK):
    """The chunked selective scan: one (B, chunk, Din, N) slab of states
    at a time, the (B, Din, N) state carried from chunk to chunk. Within a
    chunk, with la the cumulative log decay, the states are
    exp(la) (state + cumsum(exp(-la) dBu)); exp(+-la) stays in fp32 range
    thanks to the per-step clamp on ldA."""
    S = u.shape[1]
    state, ys = state0, []
    for c0 in range(0, S, chunk):
        ldA_c, dBu_c = ldA[:, c0:c0 + chunk], dBu[:, c0:c0 + chunk]
        la = torch.cumsum(ldA_c, dim=1)
        prefix = torch.cumsum(torch.exp(-la) * dBu_c, dim=1)
        states = torch.exp(la) * (state[:, None] + prefix)
        ys.append(torch.einsum("bcdn,bcn->bcd", states,
                               C[:, c0:c0 + chunk]))
        state = states[:, -1]
    return torch.cat(ys, dim=1), state


def mamba_apply(cfg: ModelConfig, p: Dict, x, *, cache: Optional[Dict] = None):
    """x (B, S, D) -> (x + Mamba(norm(x)), new cache). cache: {'conv'
    (B, d_conv - 1, Din), the last inputs of the causal conv; 'ssm'
    (B, Din, N), the state after the previous position}; without one the
    sequence starts from zeros."""
    b, s, d = x.shape
    d_in = cfg.expand * d
    n = cfg.d_state
    adt = _dtype(cfg.activation_dtype)
    f32 = torch.float32
    h = _norm(cfg, x, p, "ln").to(adt)
    xz = torch.matmul(h, p["w_in"].to(adt))
    u, z = xz[..., :d_in], xz[..., d_in:]

    # depthwise causal conv over time
    conv_w = p["conv_w"].to(f32)
    K = cfg.d_conv
    if cache is not None:
        prev = cache["conv"]                          # (B, K-1, Din)
        u_ext = torch.cat([prev.to(adt), u], dim=1)
        new_conv = u_ext[:, -(K - 1):].to(cache["conv"].dtype)
    else:
        u_ext = torch.cat([torch.zeros((b, K - 1, d_in), dtype=adt,
                                       device=x.device), u], dim=1)
        new_conv = None
    uf = u_ext.to(f32)
    conv = sum(uf[:, i:i + s] * conv_w[i] for i in range(K))
    u = F.silu(conv)

    bcdt = torch.matmul(u.to(adt), p["w_bcdt"].to(adt)).to(f32)
    B_, C_, dt_ = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., 2 * n:]
    dt_ = F.softplus(dt_ + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    # per-step log decay, clamped for the chunked scan's fp32 range
    ldA = torch.clamp(dt_[..., None] * A, -5.0, 0.0)     # (B, S, Din, N)
    dBu = dt_[..., None] * B_[:, :, None, :] * u[..., None]
    state0 = cache["ssm"].to(f32) if cache is not None else \
        torch.zeros((b, d_in, n), dtype=f32, device=x.device)
    if s == 1:
        last_state = torch.exp(ldA[:, 0]) * state0 + dBu[:, 0]
        y = torch.einsum("bdn,bn->bd", last_state, C_[:, 0])[:, None]
    elif s % SSM_CHUNK == 0:
        y, last_state = _ssm_scan_chunked(u, ldA, dBu, C_, state0)
    else:
        y, last_state = _ssm_scan_ref(u, ldA, dBu, C_, state0)
    del ldA, dBu
    y = y + p["D"].to(f32) * u
    y = y.to(adt) * F.silu(z.to(f32)).to(adt)
    out = torch.matmul(y, p["w_out"].to(adt))
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv,
                     "ssm": last_state.to(cache["ssm"].dtype)}
    return x + out.to(x.dtype), new_cache


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    d_in = cfg.expand * cfg.d_model
    dt = _dtype(dtype)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_in), dtype=dt,
                            device=device),
        "ssm": torch.zeros((batch, d_in, cfg.d_state), dtype=dt,
                           device=device),
    }


# ---------------------------------------------------------------------------
# FFN / MoE sublayer
# ---------------------------------------------------------------------------
def ffn_init(cfg: ModelConfig, generator: torch.Generator, is_moe: bool,
             device=None) -> Dict:
    d = cfg.d_model
    dt = _dtype(cfg.param_dtype)
    device = generator.device if device is None else device
    f = cfg.moe.d_ff_expert if is_moe else cfg.d_ff
    down = 1.0 / math.sqrt(f * 2 * cfg.n_layers)
    p: Dict = {}

    def init(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dt,
                          device=device)

    if is_moe:
        m = cfg.moe
        e = m.n_experts
        # (E, D, F) leaves take fan_in = E, as the reference's dense_init
        p["router"] = init((d, e))
        p["moe_gate"] = init((e, d, f))
        p["moe_up"] = init((e, d, f))
        p["moe_down"] = init((e, f, d), down)
        if m.shared_expert:
            p["sh_gate"] = init((d, f))
            p["sh_up"] = init((d, f))
            p["sh_down"] = init((f, d), down)
    elif cfg.act == "swiglu":
        p["w_gate"] = init((d, f))
        p["w_up"] = init((d, f))
        p["w_down"] = init((f, d), down)
    else:
        p["w_in"] = init((d, f))
        p["b_in"] = torch.zeros((f,), dtype=dt, device=device)
        p["w_out"] = init((f, d), down)
        p["b_out"] = torch.zeros((d,), dtype=dt, device=device)
    p.update(_with_prefix(_norm_init(cfg, d, device), "ln"))
    return p


def ffn_apply(cfg: ModelConfig, p: Dict, x, is_moe: bool,
              training: bool = False):
    """Returns (x + FFN(norm(x)), aux): aux is the MoE block's
    load-balancing loss, 0 for a dense FFN. ``training`` lets the MoE
    block drop tokens past an expert's capacity; the default is the
    forward's eval mode, which drops none, so decode matches the
    forward."""
    adt = _dtype(cfg.activation_dtype)
    h = _norm(cfg, x, p, "ln").to(adt)
    if is_moe:
        m = cfg.moe
        shared = None
        if m.shared_expert:
            shared = {"w_gate": p["sh_gate"].to(adt),
                      "w_up": p["sh_up"].to(adt),
                      "w_down": p["sh_down"].to(adt)}
        out, aux = moe_block(
            h, p["router"], p["moe_gate"].to(adt), p["moe_up"].to(adt),
            p["moe_down"].to(adt), top_k=m.top_k,
            capacity_factor=m.capacity_factor, shared=shared,
            dispatch=cfg.moe_dispatch, drop_tokens=training)
        return x + out.to(x.dtype), aux
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
    on CPU tensors (``kernels.rwkv.wkv_chunked`` decides by the device);
    differentiable, through the backward kernel (its plain version on CPU
    tensors)."""
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
