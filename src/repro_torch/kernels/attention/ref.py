"""The plain PyTorch versions of the attention kernels.

``decode_attention``: fp32 scores scaled by 1/sqrt(Dh), the causal (and
sliding-window) mask over absolute context positions with masked scores at
-1e30, softmax, then p @ V, the output in q's dtype — what the reference's
``repro/kernels/attention/decode.py::decode_attention`` computes.

``flash_attention``: the prefill forward pass as the online-softmax loop
over KV chunks (the reference's ``layers.attention_chunked``), with the
same -1e30 masking as the reference's flash kernel.

``flash_attention_bwd``: its gradient, FlashAttention-2's backward written
out chunk by chunk (no autograd): P recomputed from the saved row
log-sum-exp, D = rowsum(dO o O), dV = P^T dO, dP = dO V^T, dS = P o (dP -
D), dQ = dS K / sqrt(Dh), dK = dS^T Q / sqrt(Dh), a KV head's dK and dV
summed over its query heads."""
import math

import torch

NEG_INF = -1e30


def decode_attention(q, k, v, pos, window=None):
    """q (B, H, Dh); k, v (B, C, H, Dh); pos (B,) -> (B, H, Dh)."""
    c, dh = k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bhd,bchd->bhc", q.float(), k.float()) * scale
    j = torch.arange(c, device=q.device)[None, None, :]
    p = torch.as_tensor(pos, device=q.device).long()[:, None, None]
    mask = j <= p
    if window is not None:
        mask &= j > p - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    prob = torch.softmax(s, dim=-1)
    return torch.einsum("bhc,bchd->bhd", prob, v.float()).to(q.dtype)


def gqa_repeat(k, n_rep: int):
    """(B, S, Hkv, Dh) -> (B, S, Hkv n_rep, Dh): q head h reads KV head
    h // n_rep."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def admitted_rows(sq, sk, causal, window, q_offset, device=None):
    """(B-independent) bool (Sq,): whether query row r, at position
    ``q_offset + r``, admits at least one key. A row that admits none
    scores -1e30 everywhere: its softmax is the mean over all Sk keys and
    its scores get no gradient."""
    p = q_offset + torch.arange(sq, device=device)
    lo = torch.clamp(p - window + 1, min=0) if window is not None \
        else torch.zeros_like(p)
    hi = torch.clamp(p, max=sk - 1) if causal else torch.full_like(p, sk - 1)
    return lo <= hi


def _chunk_mask(sq, k0, bk, causal, window, q_offset, device):
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = k0 + torch.arange(bk, device=device)
    mask = torch.ones((sq, bk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def _compute_dtype(x):
    """float64 for float64 operands (a reference of the kernels' result),
    float32 for the types the kernels take."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _divisor_chunk(bk, sk):
    bk = min(bk, sk)
    while sk % bk:
        bk -= 1
    return bk


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    bk: int = 1024, return_lse: bool = False):
    """The plain version of the prefill flash-attention kernel: online-
    softmax attention with K/V streamed in bk-chunks (bk shrunk to a divisor
    of Sk) and a running (max, sum, acc) in float32, so the (Sq, Sk) score
    matrix never materializes; masked scores are -1e30, so a row that
    admits no key gets the mean of V. q (B, Sq, Hq, Dh); k, v
    (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh) in q's dtype (computed in float32,
    in float64 for float64 operands), and with
    ``return_lse`` also each row's log-sum-exp m + log(l),
    (B, Hq, Sq), which the backward reads (-1e30 + log Sk, i.e. -1e30, for
    a row that admits no key)."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    k = gqa_repeat(k, n_rep)
    v = gqa_repeat(v, n_rep)
    scale = 1.0 / math.sqrt(dh)
    bk = _divisor_chunk(bk, sk)
    f = _compute_dtype(q)
    q32 = q.to(f) * scale
    m = torch.full((b, hq, sq), NEG_INF, dtype=f, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=f, device=q.device)
    acc = torch.zeros((b, hq, sq, dh), dtype=f, device=q.device)
    for ci in range(sk // bk):
        ks = k[:, ci * bk:(ci + 1) * bk].to(f)
        vs = v[:, ci * bk:(ci + 1) * bk].to(f)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, ks)
        mask = _chunk_mask(sq, ci * bk, bk, causal, window, q_offset,
                           q.device)
        s = torch.where(mask[None, None], s,
                        torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vs)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                        window=None, q_offset=0, bk: int = 1024):
    """The gradient of :func:`flash_attention` from its saved output and
    row log-sum-exp: q, out, dout (B, Sq, Hq, Dh); k, v (B, Sk, Hkv, Dh);
    lse (B, Hq, Sq) float32 -> (dq, dk, dv) in q's, k's and v's dtypes,
    computed in float32 (float64 for float64 operands) over K/V chunks of
    bk keys. Masked scores get no
    gradient; a row that admits no key has P = 1 / Sk over every key and
    no dS, as autograd through the forward gives."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    bk = _divisor_chunk(bk, sk)
    f = _compute_dtype(q)
    q32 = q.to(f) * scale
    do = dout.to(f)
    lse = lse.to(f)
    d_row = torch.einsum("bqhd,bqhd->bhq", do, out.to(f))
    some = admitted_rows(sq, sk, causal, window, q_offset, q.device)
    k_rep = gqa_repeat(k, n_rep)
    v_rep = gqa_repeat(v, n_rep)
    dq = torch.zeros((b, sq, hq, dh), dtype=f, device=q.device)
    dk = torch.zeros((b, sk, hq, dh), dtype=f, device=q.device)
    dv = torch.zeros((b, sk, hq, dh), dtype=f, device=q.device)
    for ci in range(sk // bk):
        sl = slice(ci * bk, (ci + 1) * bk)
        ks, vs = k_rep[:, sl].to(f), v_rep[:, sl].to(f)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, ks)
        mask = _chunk_mask(sq, ci * bk, bk, causal, window, q_offset,
                           q.device) & some[:, None]
        p = torch.where(mask[None, None], torch.exp(s - lse[..., None]),
                        torch.zeros((), device=q.device))
        p = torch.where(some[None, None, :, None], p,
                        torch.full((), 1.0 / sk, dtype=f, device=q.device))
        dv[:, sl] = torch.einsum("bhqk,bqhd->bkhd", p, do)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, vs)
        ds = torch.where(mask[None, None], p * (dp - d_row[..., None]),
                         torch.zeros((), device=q.device))
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, ks)
        dk[:, sl] = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    dq = dq * scale
    # a KV head's gradient: the sum over its n_rep query heads, in order
    dk = dk.reshape(b, sk, hkv, n_rep, dh).sum(3)
    dv = dv.reshape(b, sk, hkv, n_rep, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
