"""The plain PyTorch versions of the attention kernels.

``decode_attention``: fp32 scores scaled by 1/sqrt(Dh), the causal (and
sliding-window) mask over absolute context positions with masked scores at
-1e30, softmax, then p @ V, the output in q's dtype — what the reference's
``repro/kernels/attention/decode.py::decode_attention`` computes.

``flash_attention``: the prefill forward pass as the online-softmax loop
over KV chunks (the reference's ``layers.attention_chunked``), with the
same -1e30 masking as the reference's flash kernel."""
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


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    bk: int = 1024):
    """The plain version of the prefill flash-attention kernel: online-
    softmax attention with K/V streamed in bk-chunks (bk shrunk to a divisor
    of Sk) and a running (max, sum, acc) in float32, so the (Sq, Sk) score
    matrix never materializes; masked scores are -1e30, so a row that
    admits no key gets the mean of V. q (B, Sq, Hq, Dh); k, v
    (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh) in q's dtype."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    k = gqa_repeat(k, n_rep)
    v = gqa_repeat(v, n_rep)
    scale = 1.0 / math.sqrt(dh)
    bk = min(bk, sk)
    while sk % bk:
        bk -= 1
    q32 = q.float() * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, dh), dtype=torch.float32, device=q.device)
    for ci in range(sk // bk):
        ks = k[:, ci * bk:(ci + 1) * bk].float()
        vs = v[:, ci * bk:(ci + 1) * bk].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, ks)
        k_pos = ci * bk + torch.arange(bk, device=q.device)
        mask = torch.ones((sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask[None, None], s,
                        torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vs)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
