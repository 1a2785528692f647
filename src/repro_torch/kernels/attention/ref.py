"""The plain PyTorch version of the decode-attention kernel: fp32 scores
scaled by 1/sqrt(Dh), the causal (and sliding-window) mask over absolute
context positions with masked scores at -1e30, softmax, then p @ V, the
output in q's dtype — what the reference's
``repro/kernels/attention/decode.py::decode_attention`` computes."""
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
