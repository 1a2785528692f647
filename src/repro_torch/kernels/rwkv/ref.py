"""The plain PyTorch versions of the WKV6 recurrence: the sequential scan
(the oracle, the reference's ``repro/kernels/rwkv/ref.py::wkv``) and the
chunked formulation the CUDA kernel computes (the reference's
``repro/models/blocks.py::_wkv_chunked``; with ``state0=None`` it is the
Pallas kernel ``repro/kernels/rwkv/kernel.py::wkv_chunked``, which always
starts from a zero state)."""
import torch

#: chunk length: exp(sum log w) over a chunk stays in fp32's range because
#: the model keeps log w in (-3.5, -0.5): 16 * 3.5 = 56 < 88
CHUNK = 16


def wkv(r, k, v, w, u, state0):
    """r, k, v, w (B, S, H, hd); u (H, hd); state0 (B, H, hd, hd), all in
    one dtype -> (out (B, S, H, hd), state (B, H, hd, hd)):

        out_t = r_t . (S_{t-1} + u * k_t v_t^T),
        S_t   = diag(w_t) S_{t-1} + k_t v_t^T.
    """
    state = state0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhkv,bhk->bhv",
                                 state + u[..., :, None] * kv, rt))
        state = wt[..., :, None] * state + kv
    return torch.stack(outs, dim=1), state


def wkv_chunked(r, k, v, w, u, state0=None, chunk: int = CHUNK):
    """The chunked WKV6 of ``wkv``: r, k, v, w (B, S, H, hd) in float32 or
    bfloat16 (computed in float32), u (H, hd), state0 None (zeros) or a
    float32 (B, H, hd, hd) -> (out (B, S, H, hd) in r's dtype, float32
    state (B, H, hd, hd)). S must be a multiple of ``chunk``.

    With A_t = prod_{s<=t} w_s (per key channel, within a chunk):
      out_t  = (r_t A_{t-1}) . S_chunk0
               + sum_{j<t} [(r_t A_{t-1} / A_j) . k_j] v_j
               + (r_t . (u k_t)) v_t
      S_next = diag(A_last) S_chunk0 + sum_j (A_last / A_j) k_j v_j^T
    """
    B, S, H, hd = r.shape
    if S % chunk:
        raise ValueError(f"wkv_chunked: S = {S} is not a multiple of the "
                         f"chunk {chunk}")
    N, C = S // chunk, chunk
    f32 = torch.float32
    rc, kc, vc, wc = (x.to(f32).reshape(B, N, C, H, hd)
                      for x in (r, k, v, w))
    u = u.to(f32)
    lw = torch.log(torch.clamp(wc, min=1e-8))
    la = torch.cumsum(lw, dim=2)                   # inclusive log-decay
    a_prev = torch.exp(la - lw)                    # A_{t-1}
    a_last = torch.exp(la[:, :, -1])               # (B, N, H, hd)
    r_t = rc * a_prev
    k_t = kc * torch.exp(-la)
    k_rev = kc * torch.exp(la[:, :, -1:] - la)     # (A_last / A_j) k_j

    # intra-chunk: strictly causal scores + the diagonal bonus term
    scores = torch.einsum("bnthd,bnjhd->bnhtj", r_t, k_t)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.where(mask, scores, torch.zeros((), device=r.device))
    out_intra = torch.einsum("bnhtj,bnjhd->bnthd", scores, vc)
    diag = torch.einsum("bnthd,hd,bnthd->bnth", rc, u, kc)
    out_intra = out_intra + diag[..., None] * vc

    # inter-chunk: the state entering each chunk, then its contribution
    t_mat = torch.einsum("bnjhd,bnjhe->bnhde", k_rev, vc)
    state = torch.zeros((B, H, hd, hd), dtype=f32, device=r.device) \
        if state0 is None else state0.to(f32)
    incoming = []
    for n in range(N):
        incoming.append(state)
        state = a_last[:, n][..., :, None] * state + t_mat[:, n]
    out_inter = torch.einsum("bnthd,bnhde->bnthe", r_t,
                             torch.stack(incoming, dim=1))
    out = (out_intra + out_inter).reshape(B, S, H, hd)
    return out.to(r.dtype), state
