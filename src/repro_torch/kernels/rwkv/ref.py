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
    bfloat16 (computed in float32; float64 operands in float64), u (H, hd),
    state0 None (zeros) or a float32 (B, H, hd, hd) -> (out (B, S, H, hd)
    in r's dtype, float32 state (B, H, hd, hd)). S must be a multiple of
    ``chunk``.

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
    f32 = torch.float64 if r.dtype == torch.float64 else torch.float32
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


def wkv_chunked_bwd(r, k, v, w, u, state0, dout, dstate=None,
                    chunk: int = CHUNK):
    """The gradient of :func:`wkv_chunked`, written out chunk by chunk (no
    autograd): r, k, v, w (B, S, H, hd), u (H, hd), state0 None or
    (B, H, hd, hd), dout (B, S, H, hd), dstate None or the float32
    gradient of the final state -> (dr, dk, dv, dw in r's dtype, du
    (H, hd) in u's dtype, dstate0 float32 (B, H, hd, hd)), computed in
    float32 (float64 for float64 operands).

    The chunk-start states are recomputed first. Then, walking the chunks
    in reverse with G the gradient of the state leaving the chunk (dstate,
    or zero, at the last) and S_0 the state entering it, with
    Q_t = r_t A_{t-1}, K_j = k_j / A_j, Kr_j = (A_last / A_j) k_j,
    P_tj = Q_t . K_j (j < t), b_t = r_t . (u k_t), dov_tj = dout_t . v_j:

      dv_j  = sum_{t>j} P_tj dout_t + b_j dout_j + G^T Kr_j
      dQ_t  = S_0 dout_t + sum_{j<t} dov_tj K_j
      dr_t  = A_{t-1} dQ_t + dov_tt u k_t
      dK_j  = sum_{t>j} dov_tj Q_t,   gv_j = G v_j
      dk_j  = dK_j / A_j + (A_last / A_j) gv_j + dov_jj u r_j
      du    = sum_{b,t} dov_tt r_t k_t
      G    <- diag(A_last) G + sum_t Q_t dout_t^T     (into the chunk before)

    and the decays through their log: with the inclusive cumulative log
    decay la_t and the exclusive one la_t - lw_t, d la_j = -K_j dK_j -
    Kr_j gv_j (plus, at the chunk's last position, sum_j Kr_j gv_j +
    A_last rowsum(S_0 o G)), d lae_t = Q_t dQ_t, and d lw_s = sum_{t>=s}
    d la_t + sum_{t>s} d lae_t; dw = d lw / w where w >= 1e-8 and 0 below,
    as the forward's log(max(w, 1e-8)) gives."""
    B, S, H, hd = r.shape
    N, C = S // chunk, chunk
    f32 = torch.float64 if r.dtype == torch.float64 else torch.float32
    rc, kc, vc, wc, do = (x.to(f32).reshape(B, N, C, H, hd)
                          for x in (r, k, v, w, dout))
    u32 = u.to(f32)
    lw = torch.log(torch.clamp(wc, min=1e-8))
    la = torch.cumsum(lw, dim=2)
    lae = la - lw
    a_last = torch.exp(la[:, :, -1])                  # (B, N, H, hd)
    q_t = rc * torch.exp(lae)
    k_t = kc * torch.exp(-la)
    k_rev = kc * torch.exp(la[:, :, -1:] - la)

    # the states entering each chunk (the forward's), and the gradient of
    # the state leaving each chunk, by one walk each way
    t_mat = torch.einsum("bnjhd,bnjhe->bnhde", k_rev, vc)
    state = torch.zeros((B, H, hd, hd), dtype=f32, device=r.device) \
        if state0 is None else state0.to(f32)
    incoming = []
    for n in range(N):
        incoming.append(state)
        state = a_last[:, n][..., :, None] * state + t_mat[:, n]
    s0 = torch.stack(incoming, dim=1)                 # (B, N, H, hd, hd)
    qdo = torch.einsum("bnthd,bnthe->bnhde", q_t, do)
    g = torch.zeros((B, H, hd, hd), dtype=f32, device=r.device) \
        if dstate is None else dstate.to(f32)
    leaving = [None] * N
    for n in reversed(range(N)):
        leaving[n] = g
        g = a_last[:, n][..., :, None] * g + qdo[:, n]
    gs = torch.stack(leaving, dim=1)                  # (B, N, H, hd, hd)

    lower = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    zero = torch.zeros((), device=r.device)
    scores = torch.where(lower, torch.einsum("bnthd,bnjhd->bnhtj", q_t, k_t),
                         zero)
    dov = torch.einsum("bnthe,bnjhe->bnhtj", do, vc)
    dov_diag = torch.diagonal(dov, dim1=-2, dim2=-1)  # (B, N, H, C)
    dov_diag = dov_diag.permute(0, 1, 3, 2)[..., None]  # (B, N, C, H, 1)
    dov_low = torch.where(lower, dov, zero)
    bonus = torch.einsum("bnthd,hd,bnthd->bnth", rc, u32, kc)

    dv = (torch.einsum("bnhtj,bnthe->bnjhe", scores, do)
          + bonus[..., None] * do
          + torch.einsum("bnjhd,bnhde->bnjhe", k_rev, gs))
    dq_t = (torch.einsum("bnhde,bnthe->bnthd", s0, do)
            + torch.einsum("bnhtj,bnjhd->bnthd", dov_low, k_t))
    dr = torch.exp(lae) * dq_t + dov_diag * u32 * kc
    dk_t = torch.einsum("bnhtj,bnthd->bnjhd", dov_low, q_t)
    gv = torch.einsum("bnhde,bnjhe->bnjhd", gs, vc)
    dk = torch.exp(-la) * dk_t + torch.exp(la[:, :, -1:] - la) * gv \
        + dov_diag * u32 * rc
    du = (dov_diag * rc * kc).sum(dim=(0, 1, 2))

    d_la = -k_t * dk_t - k_rev * gv
    d_la[:, :, -1] += (k_rev * gv).sum(dim=2) + a_last * (s0 * gs).sum(-1)
    d_lae = q_t * dq_t
    rev = torch.flip(torch.cumsum(torch.flip(d_la + d_lae, [2]), dim=2), [2])
    d_lw = rev - d_lae
    dw = torch.where(wc >= 1e-8, d_lw / wc, zero)

    def back(x, like):
        return x.reshape(B, S, H, hd).to(like.dtype)
    return (back(dr, r), back(dk, k), back(dv, v), back(dw, w),
            du.to(u.dtype), g)
