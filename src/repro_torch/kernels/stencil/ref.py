"""The plain PyTorch versions of the stencil kernels (paper §6,
StencilFlow): constant-0 boundary conditions, matching the paper's
Fig.-17 JSON programs. Sums are formed in fp32 in tap order and the result
is cast back to the input's dtype, as the reference's oracles do."""
import torch
import torch.nn.functional as F

f32 = torch.float32


def _pad(a, r):
    """Constant-0 padding of ``r`` on every side of every dimension."""
    return F.pad(a, (r, r) * a.dim())


def diffusion2d(a, coeffs):
    """b = c0*a[j,k] + c1*a[j-1,k] + c2*a[j+1,k] + c3*a[j,k-1] + c4*a[j,k+1]."""
    c0, c1, c2, c3, c4 = [float(c) for c in coeffs]
    p = _pad(a.to(f32), 1)
    return (c0 * p[1:-1, 1:-1] + c1 * p[:-2, 1:-1] + c2 * p[2:, 1:-1]
            + c3 * p[1:-1, :-2] + c4 * p[1:-1, 2:]).to(a.dtype)


def jacobi3d(a):
    """7-point Jacobi: average of the 6 neighbors and the center / 7."""
    p = _pad(a.to(f32), 1)
    out = (1.0 / 7.0) * (p[1:-1, 1:-1, 1:-1] + p[:-2, 1:-1, 1:-1]
                         + p[2:, 1:-1, 1:-1] + p[1:-1, :-2, 1:-1]
                         + p[1:-1, 2:, 1:-1] + p[1:-1, 1:-1, :-2]
                         + p[1:-1, 1:-1, 2:])
    return out.to(a.dtype)


def _stencil_f32(a, coeffs, offsets):
    r = max(max(abs(di), abs(dj)) for di, dj in offsets)
    p = _pad(a.to(f32), r)
    H, W = a.shape
    c = torch.as_tensor(coeffs, dtype=f32, device=a.device).reshape(-1)
    out = torch.zeros((H, W), dtype=f32, device=a.device)
    for k, (di, dj) in enumerate(offsets):
        out = out + c[k] * p[r + di:r + di + H, r + dj:r + dj + W]
    return out


def stencil2d(a, coeffs, offsets):
    """Generic 2D stencil, constant-0 boundary; ``coeffs`` a sequence or a
    (k,) tensor in the order of ``offsets``."""
    return _stencil_f32(a, coeffs, offsets).to(a.dtype)


def stencil2d_chain(a, coeffs_per_stage, offsets_per_stage):
    """The stages applied one after another, each with its own constant-0
    boundary, intermediates in fp32: what the fused chain kernel
    computes."""
    out = a
    for coeffs, offsets in zip(coeffs_per_stage, offsets_per_stage):
        out = _stencil_f32(out, coeffs, offsets)
    return out.to(a.dtype)


def diffusion3d(a, alpha=0.1):
    """Explicit diffusion step: a + alpha * 3D laplacian(a)."""
    p = _pad(a.to(f32), 1)
    lap = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
           + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
           + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:]
           - 6.0 * p[1:-1, 1:-1, 1:-1])
    return (a.to(f32) + float(alpha) * lap).to(a.dtype)
