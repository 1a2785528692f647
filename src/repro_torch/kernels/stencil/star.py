"""The star stencils of the paper's Fig. 19 with a constant-0 boundary,
``diffusion2d`` over (H, W) and ``jacobi3d``/``diffusion3d`` over
(D, H, W), as CUDA kernels for Hopper (``csrc/stencil_star.cu``).

Replace the TPU kernels ``repro/kernels/stencil/kernel.py::diffusion2d``,
``::jacobi3d`` and ``::diffusion3d``, which read a padded copy of the field
in slabs whose height divides the slowest axis, with their tile (``bh``,
``bd``) as an argument. Here the kernel chooses its own tiles
(:data:`TILE_2D`; :data:`TILE_3D` columns marching over :data:`CHUNK_3D`
planes), loads with predicates (no padded copy, any shape), and sums in the
reference's order. Bound by bytes: the field is read once and the result
written once.

The kernels take contiguous float32 fields of their rank only; anything
else is refused with :class:`StencilLimitError` on every device, so a call
that runs on the CPU runs on the card too. CPU tensors take the plain
versions of ``ref.py``; CUDA tensors launch the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from . import ref
from .kernel import StencilLimitError

#: ``kTileH x kTileW`` of the source: a diffusion2d block's output tile
TILE_2D = (32, 128)
#: ``k3TY x k3TX`` of the source: a 3-D block's (H, W) tile of columns, and
#: ``k3BD``: the planes of D it marches over
TILE_3D = (8, 32)
CHUNK_3D = 64


def _check(a: torch.Tensor, rank: int, what: str):
    """Refuse what the kernel does not take, on every device."""
    if a.dim() != rank or a.dtype != torch.float32 or a.numel() == 0:
        raise StencilLimitError(
            f"{what}: the kernel takes a non-empty {rank}-D float32 field, "
            f"got {tuple(a.shape)} {a.dtype}")
    if not a.is_contiguous():
        raise StencilLimitError(f"{what}: the field must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: the field lies on {a.device}; the kernel "
                         f"takes CUDA tensors, the plain version CPU ones")


def _launch(fn, a: torch.Tensor, args, what: str) -> torch.Tensor:
    out = torch.empty_like(a)
    build.check(fn(a.data_ptr(), out.data_ptr(), *a.shape, *args,
                   torch.cuda.current_stream(a.device).cuda_stream), what)
    return out


def diffusion2d(a: torch.Tensor, coeffs) -> torch.Tensor:
    """c0*a[i,j] + c1*a[i-1,j] + c2*a[i+1,j] + c3*a[i,j-1] + c4*a[i,j+1] over
    an (H, W) float32 field, constant-0 boundary; ``coeffs`` five numbers
    (a sequence, array or tensor), taken as float32."""
    _check(a, 2, "diffusion2d")
    c = torch.as_tensor(coeffs, dtype=torch.float32, device="cpu").reshape(-1)
    if c.numel() != 5:
        raise ValueError(f"diffusion2d: {c.numel()} coefficients, not 5")
    c = c.tolist()
    if a.device.type == "cpu":
        return ref.diffusion2d(a, c)
    fn = build.load("stencil_star").diffusion2d_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + \
        [ctypes.c_float] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = _launch(fn, a, c, "diffusion2d")
    diffusion2d.launches += 1
    return out


def _star3d(a, diffusion: bool, alpha: float, what: str):
    fn = build.load("stencil_star").star3d_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + \
        [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _launch(fn, a, (int(diffusion), alpha), what)


def jacobi3d(a: torch.Tensor) -> torch.Tensor:
    """(1/7) (a[d,h,w] + its six neighbours) over a (D, H, W) float32 field,
    constant-0 boundary."""
    _check(a, 3, "jacobi3d")
    if a.device.type == "cpu":
        return ref.jacobi3d(a)
    out = _star3d(a, False, 0.0, "jacobi3d")
    jacobi3d.launches += 1
    return out


def diffusion3d(a: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """a + alpha (sum of the six neighbours - 6 a) over a (D, H, W) float32
    field, constant-0 boundary; ``alpha`` taken as float32."""
    _check(a, 3, "diffusion3d")
    alpha = float(torch.tensor(float(alpha), dtype=torch.float32))
    if a.device.type == "cpu":
        return ref.diffusion3d(a, alpha)
    out = _star3d(a, True, alpha, "diffusion3d")
    diffusion3d.launches += 1
    return out


diffusion2d.launches = 0
jacobi3d.launches = 0
diffusion3d.launches = 0
