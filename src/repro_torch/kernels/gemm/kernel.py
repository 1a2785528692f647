"""Tiled GEMM: C = act(A @ B + bias) with fp32 accumulation, CUDA kernels
for Hopper (``csrc/gemm.cu``).

Replaces the TPU kernel ``repro/kernels/gemm/kernel.py::matmul``, whose
K grid dimension carries an fp32 VMEM scratch tile across sequential grid
steps and whose ragged edges are zero-padded copies. Here each block owns
one output tile and loops over K itself with the accumulator in
registers; the edges are masked (or zero-filled by TMA). The epilogue
(bias, then activation) runs in fp32 before the one store.

Two routes, picked by :func:`route` before the launch from dtype, shape,
strides and alignment alone, never after a failure:

* ``"wgmma"``: bf16 operands that TMA can read. 128 x 128 tiles, a ring of
  64-deep K stages filled by TMA, ``wgmma`` on the tensor cores; B may be
  K-major (the ``W.T`` view of Linear and Conv2d) or N-major (a
  contiguous (K, N) matrix). Bound by operations (989 TFLOP/s bf16).
* ``"fma"``: every fp32 product (IEEE FMAs, no TF32) and the bf16 products
  TMA cannot take. Register-tiled, with double-buffered 8-deep K slices
  whose next loads fly while the FMAs run. The tile shape follows N
  (:func:`tile_shape`): the paper's LeNet products are skinny — conv1 as
  im2col is (576,000 x 25) @ (25 x 6) at batch 1000 — and a square
  128 x 128 tile would leave 95% of its columns masked, so N <= 16 takes
  256 x 16 tiles, N <= 64 128 x 64 and wider N 128 x 128; a wider product
  whose grid of those would leave SMs idle (LeNet's fc layers at M = 1,000)
  takes 64 x 64 tiles. The LeNet shapes are bound by bytes, a 4096^3
  product by operations (67 TFLOP/s fp32).

``matmul.launches`` counts launches, ``matmul.routes`` them by route.
Used by the Gemm, Linear and Conv2d ``cuda`` levels and the
Conv2d->MaxPool2d pipeline fusion.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from .. import build
from . import ref

#: the K slice each route stages in shared memory per step (``BK`` and
#: ``kWgBK`` in the source)
K_TILE = 8
WGMMA_K_TILE = 64

#: (largest N, code, rows, columns) of the fma route's tile shapes
TILES = ((16, 0, 256, 16), (64, 1, 128, 64), (None, 2, 128, 128))
#: (code, rows, columns) of the tile that N > 16 takes when the tiles above
#: would give fewer blocks than the card has SMs
SMALL_TILE = (3, 64, 64)

def tile_shape(n: int, m: int = None, sms: int = 0):
    """(code, rows, columns) of the fma route's output tile for an
    N-column product; with M rows on a card of ``sms`` SMs, N > 16 takes
    :data:`SMALL_TILE` where the tile for N would leave SMs idle."""
    for limit, code, rows, cols in TILES:
        if limit is None or n <= limit:
            break
    if m is not None and n > 16 and \
            -(-m // rows) * -(-n // cols) < sms:
        return SMALL_TILE
    return code, rows, cols


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tma_rows(stride: int, length: int) -> bool:
    """Rows of ``length`` unit-stride elements, ``stride`` apart, that a
    TMA map of bf16 takes: 16-byte multiples, not overlapping."""
    return stride % 8 == 0 and stride >= length


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that takes A (M, K) @ B (K, N): ``"wgmma"`` for bf16
    operands TMA can read — A with unit stride along K, B with unit stride
    along K or N, the other stride a multiple of 8 elements, both bases
    16-byte aligned, no extent 0 and M, N, K below 2^31 — else ``"fma"``.
    Reads only dtype, shape, strides and ``data_ptr() % 16``."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            a.dim() != 2 or b.dim() != 2:
        return "fma"
    (m, k), n = a.shape, b.shape[1]
    if min(m, k, n) == 0 or max(m, k, n) >= 2 ** 31:
        return "fma"
    sam, sak = a.stride()
    sbk, sbn = b.stride()
    if sak != 1 or not _tma_rows(sam, k):
        return "fma"
    if not ((sbn == 1 and _tma_rows(sbk, n)) or
            (sbk == 1 and sbn != 1 and _tma_rows(sbn, k))):
        return "fma"
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        return "fma"
    return "wgmma"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library, its entry points' argument types set once."""
    lib = build.load("gemm")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.matmul_launch.argtypes = [ptr] * 4 + [i64, i32, i32] + [i64] * 4 + \
        [i32] * 3 + [ptr]
    lib.matmul_launch.restype = i32
    lib.matmul_wgmma_launch.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 3 + \
        [i32, ptr]
    lib.matmul_wgmma_launch.restype = i32
    return lib


def matmul(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor = None, *,
           activation: str = None) -> torch.Tensor:
    """C = act(A @ B + bias) for A (M, K), B (K, N), both float32 or both
    bfloat16, any strides; ``bias`` (N,); output contiguous, in A's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    :func:`route`."""
    act = ref.ACTIVATIONS.get(activation)
    if act is None:
        raise ValueError(f"matmul: unknown activation {activation!r}")
    if a.device.type == "cpu" and b.device.type == "cpu" and (
            bias is None or bias.device.type == "cpu"):
        return ref.matmul(a, b, bias, activation=activation)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    dev = a.device
    if not (a.is_cuda and b.device == dev and
            (bias is None or bias.device == dev)):
        raise ValueError("matmul: operands must lie on one CUDA device")
    if a.dtype != b.dtype or str(a.dtype) not in build.DTYPE_CODES:
        raise ValueError(f"matmul: A and B must both be float32 or both "
                         f"bfloat16, got {a.dtype} and {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"matmul: bias {tuple(bias.shape)} is not ({n},)")
        if bias.dtype != torch.float32 or not bias.is_contiguous():
            bias = bias.to(torch.float32).contiguous()
    if max(n, k) >= 2 ** 31:
        raise ValueError("matmul: N and K must be below 2^31")
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    lib = _library()
    which = route(a, b)
    bp = bias.data_ptr() if bias is not None else None
    # what torch.cuda.current_stream(dev).cuda_stream gives, without
    # building a Stream object on every launch
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    sam, sak = a.stride()
    sbk, sbn = b.stride()
    if which == "wgmma":
        rc = lib.matmul_wgmma_launch(a.data_ptr(), b.data_ptr(), bp,
                                     out.data_ptr(), m, n, k, sam, sbk, sbn,
                                     act, stream)
    else:
        rc = lib.matmul_launch(a.data_ptr(), b.data_ptr(), bp,
                               out.data_ptr(), m, n, k, sam, sak, sbk, sbn,
                               build.DTYPE_CODES[str(a.dtype)], act,
                               tile_shape(n, m, _sms(dev.index))[0], stream)
    build.check(rc, f"matmul ({which})")
    matmul.launches += 1
    matmul.routes[which] += 1
    return out


matmul.launches = 0
matmul.routes = Counter({"wgmma": 0, "fma": 0})
