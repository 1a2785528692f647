"""Tiled GEMM: C = act(A @ B + bias) with fp32 accumulation, a CUDA kernel
for Hopper (``csrc/gemm.cu``).

Replaces the TPU kernel ``repro/kernels/gemm/kernel.py::matmul``, whose
K grid dimension carries an fp32 VMEM scratch tile across sequential grid
steps and whose ragged edges are zero-padded copies. Here each block owns
one output tile and loops over K itself with the accumulator in
registers; the edges are masked loads and stores. fp32 inputs use IEEE
fp32 FMAs (no TF32); bf16 inputs are widened to fp32 in shared memory and
take the same FMA path. The epilogue (bias, then activation) runs in fp32
before the one store.

The tile shape follows N (:func:`tile_shape`): the paper's LeNet products
are skinny — conv1 as im2col is (576,000 x 25) @ (25 x 6) at batch 1000 —
and a square 128 x 128 tile would leave 95% of its columns masked, so
N <= 16 takes 256 x 16 tiles, N <= 64 128 x 64 and wider N 128 x 128.
The LeNet shapes are bound by bytes, a 4096^3 product by operations.
Used by the Gemm, Linear and Conv2d ``cuda`` levels and the
Conv2d->MaxPool2d pipeline fusion.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from . import ref

#: the K slice staged in shared memory per step (``BK`` in the source)
K_TILE = 16

#: (largest N, code, rows, columns) of the tile shapes ``csrc/gemm.cu`` has
TILES = ((16, 0, 256, 16), (64, 1, 128, 64), (None, 2, 128, 128))


def tile_shape(n: int):
    """(code, rows, columns) of the output tile for an N-column product."""
    for limit, code, rows, cols in TILES:
        if limit is None or n <= limit:
            return code, rows, cols
    raise AssertionError("unreachable")


def matmul(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor = None, *,
           activation: str = None) -> torch.Tensor:
    """C = act(A @ B + bias) for A (M, K), B (K, N), both float32 or both
    bfloat16, any strides; ``bias`` (N,); output contiguous, in A's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if activation not in ref.ACTIVATIONS:
        raise ValueError(f"matmul: unknown activation {activation!r}")
    ts = [a, b] + ([bias] if bias is not None else [])
    if all(t.device.type == "cpu" for t in ts):
        return ref.matmul(a, b, bias, activation=activation)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    if not all(t.is_cuda and t.device == a.device for t in ts):
        raise ValueError("matmul: operands must lie on one CUDA device")
    if a.dtype != b.dtype or str(a.dtype) not in build.DTYPE_CODES:
        raise ValueError(f"matmul: A and B must both be float32 or both "
                         f"bfloat16, got {a.dtype} and {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"matmul: bias {tuple(bias.shape)} is not ({n},)")
        bias = bias.to(torch.float32).contiguous()
    if max(n, k) >= 2 ** 31:
        raise ValueError("matmul: N and K must be below 2^31")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    code, _, _ = tile_shape(n)
    fn = build.load("gemm").matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int] + [ctypes.c_int64] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(a.data_ptr(), b.data_ptr(),
                   bias.data_ptr() if bias is not None else None,
                   out.data_ptr(), m, n, k, a.stride(0), a.stride(1),
                   b.stride(0), b.stride(1), build.DTYPE_CODES[str(a.dtype)],
                   ref.ACTIVATIONS[activation], code,
                   torch.cuda.current_stream(a.device).cuda_stream), "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
