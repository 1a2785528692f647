"""DOT: r = sum_i x[i] * w[i] in fp32, a CUDA kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/dot/kernel.py::dot``, which carries
an (8, 128) partial-sum tile in VMEM across a sequential grid. A CUDA grid
has no order and no scratch carried between blocks, so the sum is a
deterministic two-stage reduction (``csrc/dot.cu``): a fixed grid of four
blocks per SM each reduce one contiguous chunk with 16-byte loads, then one
block sums the partials in a fixed order. No atomics: repeat runs are
byte-identical. Bound by bytes: each element is read once (8 B in fp32).
Used by the Dot Library Node's ``cuda`` expansion.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from . import ref


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(1,) fp32 sum of x*w for (N,) fp32 or bf16 vectors. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.dot(x, w)
    n, code, vec = build.vector_operands("dot", x, w)
    lib = build.load("dot")
    blocks = build.partial_blocks(x.device)
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    fn = lib.dot_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(x.data_ptr(), w.data_ptr(), partials.data_ptr(),
                   out.data_ptr(), n, code, blocks, int(vec),
                   torch.cuda.current_stream(x.device).cuda_stream), "dot")
    dot.launches += 1
    return out


dot.launches = 0
