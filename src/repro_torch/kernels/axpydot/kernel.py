"""Fused AXPYDOT: r = sum_i (a*x[i] + y[i]) * w[i] in fp32, a CUDA kernel
for Hopper — the paper's streaming-composition pipeline as one kernel.

Replaces the TPU kernel ``repro/kernels/axpydot/kernel.py::axpydot``, where
z = a*x + y never leaves VMEM and an (8, 128) partial-sum tile is carried
across a sequential grid. Here z lives only in registers, and the sum is a
deterministic two-stage reduction (``csrc/axpydot.cu``): a fixed grid of
four blocks per SM each reduce one contiguous chunk with 16-byte loads,
then one block sums the partials in a fixed order. No atomics: repeat runs
are byte-identical. The ragged tail is masked, not zero-padded. Bound by
bytes: each element of x, y and w is read once (12 B in fp32). Registered
as the ``("Axpy", "Dot")`` pipeline fusion.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from . import ref


def axpydot(a, x: torch.Tensor, y: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """(1,) fp32 sum of (a*x + y)*w for (N,) fp32 or bf16 vectors and a
    scalar ``a`` (a number or a one-element tensor, passed by value). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if all(t.device.type == "cpu" for t in (x, y, w)):
        return ref.axpydot(a, x, y, w)
    n, code, vec = build.vector_operands("axpydot", x, y, w)
    lib = build.load("axpydot")
    blocks = build.partial_blocks(x.device)
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    fn = lib.axpydot_launch
    fn.argtypes = [ctypes.c_float] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = float(a.reshape(()).item()) if isinstance(a, torch.Tensor) \
        else float(a)
    build.check(fn(a, x.data_ptr(), y.data_ptr(), w.data_ptr(),
                   partials.data_ptr(), out.data_ptr(), n, code, blocks,
                   int(vec), torch.cuda.current_stream(x.device).cuda_stream),
                "axpydot")
    axpydot.launches += 1
    return out


axpydot.launches = 0
