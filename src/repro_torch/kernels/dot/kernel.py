"""DOT: r = sum_i x[i] * w[i] in fp32, a CUDA kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/dot/kernel.py::dot``, which carries
an (8, 128) partial-sum tile in VMEM across a sequential grid. A CUDA grid
has no order and no scratch carried between blocks, so the sum is a
deterministic two-stage reduction in one launch (``csrc/dot.cu``): a fixed
grid of four blocks an SM (``build.partial_blocks``) walks the operands
together, each thread taking every grid-th 16-byte vector with four loads
per operand in flight, and the block that finishes last (an integer
ticket) sums the partials in index order.
The sums take no atomics: repeat runs are byte-identical. Bound by bytes:
each element is read once (8 B in fp32). Used by the Dot Library Node's
``cuda`` expansion.

The host side of a call is kept small: the entry point's argument types
are set once, the SM count is read once per device, the stream is passed
as its raw handle, and the partials and the ticket live in one scratch
buffer per (device, stream), reused by every launch on that stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from . import ref

@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, its argument types set once."""
    fn = build.load("dot").dot_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


#: (device index, raw stream) -> the partials and the ticket of launches
#: on that stream: one word a block, then the ticket, which each launch
#: leaves at 0
_SCRATCH = {}


def _scratch(index: int, stream: int) -> torch.Tensor:
    buf = _SCRATCH.get((index, stream))
    if buf is None:
        buf = torch.zeros(build.partial_blocks(index) + 1, dtype=torch.int32,
                          device=torch.device("cuda", index))
        _SCRATCH[(index, stream)] = buf
    return buf


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(1,) fp32 sum of x*w for (N,) fp32 or bf16 vectors. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.dot(x, w)
    n, code, vec = build.vector_operands("dot", x, w)
    index = x.device.index
    fn = _entry()
    stream = torch._C._cuda_getCurrentRawStream(index)
    scratch = _scratch(index, stream)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    build.check(fn(x.data_ptr(), w.data_ptr(), scratch.data_ptr(),
                   out.data_ptr(), n, code, build.partial_blocks(index),
                   int(vec), stream), "dot")
    dot.launches += 1
    return out


dot.launches = 0
