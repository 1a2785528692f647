"""The chunked RWKV6 WKV recurrence, a CUDA kernel for Hopper
(``csrc/wkv.cu``).

Replaces the TPU kernel ``repro/kernels/rwkv/kernel.py::wkv_chunked``, a
(B*H, S/16) Pallas grid that carries the (hd, hd) fp32 state in VMEM
scratch from one chunk step to the next. A CUDA grid carries nothing
between blocks, so a block walks its chunks in order. A head splits into
blocks of 64 value channels (an output column and its state column depend
only on their own v column; rwkv6-7b's hd = 64 is one block a head), one
warp each 16, each warp holding its slice of the state in registers as
tensor-core accumulators: the chunk's products are tf32 MMAs in three parts, which
keep fp32's accuracy. The chunk tiles are double-buffered in shared memory
with ``cp.async``. The state starts from ``state0`` when one is given (the
model's chunked prefill continues the cached state, the reference's
``blocks.py::_wkv_chunked``) and from zero otherwise (the Pallas kernel).
Every sum runs in a fixed order, with no atomics. Bound by bytes at the
model's shapes: r, k, v, w are read once and out written once; the
chunk-serial walk holds it at latency.

A warp holds hd / 2 state floats a lane, so the kernel takes hd up to
:data:`MAX_HEAD` = 256; a larger hd is refused with :class:`WKVLimitError`
on every device, so a call that runs on the CPU runs on the card too.

The host side of a call is kept small: the entry point's argument types
are set once and the stream is passed as its raw handle.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from . import ref

#: positions a chunk holds (``kChunk`` in the source)
CHUNK = ref.CHUNK

#: the largest head size the kernel takes (``kMaxHead``: hd / 2 state
#: floats a lane, at most 128)
MAX_HEAD = 256


class WKVLimitError(ValueError):
    """The head size is one the kernel does not take."""


def smem_bytes(hd: int, itemsize: int = 4) -> int:
    """Shared memory of one block (``smem_bytes`` in the source): the r,
    k, w tiles (rows of hd padded to 16 bytes, plus 16) and the v slice
    (rows of the block's 64 value channels, plus 32 bytes) in the
    operands' type, twice; four fp32 tiles (r A_{t-1}, k / A_j, k_rev, r u k; rows of hd
    rounded up to 8, plus 8), the scores (rows of 20), A_last and u."""
    per = 16 // itemsize
    rs = -(-hd // per) * per + per
    hd8 = -(-hd // 8) * 8
    return (2 * 3 * CHUNK * rs * itemsize
            + 2 * CHUNK * (64 + 32 // itemsize) * itemsize
            + 4 * CHUNK * (hd8 + 8) * 4 + CHUNK * 20 * 4 + 2 * hd8 * 4)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, its argument types set once."""
    fn = build.load("wkv").wkv_chunked_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, state0):
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"wkv_chunked: r, k, v, w must be (B, S, H, hd) of "
                         f"one shape, got {[tuple(x.shape) for x in (r, k, v, w)]}")
    B, S, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"wkv_chunked: u must be ({H}, {hd}), got "
                         f"{tuple(u.shape)}")
    if state0 is not None and tuple(state0.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv_chunked: state0 must be ({B}, {H}, {hd}, "
                         f"{hd}), got {tuple(state0.shape)}")
    if S % CHUNK:
        raise ValueError(f"wkv_chunked: S = {S} is not a multiple of the "
                         f"chunk {CHUNK}")
    if hd > MAX_HEAD:
        raise WKVLimitError(
            f"wkv_chunked: hd = {hd} is over the {MAX_HEAD} the kernel takes "
            f"(hd / 2 state floats a lane)")


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                state0: torch.Tensor = None):
    """r, k, v, w (B, S, H, hd), all float32 or all bfloat16; u (H, hd);
    state0 None (a zero state) or float32 (B, H, hd, hd) -> (out
    (B, S, H, hd) in r's dtype, float32 state (B, H, hd, hd)). S must be a
    multiple of 16. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check(r, k, v, w, u, state0)
    ops = [r, k, v, w, u] + ([] if state0 is None else [state0])
    if all(t.device.type == "cpu" for t in ops):
        return ref.wkv_chunked(r, k, v, w, u, state0)
    if not all(t.is_cuda and t.device == r.device for t in ops):
        raise ValueError("wkv_chunked: operands must lie on one CUDA device")
    if not (r.dtype == k.dtype == v.dtype == w.dtype) or \
            str(r.dtype) not in build.DTYPE_CODES:
        raise ValueError(f"wkv_chunked: r, k, v and w must all be float32 "
                         f"or all bfloat16, got "
                         f"{[str(x.dtype) for x in (r, k, v, w)]}")
    if state0 is not None and state0.dtype != torch.float32:
        raise ValueError(f"wkv_chunked: state0 must be float32, got "
                         f"{state0.dtype}")
    B, S, H, hd = r.shape
    r, k, v, w = (x.contiguous() for x in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    s0 = None if state0 is None else state0.contiguous()
    out = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    # 16-byte copies where every row of r, k, v, w starts 16-byte aligned
    vec = hd * r.element_size() % 16 == 0 and all(
        x.data_ptr() % 16 == 0 for x in (r, k, v, w))
    build.check(_entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                         w.data_ptr(), u.data_ptr(),
                         None if s0 is None else s0.data_ptr(),
                         out.data_ptr(), state.data_ptr(), B, S, H, hd,
                         build.DTYPE_CODES[str(r.dtype)], int(vec),
                         torch._C._cuda_getCurrentRawStream(r.device.index)),
                "wkv_chunked")
    wkv_chunked.launches += 1
    return out, state


wkv_chunked.launches = 0
