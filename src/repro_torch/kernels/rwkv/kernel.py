"""The chunked RWKV6 WKV recurrence, a CUDA kernel for Hopper
(``csrc/wkv.cu``).

Replaces the TPU kernel ``repro/kernels/rwkv/kernel.py::wkv_chunked``, a
(B*H, S/16) Pallas grid that carries the (hd, hd) fp32 state in VMEM
scratch from one chunk step to the next. A CUDA grid carries nothing
between blocks, so one block owns one (b, h) and walks its chunks in
order with the state in shared memory. The state starts from ``state0``
when one is given (the model's chunked prefill continues the cached state,
the reference's ``blocks.py::_wkv_chunked``) and from zero otherwise (the
Pallas kernel). Every sum runs in a fixed order, with no atomics. Bound by
bytes at the model's shapes: r, k, v, w are read once and out written once.

The block keeps the state and the chunk's tiles in shared memory: an hd
whose block does not fit the 227 KB a block may use is refused with
:class:`WKVLimitError` on every device (hd up to 202 fits), so a call that
runs on the CPU runs on the card too.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from . import ref

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448

#: positions a chunk holds (``kChunk`` in the source)
CHUNK = ref.CHUNK


class WKVLimitError(ValueError):
    """The head size does not fit one block's shared memory."""


def smem_bytes(hd: int) -> int:
    """Shared memory of one block: the state, five padded chunk tiles, the
    causal scores, the bonus terms, A_last and u, all fp32
    (``wkv_chunked_smem`` in the source)."""
    return 4 * (hd * hd + 5 * CHUNK * (hd + 1) + CHUNK * CHUNK + CHUNK
                + 2 * hd)


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
    need = smem_bytes(hd)
    if need > SMEM_LIMIT:
        raise WKVLimitError(
            f"wkv_chunked: hd = {hd} needs {need} B of shared memory per "
            f"block, over {SMEM_LIMIT} B")


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
    if B * H >= 2 ** 31:
        raise ValueError("wkv_chunked: B * H too large for the grid")
    r, k, v, w = (x.contiguous() for x in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    s0 = None if state0 is None else state0.contiguous()
    out = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    fn = build.load("wkv").wkv_chunked_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), None if s0 is None else s0.data_ptr(),
                   out.data_ptr(), state.data_ptr(), B, S, H, hd,
                   build.DTYPE_CODES[str(r.dtype)],
                   torch.cuda.current_stream(r.device).cuda_stream),
                "wkv_chunked")
    wkv_chunked.launches += 1
    return out, state


wkv_chunked.launches = 0
