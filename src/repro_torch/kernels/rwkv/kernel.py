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

The gradient: a call that autograd records (grad mode on, an operand that
requires grad) goes through :class:`_WKV`, whose forward is the same
kernel and whose backward is :func:`wkv_chunked_bwd`, a second kernel
(``csrc/wkv_bwd.cu``, five launches, chunk-parallel): a block a (b, h,
span: 32 positions up to hd 128, 16 above) sums each
span's contribution to the state and to the state's gradient, a thread a
state element scans those over the spans (S / 32 steps of one FMA each
way at rwkv6-7b's hd 64, into a scratch: 341 MB at its B 1 x S 4,096),
then a block a span computes dr, dk and d log w, and another dv and dw,
from the span's entering state and leaving gradient, on the tensor cores;
du's parts are summed in a fixed order by a last launch. CPU tensors take
the plain versions of both; CUDA tensors always launch the kernels.
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


def _on_card(what, r, k, v, w, u, state0, *more):
    """Whether the operands are CPU tensors (False) or lie on one CUDA
    device in types the kernels take (True); raises otherwise."""
    ops = [r, k, v, w, u] + [t for t in (state0,) + more if t is not None]
    if all(t.device.type == "cpu" for t in ops):
        return False
    if not all(t.is_cuda and t.device == r.device for t in ops):
        raise ValueError(f"{what}: operands must lie on one CUDA device")
    if not (r.dtype == k.dtype == v.dtype == w.dtype) or \
            str(r.dtype) not in build.DTYPE_CODES:
        raise ValueError(f"{what}: r, k, v and w must all be float32 "
                         f"or all bfloat16, got "
                         f"{[str(x.dtype) for x in (r, k, v, w)]}")
    if state0 is not None and state0.dtype != torch.float32:
        raise ValueError(f"{what}: state0 must be float32, got "
                         f"{state0.dtype}")
    return True


class _WKV(torch.autograd.Function):
    """wkv_chunked with its gradient: the forward kernel and the backward
    kernel, or on CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        out, state = _forward(r, k, v, w, u, state0)
        ctx.save_for_backward(r, k, v, w, u, state0)
        # an unused output's gradient comes as None (the kernels read a
        # null final-state gradient as zero)
        ctx.set_materialize_grads(False)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, state0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = wkv_chunked_bwd(r, k, v, w, u, state0,
                                                  dout, dstate)
        return dr, dk, dv, dw, du.to(u.dtype), \
            None if state0 is None else ds0


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                state0: torch.Tensor = None):
    """r, k, v, w (B, S, H, hd), all float32 or all bfloat16; u (H, hd);
    state0 None (a zero state) or float32 (B, H, hd, hd) -> (out
    (B, S, H, hd) in r's dtype, float32 state (B, H, hd, hd)). S must be a
    multiple of 16. CPU tensors take the plain version; CUDA tensors
    launch the kernel. Differentiable in every operand, the final state's
    gradient included: under autograd the gradient is
    :func:`wkv_chunked_bwd`."""
    _check(r, k, v, w, u, state0)
    ops = [r, k, v, w, u] + ([] if state0 is None else [state0])
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return _WKV.apply(r, k, v, w, u, state0)
    return _forward(r, k, v, w, u, state0)


def _forward(r, k, v, w, u, state0):
    if not _on_card("wkv_chunked", r, k, v, w, u, state0):
        return ref.wkv_chunked(r, k, v, w, u, state0)
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


def bwd_entry(lib):
    """(launch, scratch bytes): the backward kernel's C entry points in
    ``lib`` (its library, or a variant of it), their argument types set."""
    fn = lib.wkv_chunked_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.wkv_chunked_bwd_scratch
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_int64
    return fn, size


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    """The backward kernel's entry points, loaded once."""
    return bwd_entry(build.load("wkv_bwd"))


def wkv_chunked_bwd(r, k, v, w, u, state0, dout, dstate=None):
    """The gradient of :func:`wkv_chunked`: its operands, dout
    (B, S, H, hd) in r's dtype and dstate None (zero) or the float32
    gradient of the final state -> (dr, dk, dv, dw in r's dtype, du float32
    (H, hd), dstate0 float32 (B, H, hd, hd)). dw is 0 where w < 1e-8, as the
    forward's clamp gives. CPU tensors take the plain version; CUDA
    tensors launch the kernel (five launches, one count)."""
    _check(r, k, v, w, u, state0)
    if dout.shape != r.shape or (dstate is not None and tuple(
            dstate.shape) != (r.shape[0], r.shape[2], r.shape[3],
                              r.shape[3])):
        raise ValueError(f"wkv_chunked_bwd: dout must be {tuple(r.shape)} "
                         f"and dstate (B, H, hd, hd), got "
                         f"{tuple(dout.shape)}, "
                         f"{None if dstate is None else tuple(dstate.shape)}")
    if not _on_card("wkv_chunked_bwd", r, k, v, w, u, state0, dout,
                    dstate):
        dr, dk, dv, dw, du, ds0 = ref.wkv_chunked_bwd(
            r, k, v, w, u, state0, dout, dstate)
        return dr, dk, dv, dw, du.float(), ds0
    if dout.dtype != r.dtype or (dstate is not None
                                 and dstate.dtype != torch.float32):
        raise ValueError(f"wkv_chunked_bwd: dout must be {r.dtype} and "
                         f"dstate float32")
    B, S, H, hd = r.shape
    r, k, v, w, dout = (x.contiguous() for x in (r, k, v, w, dout))
    u = u.to(torch.float32).contiguous()
    s0 = None if state0 is None else state0.contiguous()
    dst = None if dstate is None else dstate.contiguous()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    fn, size = _bwd_entry()
    scratch = torch.empty(size(B, S, H, hd) // 4, dtype=torch.float32,
                          device=r.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), ptr(s0), dout.data_ptr(), ptr(dst),
                   dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                   du.data_ptr(), ds0.data_ptr(), scratch.data_ptr(),
                   B, S, H, hd, build.DTYPE_CODES[str(r.dtype)],
                   torch._C._cuda_getCurrentRawStream(r.device.index)),
                "wkv_chunked_bwd")
    wkv_chunked_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


wkv_chunked_bwd.launches = 0
