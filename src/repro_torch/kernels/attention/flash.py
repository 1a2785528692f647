"""Prefill flash attention, a CUDA kernel for Hopper
(``csrc/flash_attention.cu``), and its gradient, a second one
(``csrc/flash_attention_bwd.cu``).

Replaces the TPU kernel ``repro/kernels/attention/kernel.py::
flash_attention``, a (B Hq, Sq/bq, Sk/bk) Pallas grid whose sequential KV
axis carries the online softmax's fp32 (acc, m, l) in VMEM scratch. Here
one block of eight warps owns one (b h, 128-row query tile) and walks the
32-key tiles in a loop; Q, K and V tiles are staged in shared memory by
``cp.async`` ahead of use, both products run on the tf32 tensor cores
(``mma.sync``; an fp32 product as three tf32 products, which keeps fp32's
accuracy), the (Sq, Sk) score matrix never reaches device memory, tiles
past the causal diagonal or before the window are skipped, and every sum
runs in a fixed order with no atomics. Bound by operations at the prefill
shapes.

What it computes is the reference kernel's function, with two differences
by design: the kernel picks its own tiles (no ``bq``/``bk`` arguments; the
reference shrinks them to divisors of Sq and Sk, the kernel masks the
ragged tile), and it takes ``q_offset`` (query row r sits at position
``q_offset + r``), which the reference's ``attention(impl="pallas")``
drops. A row that admits no key gets the mean of V, as in the reference.

A warp's output tile lives in its registers, 32 ceil(Dh / 64) floats a
lane (128 at Dh = 256), and rows are copied as 4-element groups: a head
wider than 256, or one whose width is not a multiple of 4, is refused with
:class:`FlashAttentionLimitError` on every device, so a call that runs on
the CPU runs on the card too (the configs' heads are 64, 96, 112, 128 and
256).

The gradient: a call that autograd records (grad mode on, an operand that
requires grad) goes through :class:`_FlashAttention`, whose forward is the
same kernel asked for each row's log-sum-exp as well, and whose backward
is :func:`flash_attention_bwd`: FlashAttention-2's backward (P recomputed
from Q, K and the log-sum-exp, D = rowsum(dO o O), then dV, dP, dS, dK
and dQ), a KV head's dK and dV summed over its query heads in a fixed
order, every product on the tensor cores (bf16 MMAs, or three tf32 MMAs a
product in fp32; see the source's header). CPU tensors take the plain
versions of both (``ref.flash_attention``, ``ref.flash_attention_bwd``);
CUDA tensors always launch the kernels: no grad-mode call reaches a plain
version on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import build
from . import ref

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448

#: query rows of a block and keys of a tile (``kBQ``, ``kBK`` in the source)
BQ, BK = 128, 32

#: keys (dK/dV pass) or query rows (dQ pass) of a backward block's
#: resident tile (``kR`` in the source)
BWD_TILE = 64

#: the widest head whose output tile fits a thread's registers
MAX_HEAD_DIM = 256

#: blocks along the grid's second axis (query tiles) CUDA allows
MAX_GRID_Y = 65_535


class FlashAttentionLimitError(ValueError):
    """The head does not fit one block's registers or shared memory."""


def smem_bytes(dh: int, size: int = 4) -> int:
    """Shared memory of one block (``smem_bytes`` in the source): the Q tile
    (BQ rows), one K tile and one V tile (BK rows each) of ``size``-byte
    elements; a row holds Dh rounded up to 64 (the output columns of a
    warp) plus 16 elements (Q, K) or 16 bytes (V, fp32) or 8 elements (V,
    bf16)."""
    cols = -(-dh // 64) * 64
    v_pad = 4 if size == 4 else 8
    return ((BQ + BK) * (cols + 16) + BK * (cols + v_pad)) * size


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, Sq, Hq, Dh) and k, v "
                         f"(B, Sk, Hkv, Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (Hq a multiple of Hkv)")
    if min(b, sq, sk, hq, dh) < 1:
        raise ValueError(f"flash_attention: empty operands, q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if window is not None and int(window) < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if dh > MAX_HEAD_DIM or dh % 4 or smem_bytes(dh) > SMEM_LIMIT:
        raise FlashAttentionLimitError(
            f"flash_attention: a head of Dh = {dh}; the kernel takes "
            f"multiples of 4 up to the {MAX_HEAD_DIM} whose output tile "
            f"fits a thread's registers")


def _on_card(what, *ts):
    """Whether the operands are CPU tensors (False) or lie on one CUDA
    device in one dtype the kernels take (True); raises otherwise."""
    if all(t.device.type == "cpu" for t in ts):
        return False
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"{what}: operands must lie on one CUDA device")
    if len({t.dtype for t in ts}) != 1 or \
            str(ts[0].dtype) not in build.DTYPE_CODES:
        raise ValueError(f"{what}: the operands must all be float32 or all "
                         f"bfloat16, got {[str(t.dtype) for t in ts]}")
    return True


def _check_grid(what, q, k, q_offset):
    b, sq, hq, _ = q.shape
    sk = k.shape[1]
    if b * hq >= 2 ** 31 or -(-sq // BQ) > MAX_GRID_Y or \
            abs(q_offset) + sq + sk >= 2 ** 31:
        raise ValueError(f"{what}: shapes too large for the grid and 32-bit "
                         f"row indices")


def _rows4(*ts):
    """Rows load as 4-element groups: a view that starts off a 4-element
    boundary is copied."""
    return [t.contiguous() if t.data_ptr() % (4 * t.element_size()) == 0
            else t.clone(memory_format=torch.contiguous_format) for t in ts]


def _forward(q, k, v, causal, window, q_offset, with_lse):
    """(out, the rows' log-sum-exp or None): the plain version on CPU
    tensors, the kernel on CUDA tensors."""
    if not _on_card("flash_attention", q, k, v):
        out = ref.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, return_lse=with_lse)
        return out if with_lse else (out, None)
    _check_grid("flash_attention", q, k, q_offset)
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    q, k, v = _rows4(q, k, v)
    # 16-byte copies where every row starts 16-byte aligned
    vec = (dh * q.element_size()) % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   None if lse is None else lse.data_ptr(),
                   b, sq, sk, hq, hkv, dh, int(bool(causal)),
                   0 if window is None else int(window), q_offset,
                   1.0 / math.sqrt(dh), build.DTYPE_CODES[str(q.dtype)],
                   int(vec), torch.cuda.current_stream(q.device).cuda_stream),
                "flash_attention")
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its gradient: the forward kernel (with the
    rows' log-sum-exp) and the backward kernel, or on CPU tensors their
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _forward(q, k, v, causal, window, q_offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, Dh); k, v (B, Sk, Hkv, Dh), all float32 or all
    bfloat16, Hq a multiple of Hkv -> (B, Sq, Hq, Dh) in q's dtype. Query
    row r at position ``q_offset + r`` admits key c iff ``c <= q_offset +
    r`` (causal) and ``c > q_offset + r - window``. CPU tensors take the
    plain version (at its default K/V chunk); CUDA tensors launch the
    kernel, which picks its own tiles. Differentiable: under autograd the
    gradient is :func:`flash_attention_bwd`."""
    _check(q, k, v, window)
    q_offset, causal = int(q_offset), bool(causal)
    window = None if window is None else int(window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset, False)[0]


flash_attention.launches = 0


def bwd_entry(lib):
    """(launch, scratch bytes): the backward kernel's C entry points in
    ``lib`` (its library, or a variant of it), their argument types set."""
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.flash_attention_bwd_scratch
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_int64
    return fn, size


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    """The backward kernel's entry points, loaded once."""
    return bwd_entry(build.load("flash_attention_bwd"))


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = None, q_offset: int = 0):
    """The gradient of :func:`flash_attention`: q, out, dout
    (B, Sq, Hq, Dh); k, v (B, Sk, Hkv, Dh); lse (B, Hq, Sq) float32, the
    forward's rows' log-sum-exp -> (dq, dk, dv) in the operands' dtype.
    CPU tensors take the plain version (``ref.flash_attention_bwd``);
    CUDA tensors launch the kernel (four launches, one
    count), with an fp32 scratch of (B Hq Sq, rounded up to 4, + 2 B Sk Hq
    Dh) floats for the rows' D and the query heads' dK and dV before their
    sum."""
    _check(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash_attention_bwd: out and dout must be "
                         f"{tuple(q.shape)} and lse (B, Hq, Sq), got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    q_offset = int(q_offset)
    window = None if window is None else int(window)
    if not _on_card("flash_attention_bwd", q, k, v, out, dout):
        return ref.flash_attention_bwd(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       q_offset=q_offset)
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be float32 on the "
                         "operands' device")
    _check_grid("flash_attention_bwd", q, k, q_offset)
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    if max(-(-sq // BWD_TILE), -(-sk // BWD_TILE)) > MAX_GRID_Y:
        raise ValueError(f"flash_attention_bwd: sequences too long for the "
                         f"grid's {BWD_TILE}-row and {BWD_TILE}-key tiles")
    q, k, v, out, dout = _rows4(q, k, v, out, dout)
    lse = lse.contiguous()
    # 16-byte copies where every row starts 16-byte aligned
    vec = (dh * q.element_size()) % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in (q, k, v, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fn, size = _bwd_entry()
    scratch = torch.empty(size(b, sq, sk, hq, dh) // 4, dtype=torch.float32,
                          device=q.device)
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                   b, sq, sk, hq, hkv, dh, int(bool(causal)),
                   0 if window is None else int(window), q_offset,
                   1.0 / math.sqrt(dh), build.DTYPE_CODES[str(q.dtype)],
                   int(vec), torch.cuda.current_stream(q.device).cuda_stream),
                "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
