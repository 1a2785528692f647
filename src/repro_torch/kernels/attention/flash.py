"""Prefill flash attention (forward), a CUDA kernel for Hopper
(``csrc/flash_attention.cu``).

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
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build
from . import ref

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448

#: query rows of a block and keys of a tile (``kBQ``, ``kBK`` in the source)
BQ, BK = 128, 32

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, Dh); k, v (B, Sk, Hkv, Dh), all float32 or all
    bfloat16, Hq a multiple of Hkv -> (B, Sq, Hq, Dh) in q's dtype. Query
    row r at position ``q_offset + r`` admits key c iff ``c <= q_offset +
    r`` (causal) and ``c > q_offset + r - window``. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check(q, k, v, window)
    q_offset = int(q_offset)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention: operands must lie on one CUDA "
                         "device")
    if not (q.dtype == k.dtype == v.dtype) or \
            str(q.dtype) not in build.DTYPE_CODES:
        raise ValueError(f"flash_attention: q, k and v must all be float32 "
                         f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    if b * hq >= 2 ** 31 or -(-sq // BQ) > MAX_GRID_Y or \
            abs(q_offset) + sq + sk >= 2 ** 31:
        raise ValueError("flash_attention: shapes too large for the grid "
                         "and 32-bit row indices")
    # rows load as 4-element groups: a view that starts off a 4-element
    # boundary is copied
    q, k, v = (t.contiguous() if t.data_ptr() % (4 * t.element_size()) == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    # 16-byte copies where every row starts 16-byte aligned
    vec = (dh * q.element_size()) % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    out = torch.empty_like(q)
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, sq, sk, hq, hkv, dh, int(bool(causal)),
                   0 if window is None else int(window), q_offset,
                   1.0 / math.sqrt(dh), build.DTYPE_CODES[str(q.dtype)],
                   int(vec), torch.cuda.current_stream(q.device).cuda_stream),
                "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
