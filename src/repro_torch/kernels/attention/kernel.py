"""Decode attention over a gathered paged-KV context, a CUDA kernel for
Hopper (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``repro/kernels/attention/decode.py::
decode_attention``, a (B, H) Pallas grid whose cell holds its (C, Dh) K
and V slab in VMEM with ``pos`` as a prefetched scalar. Here one block of
256 threads owns one (b, h) row: the fp32 scores of the whole context
bucket stay in shared memory, masked positions (``j > pos``, and
``j <= pos - window`` on sliding-window layers) score -1e30 without their
K row being read, the max and the normalizer are deterministic block
reductions, and each thread sums p_j v_j for its columns of Dh. No
atomics. Bound by bytes: K and V are read once.

The scores take 4 C bytes of shared memory: a context whose block does not
fit the 227 KB a block may use is refused with
:class:`DecodeAttentionLimitError` on every device — C up to 57,000 fits
at Dh = 128 — so a call that runs on the CPU runs on the card too.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build
from . import ref

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448

#: threads (and their warps) of one block, ``kThreads`` in the source
THREADS = 256


class DecodeAttentionLimitError(ValueError):
    """The context bucket does not fit one block's shared memory."""


def smem_bytes(ctx: int, dh: int) -> int:
    """Shared memory of one block: the C scores, q, the warp results and
    the per-thread partial column sums, all fp32 (``decode_attention_smem``
    in the source)."""
    return 4 * (ctx + dh + THREADS // 32 + THREADS)


def _check(q, k, v, pos, window):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q (B, H, Dh) and k, v "
                         f"(B, C, H, Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, dh = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, dh):
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (GQA-repeat them first)")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"decode_attention: pos must be ({b},), got "
                         f"{tuple(pos.shape)}")
    if window is not None and int(window) < 1:
        raise ValueError(f"decode_attention: window {window} < 1")
    need = smem_bytes(k.shape[1], dh)
    if need > SMEM_LIMIT:
        raise DecodeAttentionLimitError(
            f"decode_attention: a context of {k.shape[1]} positions at "
            f"Dh = {dh} needs {need} B of shared memory per block, over "
            f"{SMEM_LIMIT} B")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, window: int = None) -> torch.Tensor:
    """q (B, H, Dh); k, v (B, C, H, Dh) already GQA-repeated, all float32
    or all bfloat16; pos (B,) integer absolute position of the current
    token -> (B, H, Dh) in q's dtype. Key j attends iff ``j <= pos[b]``
    (and ``j > pos[b] - window``). CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    pos = torch.as_tensor(pos, device=q.device)
    _check(q, k, v, pos, window)
    if all(t.device.type == "cpu" for t in (q, k, v, pos)):
        return ref.decode_attention(q, k, v, pos, window)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, pos)):
        raise ValueError("decode_attention: operands must lie on one CUDA "
                         "device")
    if not (q.dtype == k.dtype == v.dtype) or \
            str(q.dtype) not in build.DTYPE_CODES:
        raise ValueError(f"decode_attention: q, k and v must all be float32 "
                         f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, h, dh = q.shape
    c = k.shape[1]
    if b * h >= 2 ** 31 or max(c, dh) * h * dh >= 2 ** 31:
        raise ValueError("decode_attention: shapes too large for 32-bit "
                         "block and row indices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    fn = build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                   out.data_ptr(), b, c, h, dh,
                   0 if window is None else int(window),
                   1.0 / math.sqrt(dh), build.DTYPE_CODES[str(q.dtype)],
                   torch.cuda.current_stream(q.device).cuda_stream),
                "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
