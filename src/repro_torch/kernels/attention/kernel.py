"""Decode attention over a gathered paged-KV context, a CUDA kernel for
Hopper (``csrc/decode_attention.cu``).

Replaces the TPU kernel ``repro/kernels/attention/decode.py::
decode_attention``, a (B, H) Pallas grid whose cell holds its (C, Dh) K
and V slab in VMEM with ``pos`` as a prefetched scalar. Bound by bytes:
only the K and V rows the mask admits need to be read. So the kernel walks
only ``[max(0, pos - window + 1), min(C - 1, pos)]`` of each (b, h), in
one pass with an online softmax, K and V rows read together as 16-byte
vectors, one warp a (b, h) with several rows in flight (:func:`route`
picks the vector, 16 bytes or as wide as Dh and the operands' alignment
allow, and the lanes a row takes). When the B H rows are too few to fill
the card, :func:`plan` splits the range into chunks, one warp each, and
the one that finishes last merges the chunks' partial softmax states in
chunk order (an integer ticket, no floating-point atomics): repeat runs
are byte-identical. An empty range (pos < 0, or a window wholly past the
context) gives the mean of V over all C rows, as the reference's all
-1e30 scores do.

The first design kept every score of the context in shared memory, so a
context whose scores did not fit the 227 KB a block may use was refused
with :class:`DecodeAttentionLimitError` on every device — C up to 57,000
fits at Dh = 128. The refusal keeps that measure (:func:`smem_bytes`),
so a call that runs on the CPU runs on the card too; the kernel itself
needs no shared memory.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from .. import build
from . import ref

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448

#: threads (and their warps) of the first design's block, in the refusal's
#: measure
THREADS = 256

#: the split (:func:`plan`), in work items, a (b, h) row's chunk each (a
#: warp): B H rows that fill the card unsplit (eight warps an SM of the
#: H100's 132), the items a split aims at (sixteen an SM: the kernel's
#: warps at 128 registers), chunk lengths a multiple of CHUNK_ALIGN rows,
#: and at least MIN_CHUNK_BYTES of K and V in a chunk (its partial state
#: is Dh + 2 floats, so the merge stays about 1% of the bytes or less)
FILL_ITEMS = 8 * 132
TARGET_ITEMS = 16 * 132
CHUNK_ALIGN = 32
MIN_CHUNK_BYTES = 64 * 1024
#: chunks a (b, h) at most: one warp merges them, a chunk a lane
MAX_CHUNKS = 32


class DecodeAttentionLimitError(ValueError):
    """The context bucket does not fit one block's shared memory."""


class Plan(NamedTuple):
    """The split of a call: ``chunks`` work items a (b, h), each taking
    ``rows`` rows of its admitted range (``chunks == 1``: no split)."""
    rows: int
    chunks: int


def smem_bytes(ctx: int, dh: int) -> int:
    """The refusal's measure: the shared memory of the first design's
    block (the C scores, q, the warp results and the per-thread partial
    column sums, all fp32). Contexts over :data:`SMEM_LIMIT` by it are
    refused, as they always were."""
    return 4 * (ctx + dh + THREADS // 32 + THREADS)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(B: int, C: int, H: int, Dh: int, dtype: torch.dtype,
         window: int = None) -> Plan:
    """How a call splits its contexts, a pure function of the shapes and
    the window (the same on every device). B H rows of at least FILL_ITEMS
    fill the card unsplit; fewer cut the longest range a row can admit,
    min(C, window) rows, into about TARGET_ITEMS / (B H) chunks, at most
    MAX_CHUNKS, each a multiple of CHUNK_ALIGN rows carrying at least
    MIN_CHUNK_BYTES of K and V."""
    pairs = B * H
    if pairs >= FILL_ITEMS:
        return Plan(C, 1)
    span = min(C, window) if window else C
    split = min(MAX_CHUNKS, -(-TARGET_ITEMS // pairs))
    row_bytes = 2 * Dh * dtype.itemsize
    least = _round_up(max(1, MIN_CHUNK_BYTES // row_bytes), CHUNK_ALIGN)
    rows = max(least, _round_up(-(-span // split), CHUNK_ALIGN))
    if rows >= span:
        return Plan(C, 1)
    return Plan(rows, -(-span // rows))


def chunk_ranges(C: int, pos: int, window, rows: int, chunks: int
                 ) -> Tuple[List[Tuple[int, int]], bool]:
    """The row ranges [lo, hi] of the chunks a (b, h) at ``pos`` walks, in
    chunk order, and whether its admitted range is empty (then all C rows
    at one weight) — ``chunk_range`` in the source. A chunk is ``rows``
    rows, or more where the range would take more than ``chunks``: an
    empty range's C rows, when the plan was sized over a window."""
    hi = min(pos, C - 1)
    lo = max(0, pos - window + 1) if window else 0
    empty = lo > hi
    if empty:
        lo, hi = 0, C - 1
    n = hi - lo + 1
    size = max(rows, -(-n // chunks))
    return [(lo + c * size, min(hi, lo + (c + 1) * size - 1))
            for c in range(-(-n // size))], empty


def slot_floats(dh: int) -> int:
    """Floats of a chunk's slot in the workspace: its Dh sums, its max and
    normalizer, padded to 16 bytes (``slot_floats`` in the source)."""
    return _round_up(dh + 2, 4)


def route(q, k, v) -> Tuple[int, int, int]:
    """The kernel a call takes, as (bytes a vector, lanes a row, vectors a
    lane): ``decode<T, V, lanes, vecs>`` with the widest vector V of 16, 8,
    4 or 2 bytes that divides a row of Dh elements and k's and v's
    addresses (q is read by scalar loads), the lanes the row's vectors
    fill, and two vectors a lane past 32; a row of more than 64 vectors
    takes slices of 64 (the source's header)."""
    size = k.element_size()
    row = q.shape[-1] * size
    vec = next(n for n in (16, 8, 4, 2) if n >= size and row % n == 0
               and k.data_ptr() % n == 0 and v.data_ptr() % n == 0)
    nv = row // vec
    if nv <= 32:
        return vec, max(4, 1 << (nv - 1).bit_length()), 1
    return vec, 32, 2


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


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, its argument types set once."""
    return entry(build.load("decode_attention"))


def entry(lib: ctypes.CDLL):
    """``decode_attention_launch`` of a library built from the kernel's
    source, its argument types set."""
    fn = lib.decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


#: (device index, raw stream, n) -> the n tickets of split launches on
#: that stream, one a (b, h); each launch leaves them at 0. A buffer is
#: never freed: a decode step captured as a CUDA graph (``serving.graphs``)
#: keeps the address it was captured with, and the capture stream made
#: its buffers in the eager step that precedes every capture, so a replay
#: and an eager call on another stream never share tickets.
_TICKETS = {}


def _tickets(index: int, stream: int, n: int) -> torch.Tensor:
    buf = _TICKETS.get((index, stream, n))
    if buf is None:
        buf = torch.zeros(n, dtype=torch.int32,
                          device=torch.device("cuda", index))
        _TICKETS[(index, stream, n)] = buf
    return buf


def run(fn, q, k, v, pos, window=None) -> torch.Tensor:
    """Launch ``fn`` (:func:`entry` of a library built from the kernel's
    source) on checked CUDA operands; the wrapper's launch, which counts
    nothing."""
    b, h, dh = q.shape
    c = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    vec, lanes, vecs = route(q, k, v)
    rows, chunks = plan(b, c, h, dh, q.dtype, window)
    index = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    parts = tickets = None
    if chunks > 1:
        parts = torch.empty(b * h * chunks * slot_floats(dh),
                            dtype=torch.float32, device=q.device)
        tickets = _tickets(index, stream, b * h)
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                   out.data_ptr(), 0 if parts is None else parts.data_ptr(),
                   0 if tickets is None else tickets.data_ptr(), b, c, h, dh,
                   0 if window is None else int(window),
                   1.0 / math.sqrt(dh), build.DTYPE_CODES[str(q.dtype)],
                   vec, lanes, vecs, rows, chunks, stream), "decode_attention")
    return out


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
    out = run(_entry(), q, k, v, pos, window)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
