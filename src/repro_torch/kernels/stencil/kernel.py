"""2-D stencils with a constant-0 boundary, one stage (``stencil2d``) or a
fused chain of stages (``stencil2d_chain``), as one CUDA kernel for Hopper
(``csrc/stencil.cu``).

Replace the TPU kernels ``repro/kernels/stencil/kernel.py::stencil2d``
and ``::stencil2d_chain``, which read a padded copy of the field in row
slabs whose height divides H, with static offsets. Here persistent blocks
walk 2-D output tiles; a tile's slab (the tile with a halo of R, the sum
of the stages' radii) lands in shared memory by a TMA box load whose
out-of-bounds fill is the boundary (:func:`route` ``"tma"``, a field whose
rows are 16-byte aligned) or by zero-filling ``cp.async`` copies
(``"cp.async"``, any other field), the next tile's slab in flight while
this one computes;
every stage runs there, zeroing the positions outside the field between
stages, so intermediates never reach device memory. Stages of radius at
most 2 with distinct offsets run as dense weight windows in registers
(:func:`tap_table`). The offsets travel as a tap table passed by value (at
most :data:`MAX_TAPS` taps over at most :data:`MAX_STAGES` stages), the
coefficients as a device vector. Bound by bytes: the field is read once
and the result written once, whatever the number of stages.

A table the kernel cannot take, or a halo whose slabs do not fit in
shared memory (or a TMA box) even at the smallest tile (:func:`plan`), is
refused with :class:`StencilLimitError` on every device, so a program that
runs on the CPU runs on the card too; nothing switches to the plain
version.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import build
from . import ref

#: ``kMaxTaps`` and ``kMaxStages`` of ``csrc/stencil.cu``
MAX_TAPS = 128
MAX_STAGES = 6

#: shared memory one block may use on Hopper (227 KB), and the most a
#: block may take for two to fit an SM (228 KB an SM, 1 KB a block kept)
SMEM_LIMIT = 232_448
TWO_BLOCKS = 233_472 // 2 - 1024

#: the block's strip grid (rows, columns): 8 warps of ``STRIP_ROWS`` rows,
#: 32 lanes of 4 columns. A single stage's output tile is the grid; a
#: chain's shrinks by the halo its first stage computes, so that every
#: stage takes one strip a thread. :data:`MIN_TILE` is the smallest tile
#: the plan shrinks to when the buffers do not fit.
TILE = (64, 128)
MIN_TILE = (4, 16)
#: ``kRS``, ``kGuard`` and ``kDense`` of the source
STRIP_ROWS = 8
GUARD = 32
DENSE = 25
#: the largest TMA box side, in elements
BOX_LIMIT = 256


class StencilLimitError(ValueError):
    """A stencil the kernels do not take: a tap table or halo too large
    (``stencil2d``, ``stencil2d_chain``), or a field that is not a
    contiguous, non-empty float32 field of the kernel's rank (the Fig.-19
    stars)."""


class _TapTable(ctypes.Structure):
    _fields_ = [("n_stages", ctypes.c_int),
                ("stage_end", ctypes.c_int * MAX_STAGES),
                ("radius", ctypes.c_int * MAX_STAGES),
                ("kind", ctypes.c_int * MAX_STAGES),
                ("di", ctypes.c_int * MAX_TAPS),
                ("dj", ctypes.c_int * MAX_TAPS),
                ("dense", (ctypes.c_int * DENSE) * MAX_STAGES)]


class _Geometry(ctypes.Structure):
    _fields_ = [("th", ctypes.c_int), ("tw", ctypes.c_int),
                ("x0", ctypes.c_int), ("y0", ctypes.c_int),
                ("pitch", ctypes.c_int), ("rows", ctypes.c_int),
                ("buf_floats", ctypes.c_int), ("n_slabs", ctypes.c_int),
                ("tiles_h", ctypes.c_int64), ("tiles_w", ctypes.c_int64)]


def radius(offsets) -> int:
    return max(max(abs(di), abs(dj)) for di, dj in offsets)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def geometry(tile, offsets_per_stage, n_slabs: int = 2) -> dict:
    """The slab of a ``tile`` (rows, columns) for these stages: the tile's
    first point at slab (y0, x0) = (R, R rounded up to 4), ``pitch``
    floats a row (a multiple of 4: the TMA box's width), ``rows`` rows
    loaded (the box's height), a buffer of ``buf_floats`` (8 slack rows a
    strip may read past), ``n_slabs`` slabs (two: the next tile's in
    flight; one: loaded after this tile's stages), ``n_bufs`` buffers (the
    slabs, and a work buffer for a chain) and the block's shared memory
    (``smem`` in the source's header)."""
    R = sum(radius(o) for o in offsets_per_stage)
    th, tw = tile
    x0 = _up(R, 4)
    pitch = _up(x0 + tw + R + 3, 4)
    rows = th + 2 * R
    buf = _up(pitch * (rows + STRIP_ROWS), 32)
    n_bufs = n_slabs + (len(offsets_per_stage) > 1)
    return {"th": th, "tw": tw, "x0": x0, "y0": R, "pitch": pitch,
            "rows": rows, "buf_floats": buf, "n_slabs": n_slabs,
            "n_bufs": n_bufs, "smem": 256 + n_bufs * (GUARD + buf) * 4}


def smem_bytes(tile, offsets_per_stage, n_slabs: int = 2) -> int:
    """Shared memory of one block at this tile (:func:`geometry`)."""
    return geometry(tile, offsets_per_stage, n_slabs)["smem"]


def _fits(g) -> bool:
    return g["smem"] <= SMEM_LIMIT and g["pitch"] <= BOX_LIMIT and \
        g["rows"] <= BOX_LIMIT


def layout(offsets_per_stage) -> dict:
    """The :func:`geometry` the kernel takes for these stages. The output
    tile is :data:`TILE` less the halo h its first stage computes (2h
    rows; h and h rounded up to 4 columns, then a multiple of 4), two rows
    shorter at a time while the block takes more than :data:`TWO_BLOCKS`
    (down to half the grid's rows), then its rows and its columns halved
    while the buffers exceed :data:`SMEM_LIMIT` or the slab a TMA box. Two
    slabs where they fit at :data:`MIN_TILE`; else one (no load in flight
    while a tile computes), so that a single stage takes a halo of up to
    112 and a chain a summed halo of up to 76. Raises :class:`StencilLimitError` for a table
    the kernel cannot take."""
    n_stages = len(offsets_per_stage)
    n_taps = sum(len(o) for o in offsets_per_stage)
    if not 1 <= n_stages <= MAX_STAGES:
        raise StencilLimitError(f"stencil: {n_stages} stages; the kernel "
                                f"takes 1 to {MAX_STAGES}")
    if any(len(o) == 0 for o in offsets_per_stage) or n_taps > MAX_TAPS:
        raise StencilLimitError(f"stencil: {n_taps} taps over {n_stages} "
                                f"stages; the kernel takes 1 to {MAX_TAPS} "
                                f"in all, at least one a stage")
    R = sum(radius(o) for o in offsets_per_stage)
    h = R - radius(offsets_per_stage[0])
    th0 = max(MIN_TILE[0], TILE[0] - 2 * h)
    tw0 = max(MIN_TILE[1], (TILE[1] - h - _up(h, 4)) // 4 * 4)
    for n_slabs in (2, 1):
        th, tw = th0, tw0
        while smem_bytes((th, tw), offsets_per_stage, n_slabs) > \
                TWO_BLOCKS and th - 2 >= TILE[0] // 2:
            th -= 2
        g = geometry((th, tw), offsets_per_stage, n_slabs)
        while not _fits(g) and (th, tw) != MIN_TILE:
            if th > MIN_TILE[0]:
                th = max(MIN_TILE[0], th // 2)
            else:
                tw = max(MIN_TILE[1], tw // 8 * 4)
            g = geometry((th, tw), offsets_per_stage, n_slabs)
        if _fits(g):
            return g
    raise StencilLimitError(
        f"stencil: a halo of {R} needs {g['smem']} B of shared memory (a "
        f"block has {SMEM_LIMIT}) and a {g['pitch']} x {g['rows']} slab (a "
        f"TMA box takes {BOX_LIMIT} a side) at the smallest {th} x {tw} "
        f"tile and one slab")


def plan(offsets_per_stage):
    """(rows, columns, shared-memory bytes) of the output tile the kernel
    takes for these stages (:func:`layout`). Raises
    :class:`StencilLimitError` for a table the kernel cannot take."""
    g = layout(offsets_per_stage)
    return g["th"], g["tw"], g["smem"]


def tap_table(offsets_per_stage) -> _TapTable:
    """The table the kernel takes: the offsets in stage order, each
    stage's end and radius, and its kind: 1 + r with the (2r+1)^2 dense
    window of tap indices (-1 where no tap lies, a position the kernel
    skips) for a radius r <= 2 whose offsets are distinct, else 0 (a loop
    over the taps)."""
    table = _TapTable()
    table.n_stages = len(offsets_per_stage)
    k = 0
    for s, offs in enumerate(offsets_per_stage):
        r = radius(offs)
        dense = len(set(offs)) == len(offs) and r <= 2
        table.kind[s] = 1 + r if dense else 0
        for p in range(DENSE):
            table.dense[s][p] = -1
        for di, dj in offs:
            table.di[k], table.dj[k] = int(di), int(dj)
            if dense:
                table.dense[s][(di + r) * (2 * r + 1) + dj + r] = k
            k += 1
        table.stage_end[s] = k
        table.radius[s] = r
    return table


def route(a: torch.Tensor) -> str:
    """The load route the kernel takes for field ``a``: ``"tma"`` where
    its rows are 16-byte aligned (W a multiple of 4, the base 16-byte
    aligned), else ``"cp.async"``. Chosen by the shape, never by a failed
    launch."""
    ok = a.shape[-1] % 4 == 0 and a.data_ptr() % 16 == 0
    return "tma" if ok else "cp.async"


def _launch(a, coeffs_per_stage, offsets_per_stage, what):
    g = layout(offsets_per_stage)
    if not a.is_cuda or a.dim() != 2 or a.dtype != torch.float32:
        raise ValueError(f"{what}: the field must be a 2-D float32 CUDA "
                         f"tensor, got {tuple(a.shape)} {a.dtype} on "
                         f"{a.device}")
    if not a.is_contiguous():
        raise ValueError(f"{what}: the field must be contiguous")
    coeffs = []
    for c, offs in zip(coeffs_per_stage, offsets_per_stage):
        c = torch.as_tensor(c, dtype=torch.float32, device=a.device)
        if c.numel() != len(offs):
            raise ValueError(f"{what}: {c.numel()} coefficients for "
                             f"{len(offs)} offsets")
        coeffs.append(c.reshape(-1))
    coeffs = torch.cat(coeffs).contiguous()
    H, W = a.shape
    th, tw = g["th"], g["tw"]
    geo = _Geometry(th, tw, g["x0"], g["y0"], g["pitch"], g["rows"],
                    g["buf_floats"], g["n_slabs"], -(-H // th), -(-W // tw))
    how = route(a)
    out = torch.empty_like(a)
    fn = build.load("stencil").stencil_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                           _Geometry, _TapTable,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(a.data_ptr(), coeffs.data_ptr(), out.data_ptr(), H, W,
                   geo, tap_table(offsets_per_stage), g["smem"],
                   int(how == "tma"),
                   torch.cuda.current_stream(a.device).cuda_stream), what)
    return out, how


def _stages(offsets_per_stage):
    return tuple(tuple((int(di), int(dj)) for di, dj in offs)
                 for offs in offsets_per_stage)


def stencil2d(a: torch.Tensor, coeffs, offsets) -> torch.Tensor:
    """out[p] = sum_k coeffs[k] * a[p + offsets[k]], constant-0 boundary,
    for an (H, W) field. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    stages = _stages([offsets])
    if a.device.type == "cpu":
        plan(stages)
        return ref.stencil2d(a, coeffs, stages[0])
    out, how = _launch(a, [coeffs], stages, "stencil2d")
    stencil2d.launches += 1
    stencil2d.routes[how] += 1
    return out


def stencil2d_chain(a: torch.Tensor, coeffs_per_stage,
                    offsets_per_stage) -> torch.Tensor:
    """The stages applied one after another, each with a constant-0
    boundary, fused into one kernel. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    stages = _stages(offsets_per_stage)
    if len(coeffs_per_stage) != len(stages):
        raise ValueError(f"stencil2d_chain: {len(coeffs_per_stage)} "
                         f"coefficient vectors for {len(stages)} stages")
    if a.device.type == "cpu":
        plan(stages)
        return ref.stencil2d_chain(a, coeffs_per_stage, stages)
    out, how = _launch(a, coeffs_per_stage, stages, "stencil2d_chain")
    stencil2d_chain.launches += 1
    stencil2d_chain.routes[how] += 1
    return out


stencil2d.launches = 0
stencil2d_chain.launches = 0
#: launches by load route (:func:`route`)
stencil2d.routes = Counter()
stencil2d_chain.routes = Counter()
