"""2-D stencils with a constant-0 boundary, one stage (``stencil2d``) or a
fused chain of stages (``stencil2d_chain``), as CUDA kernels for Hopper
(``csrc/stencil.cu``).

Replace the TPU kernels ``repro/kernels/stencil/kernel.py::stencil2d``
and ``::stencil2d_chain``, which read a padded copy of the field in row
slabs whose height divides H, with static offsets. Here each block owns
a 2-D output tile, loads it with a halo of R (the sum of the stages'
radii) into shared memory through predicated loads (no padded copy, any
H and W), and runs every stage there, zeroing the positions outside the
field between stages; intermediates never reach device memory. The
offsets travel as a tap table passed by value (at most :data:`MAX_TAPS`
taps over at most :data:`MAX_STAGES` stages), the coefficients as a
device vector. Bound by bytes: the field is read once and the result
written once, whatever the number of stages.

A table the kernel cannot take, or a halo whose slab does not fit in
shared memory even at the smallest tile (:func:`plan`), is refused with
:class:`StencilLimitError` on every device, so a program that runs on the
CPU runs on the card too; nothing switches to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from . import ref

#: ``kMaxTaps`` and ``kMaxStages`` of ``csrc/stencil.cu``
MAX_TAPS = 128
MAX_STAGES = 6

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448

#: the output tile (rows, columns) a block takes, and the smallest one the
#: wrapper shrinks it to when the halo'd slabs do not fit
TILE = (32, 128)
MIN_TILE = (8, 32)


class StencilLimitError(ValueError):
    """The tap table or the halo exceeds what the kernel takes."""


class _TapTable(ctypes.Structure):
    _fields_ = [("n_stages", ctypes.c_int),
                ("stage_end", ctypes.c_int * MAX_STAGES),
                ("radius", ctypes.c_int * MAX_STAGES),
                ("di", ctypes.c_int * MAX_TAPS),
                ("dj", ctypes.c_int * MAX_TAPS)]


def radius(offsets) -> int:
    return max(max(abs(di), abs(dj)) for di, dj in offsets)


def smem_bytes(tile, offsets_per_stage) -> int:
    """Shared memory of one block: the coefficient and offset tables, and
    one (tile + 2R)-sided slab, two for a chain (ping-pong between
    stages)."""
    R = sum(radius(o) for o in offsets_per_stage)
    th, tw = tile
    slabs = 1 if len(offsets_per_stage) == 1 else 2
    return 4 * (2 * MAX_TAPS + slabs * (th + 2 * R) * (tw + 2 * R))


def plan(offsets_per_stage):
    """(rows, columns, shared-memory bytes) of the tile the kernel takes for
    these stages: :data:`TILE`, its rows and then its columns halved while
    the slabs exceed :data:`SMEM_LIMIT`. Raises :class:`StencilLimitError`
    for a table the kernel cannot take."""
    n_stages = len(offsets_per_stage)
    n_taps = sum(len(o) for o in offsets_per_stage)
    if not 1 <= n_stages <= MAX_STAGES:
        raise StencilLimitError(f"stencil: {n_stages} stages; the kernel "
                                f"takes 1 to {MAX_STAGES}")
    if any(len(o) == 0 for o in offsets_per_stage) or n_taps > MAX_TAPS:
        raise StencilLimitError(f"stencil: {n_taps} taps over {n_stages} "
                                f"stages; the kernel takes 1 to {MAX_TAPS} "
                                f"in all, at least one a stage")
    th, tw = TILE
    while smem_bytes((th, tw), offsets_per_stage) > SMEM_LIMIT:
        if th > MIN_TILE[0]:
            th //= 2
        elif tw > MIN_TILE[1]:
            tw //= 2
        else:
            R = sum(radius(o) for o in offsets_per_stage)
            raise StencilLimitError(
                f"stencil: a halo of {R} needs "
                f"{smem_bytes((th, tw), offsets_per_stage)} B of shared "
                f"memory at the smallest {th} x {tw} tile; a block has "
                f"{SMEM_LIMIT}")
    return th, tw, smem_bytes((th, tw), offsets_per_stage)


def _launch(a, coeffs_per_stage, offsets_per_stage, what):
    th, tw, smem = plan(offsets_per_stage)
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
    table = _TapTable()
    table.n_stages = len(offsets_per_stage)
    k = 0
    for s, offs in enumerate(offsets_per_stage):
        for di, dj in offs:
            table.di[k], table.dj[k] = int(di), int(dj)
            k += 1
        table.stage_end[s] = k
        table.radius[s] = radius(offs)
    H, W = a.shape
    out = torch.empty_like(a)
    fn = build.load("stencil").stencil_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int,
                                           _TapTable, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(fn(a.data_ptr(), coeffs.data_ptr(), out.data_ptr(), H, W, th,
                   tw, table, smem,
                   torch.cuda.current_stream(a.device).cuda_stream), what)
    return out


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
    out = _launch(a, [coeffs], stages, "stencil2d")
    stencil2d.launches += 1
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
    out = _launch(a, coeffs_per_stage, stages, "stencil2d_chain")
    stencil2d_chain.launches += 1
    return out


stencil2d.launches = 0
stencil2d_chain.launches = 0
