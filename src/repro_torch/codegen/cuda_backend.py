"""The cuda backend: generated Triton grid kernels for SDFG map scopes.

Where the torch backend (``torch_backend``) structurally *interprets* map
scopes — vmap for mapped tasklets, Python loops otherwise, capped at
``SEQUENTIAL_TRIP_LIMIT`` — this backend lowers eligible DEVICE/PIPELINED
map scopes to a single generated GPU kernel, the way the paper's code
generator emits complete platform kernels from the dataflow IR. It is the
counterpart of the reference package's Pallas backend
(``repro/codegen/pallas_backend.py``) and keeps its analysis verbatim:

  * the grid comes from the map ranges (tile-counter parameters after
    MapTiling; every parameter of an untiled map);
  * each memlet's affine subset is factored by
    :func:`core.memlet.factor_subset` into a block shape + block
    coordinates over the grid parameters (:class:`GridSpec`). Intra-tile
    parameters widen index dimensions into the block one program holds;
    block-misaligned accesses (stencil halos) become element-addressed
    windows; a dimension the subset spans whole (a gemv row) is a
    per-iteration *window* the body reduces;
  * tasklet chains (MapFusion results) thread their intermediates through
    the program as local values;
  * wcr add/max/min outputs accumulate; two-phase scopes (a fused
    wcr producer -> consumer) accumulate first and consume after.

What differs from Pallas is the machine: a CUDA grid has no ordered steps
and no scratch carried from step to step. :func:`describe_kernel` traces
the chain (``codegen.vocab``) into a :class:`KernelDesc`, and
:func:`triton_source` prints it as Triton code in which

  * one program owns one point of the *kept* grid (the grid parameters
    some output is indexed by) and loops over the reduction grid steps
    inside, accumulating in fp32 registers — the Pallas scratch
    accumulator becomes a loop-carried value;
  * where the kept grid is too small to fill the card (a dot product's
    single output), the reduction steps split over a fixed number of
    programs that write partials, and a second kernel sums them in a fixed
    order — a deterministic two-stage reduction, no atomics;
  * a per-iteration window (a gemv row of 16,384 elements) is never held
    whole: the program streams it in power-of-two chunks with masks and
    accumulates the reduction in fp32;
  * the program computes its own addresses from ``tl.program_id`` and the
    static strides, and masks the ragged edge (partial tiles, power-of-two
    blocks wider than their tile, the written box of ``_stitch_results``)
    itself. Outputs are written into a copy of the container's prior
    contents: wcr outputs combine with it, other outputs write only their
    box — the reference's ``_stitch_results`` semantics.

Each generated kernel has a plain PyTorch version: :class:`GridProgram`
runs the reference kernel's block program over the grid in batches of
grid steps (whole-block where the torch probe proves the chain
elementwise, nested ``torch.func.vmap`` otherwise) — the counterpart of
Pallas interpret mode. The launcher takes it only for CPU tensors; a CUDA
tensor launches the generated kernel or raises.

These kernels are memory-bound: each reads its operands once and writes
its outputs once, at 3.35 TB/s on an H100.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import math
import os
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dtypes import ScheduleType, torch_dtype
from ..core.memlet import (BlockFactorError, SubsetFactorization,
                           eval_affine, factor_subset)
from ..core.sdfg import (MapEntry, MapExit, Scalar, SDFG, State, Stream,
                         Tasklet)
from ..core.symbolic import Expr
from ..transforms.map_tiling import normalize_tiling
from . import vocab
from .common import WCR_MODES, apply_wcr_at, wcr_combine, wcr_identity, \
    wcr_reduce
from .torch_backend import StateLowering, build_callable as _build_callable

#: annotation keys GridConversionPass writes and this backend consumes:
#: the derived :class:`GridSpec`, and the :class:`GridKernel` traced from it.
GRID_ANNOTATION = "grid"
KERNEL_ANNOTATION = "grid_kernel"


@dataclass(frozen=True)
class EdgeSpec:
    """One tasklet edge lowered to a grid-kernel operand."""
    conn: str
    data: str
    fact: SubsetFactorization
    scalar: bool = False                       # 0-d container, carried as (1,)
    wcr: Optional[str] = None                  # outputs only
    reduction: Tuple[str, ...] = ()            # grid params absent from index
    box: Tuple[Tuple[int, int], ...] = ()      # written element range per dim
    node: int = 0                              # owning tasklet (chain index)


@dataclass(frozen=True)
class WcrValueSpec:
    """One in-kernel reduction value (MapFusion's wcr mode): a
    tasklet->tasklet edge carrying ``wcr`` accumulates in the program
    across the ``reduction`` grid steps; the consumer side of the chain
    runs once, after the last step, with the finished value."""
    key: Tuple[int, str]            # (producer chain index, src connector)
    wcr: str
    dtype: str                      # numpy dtype name for the scratch
    reduction: Tuple[str, ...]      # grid params accumulated across steps
    kept_intra: Tuple[str, ...]     # intra-tile params addressing the value


@dataclass(frozen=True)
class GridSpec:
    """Complete derived grid-kernel description for one map scope."""
    kernel_name: str
    grid: Tuple[Tuple[str, int], ...]          # (param, size) in grid order
    block_params: Tuple[Tuple[str, int], ...]  # intra-tile params + extents
    inputs: Tuple[EdgeSpec, ...]
    outputs: Tuple[EdgeSpec, ...]
    tasklet_labels: Tuple[str, ...] = ()       # topo-ordered chain labels
    #: (intra param, counter param, tile, extent) for non-divisible tiles
    partial_tiles: Tuple[Tuple[str, str, int, int], ...] = ()
    #: tasklet->tasklet edges inside the scope (fused-DAG intermediates
    #: threaded as in-kernel values; the cost model charges on-chip bytes)
    internal_edges: int = 0
    #: in-kernel wcr edges (two-phase accumulate+consume kernels)
    internal_wcr: Tuple[WcrValueSpec, ...] = ()
    #: chain indices of the consumer phase (run after the last reduction
    #: step)
    phase2_nodes: Tuple[int, ...] = ()


def _scalar_fact() -> SubsetFactorization:
    from ..core.symbolic import Expr
    return SubsetFactorization((1,), (Expr.const(0),), (0,))


def operand_key(es: EdgeSpec) -> Tuple:
    """Dedup key for input operands: everything block-relevant. Windows
    are per-edge (sliced in-kernel) and deliberately excluded, so a
    stencil's five halo reads of one container share one operand when
    their blocks coincide."""
    return (es.data, es.scalar, es.fact.block_shape,
            tuple(repr(e) for e in es.fact.index_exprs),
            es.fact.squeeze_dims, es.fact.param_dims)


def unique_operands(spec: GridSpec) -> List[EdgeSpec]:
    """Representative EdgeSpec per deduplicated input operand."""
    seen, reps = {}, []
    for es in spec.inputs:
        k = operand_key(es)
        if k not in seen:
            seen[k] = len(reps)
            reps.append(es)
    return reps


def _tasklet_chain(state: State, entry: MapEntry, scopes) -> List[Tasklet]:
    """Topologically-ordered tasklets of the scope; raises when the scope
    holds anything else (nested maps, access nodes, ...)."""
    inner = [n for n in scopes.get(entry, []) if not isinstance(n, MapExit)]
    if not inner or not all(isinstance(n, Tasklet) for n in inner):
        raise BlockFactorError(
            f"map {entry.map.label!r}: grid codegen requires a tasklet-only "
            f"scope, got {[type(n).__name__ for n in inner]}")
    inner_set = set(inner)
    return [n for n in state.topological_nodes() if n in inner_set]


def _output_box(fact: SubsetFactorization, grid: Dict[str, Tuple[int, int]],
                label: str, dim_sizes: Tuple[int, ...],
                valid_extents: Dict[str, int]) -> Tuple[Tuple[int, int], ...]:
    """Element-range box written by an output across the whole grid,
    clamped to the container and to the *valid* extent of partial tiles;
    also verifies full coverage inside the box (each dim's block index
    must be a constant or ``param + const`` with a param used by no other
    dim; a window must step by exactly its length)."""
    box = []
    seen_params = set()
    win = {d: (e, ln) for d, e, ln in fact.windows}
    pd_inv = {d: q for q, d in fact.param_dims}
    for d, bs in enumerate(fact.block_shape):
        dim_sz = dim_sizes[d] if d < len(dim_sizes) else bs
        if d in win:
            e, ln = win[d]
            c0, syms = 0, {}
            for mono, c in e.terms.items():
                if mono == ():
                    c0 = int(c)
                else:
                    syms[mono[0][0]] = int(c)
            if not syms:
                box.append((c0, min(c0 + ln, dim_sz)))
                continue
            if len(syms) > 1 or set(syms) & seen_params:
                raise BlockFactorError(
                    f"output of {label!r}: window dim {d} start {e} not "
                    f"contiguously covered across the grid")
            (g, cg), = syms.items()
            if cg != ln:
                raise BlockFactorError(
                    f"output of {label!r}: window dim {d} steps by {cg} "
                    f"but spans {ln} elements")
            seen_params.add(g)
            n = grid[g][1]
            hi = c0 + (n - 1) * ln + ln
            if pd_inv.get(d) in valid_extents:
                hi = min(hi, c0 + valid_extents[pd_inv[d]])
            box.append((c0, min(hi, dim_sz)))
            continue
        e = fact.index_exprs[d]
        c0 = 0
        syms = {}
        for mono, c in e.terms.items():
            if mono == ():
                c0 = int(c)
            else:
                syms[mono[0][0]] = c
        if not syms:
            span = valid_extents.get(pd_inv.get(d), bs)
            box.append((c0 * bs, min(c0 * bs + span, dim_sz)))
            continue
        if len(syms) > 1 or set(syms) & seen_params:
            raise BlockFactorError(
                f"output of {label!r}: dim {d} index {e} not contiguously "
                f"covered across the grid")
        (g, cg), = syms.items()
        if cg != 1:
            raise BlockFactorError(
                f"output of {label!r}: dim {d} strides blocks by {cg}")
        seen_params.add(g)
        n = grid[g][1]
        hi = (c0 + n - 1) * bs + bs
        if pd_inv.get(d) in valid_extents:
            hi = min(hi, c0 * bs + valid_extents[pd_inv[d]])
        box.append((c0 * bs, min(hi, dim_sz)))
    return tuple(box)


def analyze_map_scope(sdfg: SDFG, state: State, entry: MapEntry,
                      scopes=None, env: Optional[Dict[str, int]] = None
                      ) -> GridSpec:
    """Derive a :class:`GridSpec` for a map scope, or raise
    :class:`BlockFactorError` when the scope must fall back to the
    structural interpreter."""
    m = entry.map
    if m.schedule not in (ScheduleType.PIPELINED, ScheduleType.DEVICE):
        raise BlockFactorError(
            f"map {m.label!r}: schedule {m.schedule.value} is not a grid")
    scopes = scopes if scopes is not None else state.scope_children()
    chain = _tasklet_chain(state, entry, scopes)
    chain_index = {t: i for i, t in enumerate(chain)}
    env = dict(sdfg.symbol_values) if env is None else dict(env)

    tiling = normalize_tiling(m.annotations.get("tiling", {}))
    grid_params: Dict[str, Tuple[int, int]] = {}
    block_params: Dict[str, int] = {}
    partials: List[Tuple[str, str, int, int]] = []
    valid_extents: Dict[str, int] = {}
    for p, r in zip(m.params, m.ranges):
        try:
            start, size = r.start.subs(env).as_int(), r.size.subs(env).as_int()
        except Exception as exc:
            raise BlockFactorError(
                f"map {m.label!r}: dynamic range for {p}") from exc
        if size < 1:
            raise BlockFactorError(f"map {m.label!r}: empty range for {p}")
        if p in tiling and size > 1:
            info = tiling[p]
            if start != 0 or size != int(info["tile"]):
                raise BlockFactorError(
                    f"map {m.label!r}: tile param {p} range [{start}, "
                    f"+{size}) disagrees with tiling annotation "
                    f"{info['tile']}")
            block_params[p] = size
            ext = info.get("extent")
            if ext is not None:
                valid_extents[p] = int(ext)
                if int(ext) % size:
                    ctr = info.get("counter")
                    if ctr is None or ctr not in m.params:
                        raise BlockFactorError(
                            f"map {m.label!r}: partial tile {p} has no "
                            f"counter to mask against")
                    partials.append((p, ctr, size, int(ext)))
        else:
            grid_params[p] = (start, size)
    if not grid_params:
        raise BlockFactorError(f"map {m.label!r}: no grid parameters")
    partial_qs = {q for q, _, _, _ in partials}
    partial_counters = {c for _, c, _, _ in partials}

    def _factor(memlet):
        if memlet.dynamic:
            raise BlockFactorError(f"dynamic memlet {memlet}")
        if memlet.data not in sdfg.arrays:
            raise BlockFactorError(f"no descriptor for {memlet.data!r}")
        desc = sdfg.arrays[memlet.data]
        if isinstance(desc, Stream):
            raise BlockFactorError(f"stream operand {memlet.data!r}")
        if isinstance(desc, Scalar) or not getattr(desc, "shape", ()):
            return _scalar_fact(), True, (1,)
        fact = factor_subset(memlet.subset, desc.shape, grid_params,
                             block_params, env, allow_windows=True)
        from ..core.symbolic import Expr
        dim_sizes = tuple(int(Expr.wrap(s).evaluate(env))
                          for s in desc.shape)
        # a window whose start depends on a partial tile's counter would
        # clamp-shift at the boundary block: fall back instead
        for d, expr, ln in fact.windows:
            if expr.free_symbols & partial_counters:
                raise BlockFactorError(
                    f"window on {memlet.data!r} dim {d} rides the partial "
                    f"tile counter {sorted(expr.free_symbols & partial_counters)}")
            pdq = {dd: q for q, dd in fact.param_dims}.get(d)
            if pdq in partial_qs:
                raise BlockFactorError(
                    f"window on {memlet.data!r} dim {d} spans partial "
                    f"tile param {pdq}")
        return fact, False, tuple(dim_sizes)

    inputs = []
    out_edge_list = []  # (chain index, edge)
    internal_vals = set()  # distinct in-kernel values: a fan-out producer
    wcr_edge_list = []  # (producer chain index, edge) for in-kernel wcr
    for ti, t in enumerate(chain):    # value is stored once, not per reader
        for e in state.in_edges(t):
            if e.dst_conn is None or e.memlet.data is None:
                continue
            if e.src in chain_index:
                # per-iteration intermediate, threaded as a local value;
                # wcr edges additionally accumulate across the reduction
                # steps (two-phase kernel, analyzed below)
                if e.memlet.wcr is not None:
                    wcr_edge_list.append((chain_index[e.src], e))
                internal_vals.add((chain_index[e.src], e.src_conn))
                continue
            fact, scalar, _ = _factor(e.memlet)
            inputs.append(EdgeSpec(e.dst_conn, e.memlet.data, fact, scalar,
                                   node=ti))
        for e in state.out_edges(t):
            if e.dst in chain_index:
                continue
            if e.memlet.data is None:
                continue
            out_edge_list.append((ti, e))

    if not out_edge_list:
        raise BlockFactorError(f"map {m.label!r}: no kernel outputs")
    used_any: List[str] = []
    outs_raw = []
    for ti, e in out_edge_list:
        if e.memlet.wcr is not None and e.memlet.wcr not in WCR_MODES:
            raise BlockFactorError(
                f"map {m.label!r}: wcr {e.memlet.wcr!r} unsupported")
        fact, scalar, dim_sizes = _factor(e.memlet)
        box = _output_box(fact, grid_params, m.label, dim_sizes,
                          valid_extents)
        used = set()
        for ex in fact.index_exprs:
            used |= ex.free_symbols
        for _, wexpr, _ in fact.windows:
            used |= wexpr.free_symbols
        if e.memlet.wcr is None:
            # a partial tile lane absent from a plain output would make the
            # garbage lane the "last write": fall back
            pd = dict(fact.param_dims)
            for q in partial_qs:
                if q not in pd:
                    raise BlockFactorError(
                        f"map {m.label!r}: partial tile param {q} absent "
                        f"from plain output {e.memlet.data!r}")
        for p in m.params:
            if p in used and p in grid_params and p not in used_any:
                used_any.append(p)
        outs_raw.append((ti, e, fact, scalar, box, used))

    # grid order: output-indexing params first (original order), reduction
    # params innermost so scratch accumulators stay block-resident.
    order = [p for p in m.params if p in grid_params and p in used_any]
    order += [p for p in m.params if p in grid_params and p not in used_any]
    outputs = []
    for ti, e, fact, scalar, box, used in outs_raw:
        reduction = tuple(p for p in order if p not in used)
        if reduction and fact.windows:
            raise BlockFactorError(
                f"map {m.label!r}: windowed output {e.memlet.data!r} "
                f"cannot host a scratch reduction")
        # every reduction dim must iterate inside every used dim
        max_used = max((order.index(p) for p in order if p in used),
                       default=-1)
        if any(order.index(p) < max_used for p in reduction):
            raise BlockFactorError(
                f"map {m.label!r}: reduction params {reduction} cannot be "
                f"ordered innermost for output {e.memlet.data!r}")
        if e.memlet.wcr is None and reduction and not getattr(
                chain[ti], "side_effect_free", True):
            raise BlockFactorError(f"map {m.label!r}: side-effecting tasklet")
        outputs.append(EdgeSpec(e.src_conn, e.memlet.data, fact, scalar,
                                e.memlet.wcr, reduction, box, node=ti))

    internal_wcr: Tuple[WcrValueSpec, ...] = ()
    phase2_nodes: Tuple[int, ...] = ()
    if wcr_edge_list:
        internal_wcr, phase2_nodes = _analyze_internal_wcr(
            sdfg, state, m, chain, chain_index, wcr_edge_list, grid_params,
            block_params, order, used_any, inputs, outputs, out_edge_list)

    return GridSpec(
        kernel_name=m.label,
        grid=tuple((p, grid_params[p][1]) for p in order),
        block_params=tuple((p, block_params[p]) for p in m.params
                           if p in block_params),
        inputs=tuple(inputs), outputs=tuple(outputs),
        tasklet_labels=tuple(t.label for t in chain),
        partial_tiles=tuple(partials),
        internal_edges=len(internal_vals),
        internal_wcr=internal_wcr, phase2_nodes=phase2_nodes)


def _analyze_internal_wcr(sdfg, state, m, chain, chain_index, wcr_edge_list,
                          grid_params, block_params, order, used_any,
                          inputs, outputs, out_edge_list
                          ) -> Tuple[Tuple[WcrValueSpec, ...],
                                     Tuple[int, ...]]:
    """Legality analysis for in-kernel wcr edges (MapFusion's reduction
    mode) and derivation of the two-phase kernel structure; raises
    :class:`BlockFactorError` when the shape cannot be expressed, falling
    back to the structural interpreter (whose sequential/phased-vmap
    lowerings are always correct for these scopes)."""
    pset = set(m.params)
    used_sets = []
    for src_ti, e in wcr_edge_list:
        if e.memlet.wcr not in WCR_MODES:
            raise BlockFactorError(
                f"map {m.label!r}: in-kernel wcr {e.memlet.wcr!r} "
                f"unsupported")
        if e.memlet.subset is None:
            raise BlockFactorError(
                f"map {m.label!r}: in-kernel wcr edge without a subset")
        used = set()
        for r in e.memlet.subset:
            used |= ((r.start.free_symbols | r.stop.free_symbols) & pset)
        used_sets.append(used)
    kept = used_sets[0]
    if any(u != kept for u in used_sets):
        raise BlockFactorError(
            f"map {m.label!r}: in-kernel wcr edges disagree on reduction "
            f"parameters")
    kept_grid = kept & set(grid_params)
    kept_intra = kept & set(block_params)
    reduction = tuple(p for p in order if p not in kept)
    red_intra = {q for q in block_params if q not in kept_intra}
    if not reduction:
        raise BlockFactorError(
            f"map {m.label!r}: in-kernel wcr with no grid reduction step")
    if kept_grid - set(used_any):
        raise BlockFactorError(
            f"map {m.label!r}: reduction-addressing params "
            f"{sorted(kept_grid - set(used_any))} absent from every output")

    # consumer phase: everything downstream of a wcr edge
    phase2 = set()
    work = [chain_index[e.dst] for _, e in wcr_edge_list]
    while work:
        ti = work.pop()
        if ti in phase2:
            continue
        phase2.add(ti)
        for e in state.out_edges(chain[ti]):
            if e.dst in chain_index:
                work.append(chain_index[e.dst])
    for ti, t in enumerate(chain):
        if ti in phase2:
            continue
        for e in state.out_edges(t):
            if (e.dst in chain_index and chain_index[e.dst] in phase2
                    and e.memlet.wcr is None):
                raise BlockFactorError(
                    f"map {m.label!r}: plain producer->consumer edge "
                    f"alongside an in-kernel wcr edge")
    for ti, e in out_edge_list:
        if ti not in phase2:
            raise BlockFactorError(
                f"map {m.label!r}: reduction producer also writes through "
                f"the exit")
    red_syms = set(reduction) | red_intra
    for es in outputs:
        if es.wcr is not None:
            raise BlockFactorError(
                f"map {m.label!r}: wcr output downstream of an in-kernel "
                f"reduction")
        _check_phase_free(m, es, red_syms, red_intra, "output")
    for es in inputs:
        if es.node in phase2:
            _check_phase_free(m, es, red_syms, red_intra, "consumer input")

    specs, seen = [], set()
    for src_ti, e in wcr_edge_list:
        key = (src_ti, e.src_conn)
        if key in seen:
            continue
        seen.add(key)
        desc = sdfg.arrays.get(e.memlet.data)
        if desc is None:
            raise BlockFactorError(
                f"map {m.label!r}: no descriptor for in-kernel wcr "
                f"intermediate {e.memlet.data!r}")
        specs.append(WcrValueSpec(
            key=key, wcr=e.memlet.wcr,
            dtype=str(desc.dtype.np_dtype.__name__
                      if hasattr(desc.dtype.np_dtype, "__name__")
                      else desc.dtype.np_dtype),
            reduction=reduction,
            kept_intra=tuple(q for q in block_params if q in kept_intra)))
    return tuple(specs), tuple(sorted(phase2))


def _check_phase_free(m, es: EdgeSpec, red_syms, red_intra, what: str):
    """A consumer-phase memlet must not address a reduction parameter —
    the consumer runs only on the last reduction step."""
    syms = set()
    for ex in es.fact.index_exprs:
        syms |= ex.free_symbols
    for _, wexpr, _ in es.fact.windows:
        syms |= wexpr.free_symbols
    if syms & red_syms or {q for q, _ in es.fact.param_dims} & red_intra:
        raise BlockFactorError(
            f"map {m.label!r}: {what} {es.data!r} addresses a reduction "
            f"parameter")



# ---------------------------------------------------------------------------
# Kernel description: the GridSpec plus the traced tasklet chain
# ---------------------------------------------------------------------------

#: elements one program holds of a streamed window, across its tile: the
#: window is read in chunks of ``max(16, CHUNK_ELEMS // tile elements)``.
CHUNK_ELEMS = 4096

#: programs a two-stage reduction spreads its steps over (4 per SM of the
#: H100's 132): below this many kept-grid programs the reduction splits.
FILL_PROGRAMS = 4 * 132


class KernelRefusal(BlockFactorError):
    """The scope's shape is grid-factorable but its tasklet chain, or the
    way its outputs reduce, has no lowering to a generated Triton kernel.
    A typed compile-time refusal: ``GridConversionPass`` records it in
    ``report["grid_fallbacks"]`` like every :class:`BlockFactorError`."""


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass(frozen=True)
class Access:
    """How one edge addresses its container inside a program: per
    container dimension an element base (affine over the 0-based grid
    parameters) plus the in-program offset along it — a tile lane
    (``("tile", q)``), a window axis (``("window", k)``) or none."""
    container: str
    scalar: bool
    shape: Tuple[int, ...]
    dims: Tuple[Tuple[Expr, str, object], ...]
    window: Tuple[int, ...]          # window axis lengths, in dim order

    @property
    def strides(self) -> Tuple[int, ...]:
        out, acc = [], 1
        for n in reversed(self.shape):
            out.append(acc)
            acc *= n
        return tuple(reversed(out))


def _access(sdfg: SDFG, es: EdgeSpec, env) -> Access:
    if es.scalar:
        return Access(es.data, True, (1,), (), ())
    desc = sdfg.arrays[es.data]
    shape = tuple(int(Expr.wrap(s).evaluate(env)) for s in desc.shape)
    fact = es.fact
    win = {d: (e, ln) for d, e, ln in fact.windows}
    pd = {d: q for q, d in fact.param_dims}
    dims, window = [], []
    for d, bs in enumerate(fact.block_shape):
        if d in win:
            base, length = win[d]
        else:
            base, length = fact.index_exprs[d] * bs, bs
        if d in pd:
            dims.append((base, "tile", pd[d]))
        elif length > 1:
            dims.append((base, "window", length))
            window.append(length)
        else:
            dims.append((base, "fixed", None))
    return Access(es.data, False, shape, tuple(dims), tuple(window))


@dataclass
class OutputDesc:
    access: Access
    wcr: Optional[str]
    box: Tuple[Tuple[int, int], ...]
    value: object                     # Traced node (or a Python number)
    absent: Tuple[int, ...]           # tile axes the output is not indexed by


@dataclass
class KernelDesc:
    """One generated grid kernel, everything static: the program's tile
    (block params in order with their tiles and power-of-two blocks), the
    kept grid (one program per point) and the reduction grid (looped
    inside), every edge's addressing, and the traced chain."""
    name: str
    tiles: Tuple[Tuple[str, int, int], ...]        # (q, tile, BLOCK)
    kept: Tuple[Tuple[str, int], ...]
    reduction: Tuple[Tuple[str, int], ...]
    partial: Dict[str, Tuple[str, int, int]]       # q -> (counter, ts, ext)
    loads: Tuple[Access, ...]                      # per input edge
    outputs: Tuple[OutputDesc, ...]
    internal: Tuple[Tuple[str, object, Tuple[int, ...]], ...] = ()
    splits: int = 1                                # two-stage reduction
    #: a row program (:class:`_RowEmitter`): one program per map iteration
    row: bool = False
    #: the Triton function's name, set from its code by :func:`grid_kernel`
    fn: Optional[str] = None

    @property
    def n_kept(self) -> int:
        return math.prod(n for _, n in self.kept)

    @property
    def n_reduction(self) -> int:
        return math.prod(n for _, n in self.reduction)

    @property
    def n_lanes(self) -> int:
        return math.prod(t for _, t, _ in self.tiles)

    def axis(self, q: str) -> int:
        return [t[0] for t in self.tiles].index(q)


def _chain_of(state: State, spec: GridSpec) -> List[Tasklet]:
    by_label = {n.label: n for n in state.nodes if isinstance(n, Tasklet)}
    return [by_label[lbl] for lbl in spec.tasklet_labels]


def _run_chain(state: State, chain: List[Tasklet], spec: GridSpec,
               opvals, nodes=None, local=None) -> Tuple[dict, list]:
    """Run the topo-ordered chain (or the ``nodes`` subset of it) with
    container operands from ``opvals`` (keyed by input-edge index) and
    tasklet->tasklet values as locals; the shared core of the reference's
    ``_chain_runner`` and ``_phased_runners``. Returns the locals and the
    per-output results."""
    chain_index = {t: i for i, t in enumerate(chain)}
    local = {} if local is None else local
    results = [None] * len(spec.outputs)
    res_of = {}
    for oi, es in enumerate(spec.outputs):
        res_of.setdefault(es.node, []).append((es.conn, oi))
    for ti in (range(len(chain)) if nodes is None else nodes):
        t = chain[ti]
        kwargs = {es.conn: opvals[i] for i, es in enumerate(spec.inputs)
                  if es.node == ti}
        for e in state.in_edges(t):
            if e.src in chain_index:
                kwargs[e.dst_conn] = local[(chain_index[e.src], e.src_conn)]
        r = t.fn(**kwargs)
        int_out = [e.src_conn for e in state.out_edges(t)
                   if e.dst in chain_index]
        conns = int_out + [c for c, _ in res_of.get(ti, ())]
        if not isinstance(r, dict):
            if isinstance(r, tuple):
                r = dict(zip(list(getattr(t, "outputs", ())) or conns, r))
            else:
                r = {conns[0]: r}
        for conn in int_out:
            local.setdefault((ti, conn), r[conn])  # an acc value stays put
        for conn, oi in res_of.get(ti, ()):
            results[oi] = r[conn]
    return local, results


def describe_kernel(sdfg: SDFG, state: State, spec: GridSpec,
                    env: Optional[Dict[str, int]] = None) -> KernelDesc:
    """Trace the scope's chain into a :class:`KernelDesc`, or raise
    :class:`KernelRefusal` when it has no Triton lowering."""
    env = dict(sdfg.symbol_values) if env is None else dict(env)
    chain = _chain_of(state, spec)
    bp = dict(spec.block_params)
    tiles = tuple((q, n, max(2, _pow2(n))) for q, n in spec.block_params)
    block_order = [q for q, _ in spec.block_params]
    loads = tuple(_access(sdfg, es, env) for es in spec.inputs)
    traced = {i: vocab.Traced("load", attr=i, window=a.window)
              for i, a in enumerate(loads)}

    def _trace(fn):
        try:
            return fn()
        except vocab.TraceError as exc:
            raise KernelRefusal(f"map {spec.kernel_name!r}: {exc}") from exc
        except (TypeError, AttributeError, ValueError, IndexError,
                RuntimeError, KeyError) as exc:
            raise KernelRefusal(
                f"map {spec.kernel_name!r}: tasklet body is not traceable: "
                f"{type(exc).__name__}: {exc}") from exc

    internal = ()
    if spec.internal_wcr:
        p2 = set(spec.phase2_nodes)
        p1_nodes = [ti for ti in range(len(chain)) if ti not in p2]
        local, _ = _trace(lambda: _run_chain(state, chain, spec, traced,
                                             p1_nodes))
        accs = {}
        specs = []
        for k, w in enumerate(spec.internal_wcr):
            val = local[w.key]
            if isinstance(val, vocab.Traced) and val.window:
                raise KernelRefusal(
                    f"map {spec.kernel_name!r}: in-kernel wcr value carries "
                    f"a window {val.window}")
            kept_axes = tuple(block_order.index(q) for q in w.kept_intra)
            specs.append((w.wcr, val, kept_axes))
            accs[w.key] = vocab.Traced("acc", attr=k)
        internal = tuple(specs)
        _, results = _trace(lambda: _run_chain(
            state, chain, spec, traced, sorted(p2), dict(accs)))
        kept_names = [p for p, _ in spec.grid
                      if p not in set(spec.internal_wcr[0].reduction)]
    else:
        _, results = _trace(lambda: _run_chain(state, chain, spec, traced))
        reductions = {es.reduction for es in spec.outputs}
        if len(reductions) > 1:
            raise KernelRefusal(
                f"map {spec.kernel_name!r}: outputs reduce over different "
                f"grid parameters {sorted(reductions)}")
        red = reductions.pop()
        kept_names = [p for p, _ in spec.grid if p not in red]

    outputs = []
    for es, val in zip(spec.outputs, results):
        acc = _access(sdfg, es, env)
        win = val.window if isinstance(val, vocab.Traced) else ()
        if win and win != acc.window:
            raise KernelRefusal(
                f"map {spec.kernel_name!r}: value window {win} does not "
                f"match the window {acc.window} of output {es.data!r}")
        if acc.window and es.reduction:
            raise KernelRefusal(
                f"map {spec.kernel_name!r}: windowed output {es.data!r} "
                f"accumulated over the grid")
        if isinstance(val, (bool, np.bool_)) or not isinstance(
                val, (vocab.Traced, int, float)):
            raise KernelRefusal(
                f"map {spec.kernel_name!r}: output {es.data!r} is "
                f"{type(val).__name__}, not a traced value or number")
        pd = dict(es.fact.param_dims)
        absent = tuple(i for i, q in enumerate(block_order) if q not in pd)
        outputs.append(OutputDesc(acc, es.wcr, es.box, val, absent))

    kept = tuple((p, n) for p, n in spec.grid if p in kept_names)
    reduction = tuple((p, n) for p, n in spec.grid if p not in kept_names)
    partial = {q: (c, ts, ext) for q, c, ts, ext in spec.partial_tiles}
    if any(_uses_row_ops(o.value) for o in outputs):
        # a row body (@ of windows, iota, softmax): one program per map
        # iteration, so nothing may reduce across iterations
        if internal or reduction or any(o.absent or o.wcr for o in outputs):
            raise KernelRefusal(
                f"map {spec.kernel_name!r}: a row body (@ of windows, iota "
                f"or softmax) whose outputs reduce across iterations")
        return KernelDesc(spec.kernel_name, tiles, kept, reduction, partial,
                          loads, tuple(outputs), row=True)
    n_kept = math.prod(n for _, n in kept)
    n_red = math.prod(n for _, n in reduction)
    splits = 1
    if (not internal and n_red > 1 and n_kept < FILL_PROGRAMS
            and all(o.wcr in WCR_MODES for o in outputs)):
        splits = min(n_red, -(-FILL_PROGRAMS // n_kept))
    return KernelDesc(spec.kernel_name, tiles, kept, reduction, partial,
                      loads, tuple(outputs), internal,
                      splits if splits > 1 else 1)


def window_chunk(tile_elems: int) -> int:
    """Window elements a program streams per step, beside a tile of
    ``tile_elems`` (power-of-two block) elements."""
    return max(16, CHUNK_ELEMS // tile_elems)


def program_block(spec: GridSpec, es: EdgeSpec) -> Tuple[int, ...]:
    """The part of an edge's block one program holds at a time: its tile
    lanes (power-of-two blocks) times, for a windowed edge, one streamed
    chunk of the window (:func:`window_chunk`)."""
    blocks = {q: max(2, _pow2(n)) for q, n in spec.block_params}
    pd = {d: q for q, d in es.fact.param_dims}
    eff = es.fact.effective_shape()
    tile = tuple(blocks[pd[d]] for d in range(len(eff)) if d in pd)
    window = math.prod(b for d, b in enumerate(eff) if d not in pd)
    if window > 1:
        tile += (min(_pow2(window), window_chunk(math.prod(blocks.values()))),)
    return tile


# ---------------------------------------------------------------------------
# Triton source
# ---------------------------------------------------------------------------

_BIN = {"add": "+", "sub": "-", "mul": "*", "div": "/", "lt": "<",
        "le": "<=", "gt": ">", "ge": ">="}
_FINFO32 = torch.finfo(torch.float32)
_IDENT = {"add": "0.0", "max": repr(float(_FINFO32.min)),
          "min": repr(float(_FINFO32.max))}


def _combine(wcr: str, a: str, b: str) -> str:
    if wcr == "add":
        return f"{a} + {b}"
    return f"tl.{'maximum' if wcr == 'max' else 'minimum'}({a}, {b})"


def _reduce_axis(wcr: str, x: str, axis: int) -> str:
    fn = {"add": "tl.sum", "max": "tl.max", "min": "tl.min"}[wcr]
    return f"tl.expand_dims({fn}({x}, axis={axis}), {axis})"


def _affine(e: Expr) -> str:
    """An integer-affine Expr over grid parameters as Triton source."""
    parts = []
    for mono, c in Expr.wrap(e).terms.items():
        c = int(c)
        if mono == ():
            parts.append(str(c))
        else:
            (name, _), = mono
            parts.append(f"g_{name}" if c == 1 else f"{c} * g_{name}")
    return " + ".join(parts) if parts else "0"


class _Scope:
    """Variables emitted at one indentation level; windowed scopes carry
    their flat window-offset tensor and mask."""

    def __init__(self, indent: int, parent: Optional["_Scope"] = None,
                 window: Optional[Tuple[str, str]] = None):
        self.indent = indent
        self.parent = parent
        self.window = window
        self.memo: Dict[int, str] = {}

    def lookup(self, key):
        s = self
        while s is not None:
            if key in s.memo:
                return s.memo[key]
            s = s.parent
        return None


class _TritonEmitter:
    """Prints a :class:`KernelDesc` as the source of a Triton module: the
    main kernel ``<name>_main`` and, for a two-stage reduction, the
    fixed-order combine ``<name>_final``."""

    def __init__(self, desc: KernelDesc, fn_name: str):
        self.d = desc
        self.fn = fn_name
        self.lines: List[str] = []
        self.n = 0
        self.R = len(desc.tiles)
        self.tile1 = [b for _, _, b in desc.tiles] + [1]
        ins = []
        for a in desc.loads:
            if a.container not in ins:
                ins.append(a.container)
        outs = []
        for o in desc.outputs:
            if o.access.container not in outs:
                outs.append(o.access.container)
        self.in_args = {c: f"in_{i}" for i, c in enumerate(ins)}
        self.out_args = {c: f"out_{i}" for i, c in enumerate(outs)}
        self.acc_names: Dict[int, str] = {}

    # -- helpers ---------------------------------------------------------
    def emit(self, scope: _Scope, text: str):
        self.lines.append("    " * scope.indent + text)

    def fresh(self, prefix: str) -> str:
        self.n += 1
        return f"{prefix}{self.n}"

    def axis_index(self, k: int) -> str:
        """``[:, None, None]``-style index placing a 1-D tensor on axis k
        of the rank-(R+1) program tensors."""
        if self.R == 0:
            return ""
        idx = ["None"] * (self.R + 1)
        idx[k] = ":"
        return "[" + ", ".join(idx) + "]"

    def prologue(self, scope: _Scope, pid: str = "pid"):
        d = self.d
        self.emit(scope, f"{pid} = tl.program_id(0).to(tl.int64)")
        self.emit(scope, f"zero = tl.zeros({self.tile1!r}, dtype=tl.int64)")
        rem = pid
        for i, (p, n) in enumerate(reversed(d.kept)):
            if i == len(d.kept) - 1:
                self.emit(scope, f"g_{p} = {rem}")
            else:
                self.emit(scope, f"g_{p} = {rem} % {n}")
                self.emit(scope, f"rem_{i} = {rem} // {n}")
                rem = f"rem_{i}"
        for k, (q, _, b) in enumerate(d.tiles):
            self.emit(scope, f"t_{q} = tl.arange(0, {b}){self.axis_index(k)}")

    def reduction_coords(self, scope: _Scope, r: str):
        rem = r
        red = self.d.reduction
        for i, (p, n) in enumerate(reversed(red)):
            if i == len(red) - 1:
                self.emit(scope, f"g_{p} = {rem}")
            else:
                self.emit(scope, f"g_{p} = {rem} % {n}")
                self.emit(scope, f"rrem_{i} = {rem} // {n}")
                rem = f"rrem_{i}"

    def lane_valid(self, q: str) -> Optional[str]:
        """Validity of tile axis q's lanes: inside the tile (a block wider
        than its tile) and, for a partial final tile, inside the extent."""
        _, tile, block = next(t for t in self.d.tiles if t[0] == q)
        conds = []
        if block > tile:
            conds.append(f"(t_{q} < {tile})")
        if q in self.d.partial:
            ctr, ts, ext = self.d.partial[q]
            conds.append(f"(g_{ctr} * {ts} + t_{q} < {ext})")
        return " & ".join(conds) if conds else None

    def valid_all(self, axes=None) -> Optional[str]:
        qs = [q for k, (q, _, _) in enumerate(self.d.tiles)
              if axes is None or k in axes]
        conds = [c for c in (self.lane_valid(q) for q in qs) if c]
        return " & ".join(conds) if conds else None

    def coords(self, a: Access, wo: Optional[str]) -> List[str]:
        """Per container dimension, the element coordinate tensor source;
        ``wo`` is the flat window offset tensor when the access has a
        window (row-major over its window dims, as ``ravel`` orders it)."""
        wdims = [k for k, (_, kind, _) in enumerate(a.dims)
                 if kind == "window"]
        out = []
        for d, (base, kind, arg) in enumerate(a.dims):
            b = _affine(base)
            if kind == "tile":
                out.append(f"({b} + t_{arg})")
            elif kind == "window":
                j = wdims.index(d)
                inner = math.prod(a.dims[k][2] for k in wdims[j + 1:])
                off = wo if inner == 1 else f"({wo} // {inner})"
                if j > 0:
                    off = f"({off} % {arg})"
                out.append(f"({b} + {off})")
            else:
                out.append(f"({b})")
        return out

    def address(self, a: Access, wo: Optional[str]) -> Tuple[str, str]:
        """(address, mask) source for an access: the row-major element
        offset, and the lanes inside the container."""
        if a.scalar:
            return "zero", "zero == 0"
        terms, conds = [], []
        for c, (_, kind, _), stride, size in zip(
                self.coords(a, wo), a.dims, a.strides, a.shape):
            terms.append(c if stride == 1 else f"{c} * {stride}")
            if kind != "fixed":
                conds.append(f"({c} >= 0) & ({c} < {size})")
        addr = " + ".join(terms + ["zero"])
        mask = " & ".join(conds + ["(zero == 0)"])
        return addr, mask

    # -- expressions -----------------------------------------------------
    def prepare(self, node, scope: _Scope):
        """Emit the window-free sub-expressions of a windowed expression
        in ``scope`` (before the chunk loop that needs them)."""
        if not isinstance(node, vocab.Traced):
            return
        if not node.window:
            self.expr(node, scope)
            return
        for a in node.args:
            self.prepare(a, scope)

    def expr(self, node, scope: _Scope) -> str:
        if isinstance(node, bool):
            return "True" if node else "False"
        if isinstance(node, (int, float)):
            return repr(float(node))
        if not isinstance(node, vocab.Traced):
            raise KernelRefusal(f"cannot emit {type(node).__name__}")
        hit = scope.lookup(id(node))
        if hit is not None:
            return hit
        if node.window and scope.window is None:
            raise KernelRefusal("windowed value outside a chunk loop")
        op = node.op
        if op == "load":
            a = self.d.loads[node.attr]
            wo = scope.window[0] if a.window else None
            addr, mask = self.address(a, wo)
            v = self.fresh("v")
            self.emit(scope, f"{v} = tl.load({self.in_args[a.container]} + "
                             f"({addr}), mask={mask}, other=0.0)"
                             f".to(tl.float32)")
        elif op == "acc":
            v = self.acc_names[node.attr]
        elif op == "sum":
            v = self.window_sum(node.args[0], scope)
        else:
            args = [self.expr(x, scope) for x in node.args]
            v = self.fresh("v")
            if op in _BIN:
                rhs = f"{args[0]} {_BIN[op]} {args[1]}"
            elif op == "neg":
                rhs = f"-{args[0]}"
            elif op == "abs":
                rhs = f"tl.abs({args[0]})"
            elif op == "where":
                rhs = f"tl.where({args[0]}, {args[1]}, {args[2]})"
            elif op in ("maximum", "minimum"):
                rhs = f"tl.{op}({args[0]}, {args[1]})"
            elif op == "exp":
                rhs = f"tl.exp({args[0]})"
            elif op == "tanh":
                rhs = f"1.0 - 2.0 / (tl.exp(2.0 * {args[0]}) + 1.0)"
            elif op == "ravel":
                rhs = args[0]
            elif op == "cast":
                rhs = self.cast(args[0], node.attr)
            else:
                raise KernelRefusal(f"no Triton lowering for {op!r}")
            self.emit(scope, f"{v} = {rhs}")
        scope.memo[id(node)] = v
        return v

    @staticmethod
    def cast(x: str, name: str) -> str:
        if name in ("float32", "float64"):
            return x
        if name in ("bfloat16", "float16"):
            return f"{x}.to(tl.{name}).to(tl.float32)"
        if name == "bool":
            return f"({x} != 0)"
        return f"{x}.to(tl.int64).to(tl.float32)"

    def chunk(self) -> int:
        return window_chunk(math.prod(b for _, _, b in self.d.tiles))

    def open_window_loop(self, scope: _Scope, length: int) -> _Scope:
        ch = min(self.chunk(), _pow2(length))
        c = self.fresh("c")
        self.emit(scope, f"for {c} in range(0, {length}, {ch}):")
        inner = _Scope(scope.indent + 1, scope)
        wo, wm = self.fresh("wo"), self.fresh("wm")
        self.emit(inner, f"{wo} = ({c} + tl.arange(0, {ch}))"
                         f"{self.axis_index(self.R)}.to(tl.int64)")
        self.emit(inner, f"{wm} = {wo} < {length}")
        inner.window = (wo, wm)
        return inner

    def window_sum(self, arg, scope: _Scope) -> str:
        self.prepare(arg, scope)
        acc = self.fresh("ws")
        self.emit(scope, f"{acc} = tl.zeros({self.tile1!r}, dtype=tl.float32)")
        inner = self.open_window_loop(scope, math.prod(arg.window))
        x = self.expr(arg, inner)
        self.emit(inner, f"{acc} = {acc} + tl.expand_dims(tl.sum(tl.where("
                         f"{inner.window[1]}, {x}, 0.0), axis={self.R}), "
                         f"{self.R})")
        return acc

    # -- outputs -----------------------------------------------------------
    def store(self, scope: _Scope, o: OutputDesc, val: str,
              reduce_absent: bool = True):
        """Reduce the value over the tile axes the output is not indexed
        by, combine it with the prior contents (wcr) and store it in the
        output's box."""
        if reduce_absent:
            for k in o.absent:
                q = self.d.tiles[k][0]
                if o.wcr in WCR_MODES:
                    val2 = _reduce_axis(o.wcr, val, k)
                else:  # revisited location: the last lane writes last
                    val2 = (f"tl.expand_dims(tl.sum(tl.where(t_{q} == "
                            f"{self.d.tiles[k][1] - 1}, {val}, 0.0), "
                            f"axis={k}), {k})")
                nv = self.fresh("r")
                self.emit(scope, f"{nv} = {val2}")
                val = nv
        a = o.access
        addr, mask = self.address(a, scope.window[0] if a.window else None)
        conds = [mask]
        present = [k for k in range(self.R) if k not in o.absent]
        pv = self.valid_all(present)
        if pv:
            conds.append(pv)
        if not a.scalar:
            wo = scope.window[0] if a.window else None
            for (lo, hi), c, (_, kind, _) in zip(o.box, self.coords(a, wo),
                                                 a.dims):
                if kind != "fixed":
                    conds.append(f"({c} >= {lo}) & ({c} < {hi})")
        if a.window:
            conds.append(scope.window[1])
        m = self.fresh("m")
        self.emit(scope, f"{m} = " + " & ".join(conds))
        ptr = self.out_args[a.container]
        if o.wcr in WCR_MODES:
            prev = self.fresh("p")
            self.emit(scope, f"{prev} = tl.load({ptr} + ({addr}), mask={m}, "
                             f"other=0.0).to(tl.float32)")
            nv = self.fresh("r")
            self.emit(scope, f"{nv} = {_combine(o.wcr, prev, val)}")
            val = nv
        self.emit(scope, f"tl.store({ptr} + ({addr}), tl.where({m}, {val}, "
                         f"0.0).to({ptr}.dtype.element_ty), mask={m})")

    # -- kernels -----------------------------------------------------------
    def signature(self, extra=()) -> str:
        args = list(self.in_args.values()) + list(self.out_args.values())
        return ", ".join(args + list(extra))

    def main(self) -> str:
        d = self.d
        parts = [f"part_{i}" for i in range(len(d.outputs))] \
            if d.splits > 1 else []
        self.emit(_Scope(0), "@triton.jit")
        self.emit(_Scope(0), f"def {self.fn}_main({self.signature(parts)}):")
        top = _Scope(1)
        self.prologue(top)
        if d.internal:
            self.two_phase(top)
            return "\n".join(self.lines)
        loop = top
        accs = {}
        if d.reduction:
            for i, o in enumerate(d.outputs):
                accs[i] = self.fresh("acc")
                init = _IDENT[o.wcr] if o.wcr in WCR_MODES else "0.0"
                self.emit(top, f"{accs[i]} = tl.full({self.tile1!r}, {init}, "
                               f"tl.float32)")
            if d.splits > 1:
                self.emit(top, "split = tl.program_id(1).to(tl.int64)")
                self.emit(top, f"r_lo = split * {d.n_reduction} // {d.splits}")
                self.emit(top, f"r_hi = (split + 1) * {d.n_reduction} // "
                               f"{d.splits}")
                self.emit(top, "for r in range(r_lo, r_hi):")
            else:
                self.emit(top, f"for r in range(0, {d.n_reduction}):")
            loop = _Scope(2, top)
            self.reduction_coords(loop, "r")
        vall = self.valid_all()
        for i, o in enumerate(d.outputs):
            if o.access.window:
                self.prepare(o.value, loop)
                inner = self.open_window_loop(loop, math.prod(o.access.window))
                v = self.expr(o.value, inner)
                self.store(inner, o, self.mask_identity(inner, o, v, vall))
                continue
            v = self.expr(o.value, loop)
            if i in accs:
                if o.wcr in WCR_MODES:
                    v = self.mask_identity(loop, o, v, vall)
                    self.emit(loop, f"{accs[i]} = {_combine(o.wcr, accs[i], v)}")
                else:
                    self.emit(loop, f"{accs[i]} = {v} + tl.zeros("
                                    f"{self.tile1!r}, dtype=tl.float32)")
            else:
                self.store(loop, o, self.mask_identity(loop, o, v, vall))
        if d.splits > 1:
            self.emit(top, "lane = " + self.lane_index() + " + zero")
            for i, o in enumerate(d.outputs):
                val = accs[i]
                for k in o.absent:
                    nv = self.fresh("r")
                    self.emit(top, f"{nv} = {_reduce_axis(o.wcr, val, k)}")
                    val = nv
                self.emit(top, f"tl.store(part_{i} + (split * {d.n_kept} + "
                               f"pid) * {self.part_size()} + lane, "
                               f"{val} + tl.zeros({self.tile1!r}, "
                               f"dtype=tl.float32))")
        else:
            for i, o in enumerate(d.outputs):
                if i in accs:
                    self.store(top, o, accs[i])
        return "\n".join(self.lines)

    def mask_identity(self, scope, o: OutputDesc, v: str, vall) -> str:
        if o.wcr not in WCR_MODES or not vall:
            return v
        nv = self.fresh("v")
        self.emit(scope, f"{nv} = tl.where({vall}, {v}, {_IDENT[o.wcr]})")
        return nv

    def part_size(self) -> int:
        return math.prod(b for _, _, b in self.d.tiles)

    def lane_index(self) -> str:
        terms, stride = [], 1
        for q, _, b in reversed(self.d.tiles):
            terms.append(f"t_{q}" if stride == 1 else f"t_{q} * {stride}")
            stride *= b
        return " + ".join(terms) if terms else "0"

    def final(self) -> str:
        """The second stage of a split reduction: one program per kept
        point sums the partials in split order, then combines with the
        prior contents and stores."""
        d = self.d
        parts = [f"part_{i}" for i in range(len(d.outputs))]
        self.lines.append("")
        self.lines.append("")
        self.emit(_Scope(0), "@triton.jit")
        self.emit(_Scope(0), f"def {self.fn}_final({self.signature(parts)}):")
        top = _Scope(1)
        self.prologue(top)
        self.emit(top, "lane = " + self.lane_index() + " + zero")
        for i, o in enumerate(d.outputs):
            acc = self.fresh("acc")
            self.emit(top, f"{acc} = tl.full({self.tile1!r}, {_IDENT[o.wcr]}, "
                           f"tl.float32)")
            self.emit(top, f"for s in range(0, {d.splits}):")
            body = _Scope(2, top)
            x = self.fresh("x")
            self.emit(body, f"{x} = tl.load(part_{i} + (s * {d.n_kept} + pid) "
                            f"* {self.part_size()} + lane)")
            self.emit(body, f"{acc} = {_combine(o.wcr, acc, x)}")
            val = acc
            for k in o.absent:  # already reduced: keep the first lane
                nv = self.fresh("r")
                self.emit(top, f"{nv} = tl.expand_dims(tl.max(tl.where("
                               f"t_{d.tiles[k][0]} == 0, {val}, "
                               f"{_IDENT['max']}), axis={k}), {k})")
                val = nv
            self.store(top, o, val, reduce_absent=False)
        return "\n".join(self.lines)

    def two_phase(self, top: _Scope):
        d = self.d
        accs = []
        for k, (wcr, _, _) in enumerate(d.internal):
            a = self.fresh("acc")
            accs.append(a)
            self.emit(top, f"{a} = tl.full({self.tile1!r}, {_IDENT[wcr]}, "
                           f"tl.float32)")
        loop = top
        if d.reduction:
            self.emit(top, f"for r in range(0, {d.n_reduction}):")
            loop = _Scope(2, top)
            self.reduction_coords(loop, "r")
        vall = self.valid_all()
        for a, (wcr, val, _) in zip(accs, d.internal):
            v = self.expr(val, loop)
            if vall:
                nv = self.fresh("v")
                self.emit(loop, f"{nv} = tl.where({vall}, {v}, {_IDENT[wcr]})")
                v = nv
            self.emit(loop, f"{a} = {_combine(wcr, a, v)}")
        for k, (a, (wcr, _, kept_axes)) in enumerate(zip(accs, d.internal)):
            val = a
            for ax in range(self.R):
                if ax not in kept_axes:
                    nv = self.fresh("r")
                    self.emit(top, f"{nv} = {_reduce_axis(wcr, val, ax)}")
                    val = nv
            self.acc_names[k] = val
        after = _Scope(1)
        after.memo = {}
        for o in d.outputs:
            if o.access.window:
                self.prepare(o.value, after)
                inner = self.open_window_loop(after,
                                              math.prod(o.access.window))
                self.store(inner, o, self.expr(o.value, inner))
            else:
                self.store(after, o, self.expr(o.value, after))


# ---------------------------------------------------------------------------
# Row programs: one program per map iteration (an attention row)
# ---------------------------------------------------------------------------

#: the operations that make a chain a row body (``codegen.vocab``)
ROW_OPS = ("matvec", "vecmat", "softmax", "iota")

#: elements of one streamed chunk of a matrix window in a row program
ROW_CHUNK_ELEMS = 4096

#: the longest (m,) row a row program holds whole
ROW_VECTOR_LIMIT = 8192

_FMIN = repr(float(_FINFO32.min))


def _walk(node, seen=None):
    """Every traced node under ``node``, once each."""
    seen = set() if seen is None else seen
    if not isinstance(node, vocab.Traced) or id(node) in seen:
        return
    seen.add(id(node))
    yield node
    for a in node.args:
        yield from _walk(a, seen)


def _uses_row_ops(value) -> bool:
    return any(n.op in ROW_OPS for n in _walk(value))


def row_chunk(desc: KernelDesc) -> int:
    """Rows of a matrix window one row program streams per step: a chunk
    of at most :data:`ROW_CHUNK_ELEMS` elements beside the widest matrix
    row (power-of-two block)."""
    widest = max([_pow2(a.window[1]) for a in desc.loads
                  if len(a.window) == 2] + [2])
    return max(2, ROW_CHUNK_ELEMS // widest)


def row_program_bytes(desc: KernelDesc, elem: int = 4) -> int:
    """On-chip bytes one row program holds: a chunk of each matrix window
    and each vector window (whole, or one chunk), double-buffered, plus
    the output rows."""
    rows = row_chunk(desc)
    held = 0
    for a in desc.loads:
        if len(a.window) == 2:
            held += rows * max(2, _pow2(a.window[1]))
        elif a.window:
            held += max(2, min(_pow2(a.window[0]), ROW_VECTOR_LIMIT))
        else:
            held += 1
    held *= 2
    for o in desc.outputs:
        held += max(2, _pow2(math.prod(o.access.window))) \
            if o.access.window else 1
    return held * elem


class _Loop:
    """One chunk loop of a row program over a window axis of length n:
    the (CN, 1) position tensor and its mask, and its body's scope."""

    def __init__(self, n: int, j: str, jm: str, scope: _Scope):
        self.n, self.j, self.jm, self.scope = n, j, jm, scope


class _RowEmitter(_TritonEmitter):
    """Prints a row :class:`KernelDesc` as Triton: one program per map
    iteration — the kept grid point and the tile lane both come from the
    program id — so a program holds one iteration's windows and no tile
    axes. Values are 2-D: a matrix window streams through (CN, M) chunks
    (CN rows of the window, its M-wide row whole); an (n,) value over the
    streamed axis (a matrix-vector product, ``iota``, a softmax) is a
    (CN, 1) column of the chunk; an (m,) value held whole is a (1, M) row;
    reductions give (1, 1). Each streamed value lives in a chunk loop over
    its axis. A softmax first runs its own loop for the running max and
    normalizer (the sum rescaled as the max grows, in fp32); the loop that
    consumes it computes exp(x - max) / normalizer per chunk. A
    vector-matrix product (p @ V) accumulates its (1, M) row over the
    chunks. Every sum runs in a fixed order; there are no atomics."""

    def __init__(self, desc: KernelDesc, fn_name: str):
        super().__init__(desc, fn_name)
        self.top = _Scope(1)
        self.kinds: Dict[int, str] = {}
        self.stats: Dict[int, Tuple[str, str]] = {}
        self.cols: Dict[int, Tuple[str, str]] = {}
        self.rows = row_chunk(desc)
        self.lane_ok: Optional[str] = None

    # -- value kinds -----------------------------------------------------
    def kind(self, node) -> str:
        """``scalar``, ``col`` (an (m,) row held whole), ``row`` (an (n,)
        value streamed in chunks), ``mat`` (a streamed matrix window) or
        ``flex`` (an (n,) load, held or streamed as its use asks)."""
        if not isinstance(node, vocab.Traced):
            return "scalar"
        hit = self.kinds.get(id(node))
        if hit is not None:
            return hit
        op, args = node.op, node.args
        if len(node.window) > 2:
            raise KernelRefusal(f"row body: a window of shape {node.window}")
        if op == "load":
            k = ("scalar", "flex", "mat")[len(node.window)]
        elif op == "iota":
            k = "row"
        elif op == "matvec":
            if self.kind(args[0]) != "mat" or \
                    self.kind(args[1]) not in ("col", "flex"):
                raise KernelRefusal("row body: @ of a computed matrix, or "
                                    "of a streamed vector")
            k = "row"
        elif op == "softmax":
            if self.kind(args[0]) not in ("row", "flex"):
                raise KernelRefusal("row body: softmax of a held row")
            k = "row"
        elif op == "vecmat":
            if self.kind(args[0]) not in ("row", "flex") or \
                    self.kind(args[1]) != "mat":
                raise KernelRefusal("row body: a vector-matrix product of "
                                    "a held row or a computed matrix")
            k = "col"
        elif op == "sum":
            if self.kind(args[0]) == "mat":
                raise KernelRefusal("row body: a sum over a matrix window")
            k = "scalar"
        elif op == "acc":
            raise KernelRefusal("row body: an in-kernel reduction value")
        else:
            if op == "ravel" and len(args[0].window) > 1:
                raise KernelRefusal("row body: ravel of a matrix window")
            ks = {self.kind(a) for a in args}
            if "mat" in ks:
                if ks - {"mat", "scalar"}:
                    raise KernelRefusal("row body: a matrix window combined "
                                        "with a vector")
                k = "mat"
            elif "row" in ks and "col" in ks:
                raise KernelRefusal("row body: a streamed value combined "
                                    "with a held row")
            else:
                k = next((c for c in ("row", "col", "flex") if c in ks),
                         "scalar")
        if k == "col" and node.window[-1] > ROW_VECTOR_LIMIT:
            raise KernelRefusal(f"row body: a held row of "
                                f"{node.window[-1]} elements")
        self.kinds[id(node)] = k
        return k

    # -- addressing ------------------------------------------------------
    def col_offsets(self, m: int) -> Tuple[str, str]:
        """The (1, M) offsets of a held row of length m and their mask."""
        hit = self.cols.get(m)
        if hit is None:
            w, wm = self.fresh("wc"), self.fresh("wcm")
            self.emit(self.top, f"{w} = tl.arange(0, {max(2, _pow2(m))})"
                                f"[None, :].to(tl.int64)")
            self.emit(self.top, f"{wm} = {w} < {m}")
            hit = self.cols[m] = (w, wm)
        return hit

    def row_address(self, a: Access, loop: Optional[_Loop]
                    ) -> Tuple[str, str]:
        """(address, mask) of an access: a scalar, a held row (1, M), a
        streamed column (CN, 1) or a matrix chunk (CN, M)."""
        if a.scalar:
            return "0", ""
        offs = []
        if len(a.window) == 2:
            offs = [(loop.j, loop.jm), self.col_offsets(a.window[1])]
        elif len(a.window) == 1:
            offs = [(loop.j, loop.jm) if loop is not None
                    else self.col_offsets(a.window[0])]
        terms, conds, k = [], [], 0
        for (base, kind, arg), stride, size in zip(a.dims, a.strides,
                                                   a.shape):
            b = _affine(base)
            if kind == "tile":
                c = f"({b} + t_{arg})"
            elif kind == "window":
                off, om = offs[k]
                k += 1
                c = f"({b} + {off})"
                conds.append(om)
            else:
                c = f"({b})"
            terms.append(c if stride == 1 else f"{c} * {stride}")
            if kind != "fixed":
                conds.append(f"({c} >= 0) & ({c} < {size})")
        return " + ".join(terms) or "0", " & ".join(conds)

    def load(self, node, scope: _Scope, loop: Optional[_Loop]) -> str:
        a = self.d.loads[node.attr]
        addr, mask = self.row_address(a, loop)
        v = self.fresh("v")
        ptr = self.in_args[a.container]
        if mask:
            self.emit(scope, f"{v} = tl.load({ptr} + ({addr}), mask={mask}, "
                             f"other=0.0).to(tl.float32)")
        else:
            self.emit(scope, f"{v} = tl.load({ptr} + ({addr}))"
                             f".to(tl.float32)")
        return v

    # -- loops -----------------------------------------------------------
    def open_loop(self, n: int) -> _Loop:
        cn = min(self.rows, max(2, _pow2(n)))
        c = self.fresh("c")
        self.emit(self.top, f"for {c} in range(0, {n}, {cn}):")
        body = _Scope(2, self.top)
        j, jm = self.fresh("j"), self.fresh("jm")
        self.emit(body, f"{j} = ({c} + tl.arange(0, {cn}))[:, None]"
                        f".to(tl.int64)")
        self.emit(body, f"{jm} = {j} < {n}")
        return _Loop(n, j, jm, body)

    def prepare(self, node):
        """Emit, before a chunk loop, every held value and every softmax
        statistic a streamed expression needs."""
        if not isinstance(node, vocab.Traced):
            return
        k = self.kind(node)
        if k in ("scalar", "col"):
            self.value(node)
            return
        if node.op == "softmax":
            self.softmax_stats(node)
            return
        if node.op == "matvec":
            self.value(node.args[1])
        for a in node.args:
            self.prepare(a)

    def softmax_stats(self, node) -> Tuple[str, str]:
        """The max and the normalizer sum(exp(x - max)) of a softmax's
        argument, by one loop with a running max."""
        hit = self.stats.get(id(node))
        if hit is not None:
            return hit
        x = node.args[0]
        self.prepare(x)
        m, l = self.fresh("mx"), self.fresh("nz")
        self.emit(self.top, f"{m} = tl.full((1, 1), {_FMIN}, tl.float32)")
        self.emit(self.top, f"{l} = tl.zeros((1, 1), dtype=tl.float32)")
        loop = self.open_loop(x.window[0])
        xv = self.chunk(x, loop)
        b = loop.scope
        mn = self.fresh("mn")
        self.emit(b, f"{mn} = tl.maximum({m}, tl.expand_dims(tl.max("
                     f"tl.where({loop.jm}, {xv}, {_FMIN}), axis=0), 0))")
        self.emit(b, f"{l} = {l} * tl.exp({m} - {mn}) + tl.expand_dims("
                     f"tl.sum(tl.where({loop.jm}, tl.exp({xv} - {mn}), 0.0), "
                     f"axis=0), 0)")
        self.emit(b, f"{m} = {mn}")
        self.stats[id(node)] = (m, l)
        return m, l

    # -- expressions -------------------------------------------------------
    def _elementwise(self, node, args: List[str]) -> str:
        op = node.op
        if op in _BIN:
            return f"{args[0]} {_BIN[op]} {args[1]}"
        if op == "and":
            return f"({args[0]}) & ({args[1]})"
        if op == "or":
            return f"({args[0]}) | ({args[1]})"
        if op == "neg":
            return f"-{args[0]}"
        if op == "abs":
            return f"tl.abs({args[0]})"
        if op == "where":
            return f"tl.where({args[0]}, {args[1]}, {args[2]})"
        if op in ("maximum", "minimum"):
            return f"tl.{op}({args[0]}, {args[1]})"
        if op == "exp":
            return f"tl.exp({args[0]})"
        if op == "tanh":
            return f"1.0 - 2.0 / (tl.exp(2.0 * {args[0]}) + 1.0)"
        if op == "ravel":
            return args[0]
        if op == "cast":
            return self.cast(args[0], node.attr)
        raise KernelRefusal(f"no Triton lowering for {op!r}")

    @staticmethod
    def literal(node) -> Optional[str]:
        if isinstance(node, bool):
            return "True" if node else "False"
        if isinstance(node, (int, float)):
            return repr(float(node))
        if not isinstance(node, vocab.Traced):
            raise KernelRefusal(f"cannot emit {type(node).__name__}")
        return None

    def value(self, node) -> str:
        """A scalar or held-row value, emitted at the top of the program."""
        lit = self.literal(node)
        if lit is not None:
            return lit
        hit = self.top.memo.get(id(node))
        if hit is not None:
            return hit
        if self.kind(node) not in ("scalar", "col", "flex"):
            raise KernelRefusal(f"row body: a streamed {node.op!r} value "
                                f"outside its chunk loop")
        if node.window and node.window[-1] > ROW_VECTOR_LIMIT:
            raise KernelRefusal(f"row body: a held row of "
                                f"{node.window[-1]} elements")
        op, top = node.op, self.top
        if op == "load":
            v = self.load(node, top, None)
        elif op == "sum":
            (x,) = node.args
            v = self.fresh("s")
            if self.kind(x) == "row":
                self.prepare(x)
                self.emit(top, f"{v} = tl.zeros((1, 1), dtype=tl.float32)")
                loop = self.open_loop(x.window[0])
                xv = self.chunk(x, loop)
                self.emit(loop.scope, f"{v} = {v} + tl.expand_dims(tl.sum("
                                      f"tl.where({loop.jm}, {xv}, 0.0), "
                                      f"axis=0), 0)")
            elif x.window:
                xv = self.value(x)
                _, wm = self.col_offsets(x.window[0])
                self.emit(top, f"{v} = tl.expand_dims(tl.sum(tl.where("
                               f"{wm}, {xv}, 0.0), axis=1), 1)")
            else:
                v = self.value(x)
        elif op == "vecmat":
            p, a = node.args
            self.prepare(p)
            self.prepare(a)
            width = max(2, _pow2(a.window[1]))
            v = self.fresh("vm")
            self.emit(top, f"{v} = tl.zeros((1, {width}), dtype=tl.float32)")
            loop = self.open_loop(a.window[0])
            pv, av = self.chunk(p, loop), self.chunk(a, loop)
            self.emit(loop.scope, f"{v} = {v} + tl.expand_dims(tl.sum("
                                  f"tl.where({loop.jm}, {pv} * {av}, 0.0), "
                                  f"axis=0), 0)")
        else:
            args = [self.value(a) for a in node.args]
            v = self.fresh("v")
            self.emit(top, f"{v} = {self._elementwise(node, args)}")
        top.memo[id(node)] = v
        return v

    def chunk(self, node, loop: _Loop) -> str:
        """A streamed value (or matrix chunk) inside ``loop``'s body."""
        lit = self.literal(node)
        if lit is not None:
            return lit
        if self.kind(node) in ("scalar", "col"):
            hit = self.top.memo.get(id(node))
            if hit is None:
                raise KernelRefusal(f"row body: held value {node.op!r} was "
                                    f"not emitted before its chunk loop")
            return hit
        if node.window[0] != loop.n:
            raise KernelRefusal(f"row body: a value over {node.window[0]} "
                                f"positions in a loop over {loop.n}")
        hit = loop.scope.memo.get(id(node))
        if hit is not None:
            return hit
        op, b = node.op, loop.scope
        if op == "load":
            v = self.load(node, b, loop)
        elif op == "iota":
            v = self.fresh("io")
            self.emit(b, f"{v} = {loop.j}.to(tl.float32)")
        elif op == "matvec":
            a, x = node.args
            av, xv = self.chunk(a, loop), self.top.memo.get(id(x))
            if xv is None:
                raise KernelRefusal("row body: the vector of @ was not "
                                    "emitted before its chunk loop")
            v = self.fresh("mv")
            self.emit(b, f"{v} = tl.expand_dims(tl.sum({av} * {xv}, axis=1), "
                         f"1)")
        elif op == "softmax":
            m, l = self.softmax_stats(node)
            xv = self.chunk(node.args[0], loop)
            v = self.fresh("sm")
            self.emit(b, f"{v} = tl.exp({xv} - {m}) / {l}")
        else:
            args = [self.chunk(a, loop) for a in node.args]
            v = self.fresh("v")
            self.emit(b, f"{v} = {self._elementwise(node, args)}")
        b.memo[id(node)] = v
        return v

    # -- the kernel ----------------------------------------------------------
    def prologue_row(self):
        d, top = self.d, self.top
        self.emit(top, "pid = tl.program_id(0).to(tl.int64)")
        rem = "pid"
        if d.tiles:
            self.emit(top, f"lane = pid % {d.n_lanes}")
            self.emit(top, f"rem = pid // {d.n_lanes}")
            lrem = "lane"
            for i, (q, t, _) in enumerate(reversed(d.tiles)):
                if i == len(d.tiles) - 1:
                    self.emit(top, f"t_{q} = {lrem}")
                else:
                    self.emit(top, f"t_{q} = {lrem} % {t}")
                    self.emit(top, f"lrem_{i} = {lrem} // {t}")
                    lrem = f"lrem_{i}"
            rem = "rem"
        for i, (p, n) in enumerate(reversed(d.kept)):
            if i == len(d.kept) - 1:
                self.emit(top, f"g_{p} = {rem}")
            else:
                self.emit(top, f"g_{p} = {rem} % {n}")
                self.emit(top, f"rem_{i} = {rem} // {n}")
                rem = f"rem_{i}"
        conds = [f"(g_{ctr} * {ts} + t_{q} < {ext})"
                 for q, (ctr, ts, ext) in d.partial.items()]
        if conds:
            self.lane_ok = "lane_ok"
            self.emit(top, "lane_ok = " + " & ".join(conds))

    def store_row(self, o: OutputDesc):
        a = o.access
        ptr = self.out_args[a.container]
        if len(a.window) > 1:
            raise KernelRefusal("row body: a matrix-window output")
        k = self.kind(o.value)
        if k == "mat":
            raise KernelRefusal("row body: an output computed as a matrix")
        loop = None
        if a.window and k == "row":
            self.prepare(o.value)
            loop = self.open_loop(a.window[0])
            val = self.chunk(o.value, loop)
            scope = loop.scope
        else:
            val = self.value(o.value)
            scope = self.top
        addr, mask = self.row_address(a, loop)
        if not a.window:
            addr = f"{addr} + tl.zeros((1, 1), dtype=tl.int64)"
            val = f"{val} + tl.zeros((1, 1), dtype=tl.float32)"
        conds = [c for c in (mask, self.lane_ok) if c]
        m = self.fresh("m")
        self.emit(scope, f"{m} = " + (" & ".join(conds) if conds
                                      else "tl.full((1, 1), 1, tl.int1)"))
        self.emit(scope, f"tl.store({ptr} + ({addr}), ({val}).to("
                         f"{ptr}.dtype.element_ty), mask={m})")

    def main(self) -> str:
        self.emit(_Scope(0), "@triton.jit")
        self.emit(_Scope(0), f"def {self.fn}_main({self.signature()}):")
        self.prologue_row()
        for o in self.d.outputs:
            self.store_row(o)
        return "\n".join(self.lines)


def triton_source(desc: KernelDesc, fn_name: Optional[str] = None) -> str:
    """The Triton module source for a kernel description: ``<fn>_main``
    and, when the reduction splits, ``<fn>_final``."""
    fn = fn_name or _fn_name(desc)
    if desc.row:
        src = _RowEmitter(desc, fn).main()
    else:
        em = _TritonEmitter(desc, fn)
        src = em.main()
        if desc.splits > 1:
            src = em.final()
    header = ("# Generated by repro_torch.codegen.cuda_backend.\n"
              "import triton\nimport triton.language as tl\n\n\n")
    return header + src + "\n"


@dataclass(frozen=True)
class GridKernel:
    """The generated kernel of one scope: its description and its Triton
    source, both fixed at compile time."""
    desc: KernelDesc
    source: str
    #: whether the plain block program applies the chain whole-block
    #: (:func:`whole_block_eligible`)
    whole_block: bool


def grid_kernel(sdfg: SDFG, state: State, spec: GridSpec,
                env: Optional[Dict[str, int]] = None) -> GridKernel:
    """Trace the scope's chain and print its Triton source; raises
    :class:`KernelRefusal` when the chain has no Triton lowering."""
    desc = describe_kernel(sdfg, state, spec, env)
    chain = _chain_of(state, spec)
    # the function is named by its code, so scopes that generate the same
    # code (the serving step's per-layer attention) share one module and
    # one compiled binary
    code = triton_source(desc, _FN_PLACEHOLDER)
    desc.fn = "k_" + hashlib.sha1(code.encode()).hexdigest()[:16]
    return GridKernel(desc, code.replace(_FN_PLACEHOLDER, desc.fn),
                      whole_block_eligible(sdfg, state, chain, spec))


_FN_PLACEHOLDER = "k_GENERATED"


def _py_name(label: str) -> str:
    out = "".join(ch if ch.isalnum() else "_" for ch in label)
    return "k_" + out


def _fn_name(desc: KernelDesc) -> str:
    return desc.fn or _py_name(desc.name)


# ---------------------------------------------------------------------------
# The plain version: the block program over the grid, on torch tensors
# ---------------------------------------------------------------------------

#: elements of one gathered operand per batch of grid steps
PLAIN_BATCH_ELEMS = 1 << 24


def _vmap_over(f, axes_list, n_extra=0):
    """Nest ``torch.func.vmap`` over tile axes (innermost last): each
    entry of ``axes_list`` maps input-edge index -> 0 / None; ``n_extra``
    trailing positional arguments are mapped on axis 0 at every level."""
    for axes in reversed(axes_list):
        f = torch.func.vmap(f, in_dims=(axes,) + (0,) * n_extra)
    return f


def _tile_axes(spec: GridSpec, qs):
    """Per tile param, the vmap in_dims of every input edge."""
    return [{i: (0 if q in dict(es.fact.param_dims) else None)
             for i, es in enumerate(spec.inputs)} for q in qs]


def _chain_call(state: State, chain: List[Tasklet], spec: GridSpec,
                nodes=None):
    def call(opvals):
        _, results = _run_chain(state, chain, spec, opvals, nodes)
        return tuple(results)
    return call


def whole_block_eligible(sdfg: SDFG, state: State, chain: List[Tasklet],
                         spec: GridSpec) -> bool:
    """True when every operand is scalar-per-iteration (all non-tile
    effective dims are size 1) AND the chain is verifiably elementwise: a
    probe on random block data, on the CPU at compile time, checks the
    whole-block application against the per-element (nested
    ``torch.func.vmap``) semantics, with the reference's tolerance.
    Slice-consuming, shape-changing, or value-diverging bodies keep the
    per-element nested vmap in the plain block program."""
    if not spec.block_params or spec.internal_wcr:
        return False
    if not all(getattr(t, "side_effect_free", True) for t in chain):
        return False
    for es in list(spec.inputs) + list(spec.outputs):
        pdims = set(dict(es.fact.param_dims).values())
        for d, n in enumerate(es.fact.effective_shape()):
            if n != 1 and d not in pdims:
                return False
    bp = dict(spec.block_params)
    block_order = [q for q, _ in spec.block_params]
    tile_shape = tuple(n for _, n in spec.block_params)
    chain_call = _chain_call(state, chain, spec)
    rng = np.random.default_rng(2025)
    padded, unpadded = {}, {}
    for i, es in enumerate(spec.inputs):
        pd = dict(es.fact.param_dims)
        present = tuple(bp[q] for q in block_order if q in pd)
        desc = sdfg.arrays.get(es.data)
        dt = torch_dtype(desc.dtype) if desc is not None else torch.float32
        if dt.is_floating_point:
            base = torch.from_numpy(rng.standard_normal(present)).to(dt)
        elif dt == torch.bool:
            base = torch.from_numpy(rng.integers(0, 2, present)).to(dt)
        else:
            base = torch.from_numpy(rng.integers(1, 8, present)).to(dt)
        unpadded[i] = base
        padded[i] = base.reshape(
            tuple(bp[q] if q in pd else 1 for q in block_order))
    try:
        whole = [torch.broadcast_to(torch.as_tensor(r), tile_shape)
                 for r in chain_call(padded)]
        f = _vmap_over(chain_call, _tile_axes(spec, block_order))
        ref = [torch.broadcast_to(torch.as_tensor(r), tile_shape)
               for r in f(unpadded)]
        return all(torch.allclose(w.float(), r.float(), rtol=1e-5,
                                  atol=1e-6, equal_nan=True)
                   for w, r in zip(whole, ref))
    except (RuntimeError, TypeError, ValueError, IndexError,
            AttributeError):
        return False


class GridProgram:
    """The plain PyTorch version of one generated grid kernel: the
    reference kernel's block program (load the operand blocks, run the
    chain whole-block or per element, mask, accumulate over the reduction
    steps, write the output blocks) run over the grid in batches of grid
    steps, in grid order — the counterpart of Pallas interpret mode."""

    def __init__(self, state: State, chain: List[Tasklet], spec: GridSpec,
                 whole_block: bool):
        self.state = state
        self.chain = chain
        self.spec = spec
        self.whole_block = whole_block
        self.block_order = [q for q, _ in spec.block_params]
        self.bp = dict(spec.block_params)
        self.tile_shape = tuple(n for _, n in spec.block_params)
        red = spec.internal_wcr[0].reduction if spec.internal_wcr else \
            spec.outputs[0].reduction
        self.kept = [(p, n) for p, n in spec.grid if p not in red]
        self.red = [(p, n) for p, n in spec.grid if p in red]

    # -- grid enumeration ---------------------------------------------------
    @staticmethod
    def _decompose(flat: torch.Tensor, params) -> Dict[str, torch.Tensor]:
        out = {}
        for p, n in reversed(params):
            out[p] = flat % n
            flat = flat // n
        return out

    @staticmethod
    def _step_elems(es: EdgeSpec) -> int:
        """Elements one grid step gathers of an operand: its block, a
        window's length in a windowed dim (not the container's extent)."""
        win = {d: ln for d, _, ln in es.fact.windows}
        return math.prod(win.get(d, bs)
                         for d, bs in enumerate(es.fact.block_shape))

    def _batches(self, device):
        elems = max([self._step_elems(es)
                     for es in list(self.spec.inputs) + list(self.spec.outputs)
                     ] + [1])
        K = math.prod(n for _, n in self.kept)
        R = math.prod(n for _, n in self.red)
        rb = min(R, max(1, PLAIN_BATCH_ELEMS // elems))
        kb = min(K, max(1, PLAIN_BATCH_ELEMS // (elems * rb)))
        for k0 in range(0, K, kb):
            kidx = torch.arange(k0, min(K, k0 + kb), device=device)
            yield kidx, [torch.arange(r0, min(R, r0 + rb), device=device)
                         for r0 in range(0, R, rb)]

    def _ids(self, kidx, ridx) -> Dict[str, torch.Tensor]:
        """Grid coordinates of the (kept x reduction) steps, flattened
        kept-major (grid order: reduction steps innermost)."""
        kk = self._decompose(kidx, self.kept)
        rr = self._decompose(ridx, self.red)
        nk, nr = len(kidx), len(ridx)
        ids = {p: v[:, None].expand(nk, nr).reshape(-1) for p, v in kk.items()}
        ids.update({p: v[None, :].expand(nk, nr).reshape(-1)
                    for p, v in rr.items()})
        return ids

    # -- blocks ------------------------------------------------------------
    @staticmethod
    def _coords(es: EdgeSpec, ids, shape):
        """Per dim, the (B, L) element coordinates of each step's block."""
        fact = es.fact
        win = {d: (e, ln) for d, e, ln in fact.windows}
        B = len(next(iter(ids.values()))) if ids else 1
        out = []
        for d, bs in enumerate(fact.block_shape):
            if d in win:
                e, ln = win[d]
                base = eval_affine(e, ids)
            else:
                ln = bs
                base = eval_affine(fact.index_exprs[d], ids) * bs
            if not isinstance(base, torch.Tensor):
                base = torch.full((B,), int(base), dtype=torch.long)
            dev = next(iter(ids.values())).device if ids else base.device
            out.append(base.to(dev)[:, None] +
                       torch.arange(ln, device=dev)[None, :])
        return out

    def _gather(self, value, es: EdgeSpec, ids):
        """(B, *effective block) values with tile axes moved to the front
        after the step axis, in block-param order (``_load_operands``)."""
        B = len(next(iter(ids.values())))
        if es.scalar:
            return value.reshape(1).expand(B)
        coords = self._coords(es, ids, value.shape)
        nd = len(coords)
        idx = []
        for d, c in enumerate(coords):
            c = c.clamp(0, value.shape[d] - 1)
            view = [B] + [1] * nd
            view[d + 1] = c.shape[1]
            idx.append(c.reshape(view))
        v = value[tuple(idx)]
        for d in sorted(es.fact.squeeze_dims, reverse=True):
            v = v.squeeze(d + 1)
        pd = dict(es.fact.param_dims)
        present = [q for q in self.block_order if q in pd]
        if present:
            sq = es.fact.squeeze_dims
            src = [1 + pd[q] - sum(1 for s in sq if s < pd[q])
                   for q in present]
            v = torch.movedim(v, src, list(range(1, len(src) + 1)))
        return v

    def _scatter(self, new, es: EdgeSpec, ids, val):
        """Write (B, *effective block) values into their blocks of
        ``new``, dropping lanes outside the container."""
        if es.scalar:
            new.reshape(1)[0] = val.reshape(-1)[-1]
            return
        coords = self._coords(es, ids, new.shape)
        B, nd = val.shape[0], len(coords)
        idx, inb = [], None
        for d, c in enumerate(coords):
            view = [B] + [1] * nd
            view[d + 1] = c.shape[1]
            c = c.reshape(view)
            ok = (c >= 0) & (c < new.shape[d])
            inb = ok if inb is None else inb & ok
            idx.append(c)
        full = torch.broadcast_shapes(*[c.shape for c in idx])
        idx = [c.expand(full)[inb.expand(full)] for c in idx]
        new[tuple(idx)] = val.reshape(full).to(new.dtype)[inb.expand(full)]

    def _assemble(self, val, es: EdgeSpec):
        """``_assemble_block`` with a leading step axis."""
        pd = dict(es.fact.param_dims)
        eff = es.fact.effective_shape()
        absent = tuple(1 + i for i, q in enumerate(self.block_order)
                       if q not in pd)
        if absent:
            if es.wcr in WCR_MODES:
                val = wcr_reduce(es.wcr, val, absent)
            else:
                idx = (slice(None),) + tuple(
                    -1 if i + 1 in absent else slice(None)
                    for i in range(len(self.block_order)))
                val = val[idx]
        present = [q for q in self.block_order if q in pd]
        nlead = len(present)
        trailing = list(range(1 + nlead, val.dim()))
        slice_dims = [d for d in range(len(eff))
                      if d not in pd.values() and eff[d] > 1]
        if len(trailing) == len(slice_dims) and (present or trailing):
            src_of = {pd[q]: 1 + i for i, q in enumerate(present)}
            src_of.update({d: t for d, t in zip(slice_dims, trailing)})
            perm = [0] + [src_of[d] for d in sorted(src_of)]
            val = val.permute(perm)
        return val.reshape((val.shape[0],) + tuple(eff))

    # -- chain application ------------------------------------------------
    def _apply(self, chain_call, opvals, whole_block: bool):
        """Chain results over a batch of steps: (B, *tile, *trailing)."""
        spec, bp, block_order = self.spec, self.bp, self.block_order
        if whole_block:
            B = len(next(iter(opvals.values())))
            bvals = {}
            for i, es in enumerate(spec.inputs):
                pd = dict(es.fact.param_dims)
                shape = tuple(bp[q] if q in pd else 1 for q in block_order)
                bvals[i] = opvals[i].reshape((B,) + shape)
            return [torch.broadcast_to(torch.as_tensor(r), (B,) +
                                       self.tile_shape)
                    for r in chain_call(bvals)]
        f = _vmap_over(chain_call, _tile_axes(spec, block_order))
        return list(torch.func.vmap(f)(opvals))

    # -- the programs --------------------------------------------------------
    def run(self, values: Dict[str, torch.Tensor],
            prev: List[torch.Tensor]) -> List[torch.Tensor]:
        """Run the block program; returns one full-container tensor per
        output holding the written blocks (stitched by the caller)."""
        if self.spec.internal_wcr:
            return self._run_two_phase(values, prev)
        spec = self.spec
        device = prev[0].device
        chain_call = _chain_call(self.state, self.chain, spec)
        whole = self.whole_block
        news = [torch.zeros_like(p.reshape(1) if es.scalar else p)
                for p, es in zip(prev, spec.outputs)]
        grid_names = [p for p, _ in spec.grid]
        for kidx, rbatches in self._batches(device):
            accs = [None] * len(spec.outputs)
            for ridx in rbatches:
                ids = self._ids(kidx, ridx)
                opvals = {i: self._gather(values[es.data], es, ids)
                          for i, es in enumerate(spec.inputs)}
                results = self._apply(chain_call, opvals, whole)
                for oi, es in enumerate(spec.outputs):
                    val = torch.as_tensor(results[oi])
                    if es.wcr in WCR_MODES and spec.partial_tiles:
                        val = self._mask_partial(val, es, ids)
                    val = self._assemble(val, es)
                    val = val.reshape((len(kidx), len(ridx)) + val.shape[1:])
                    if es.wcr in WCR_MODES:
                        red = wcr_reduce(es.wcr, val, (1,))
                        accs[oi] = red if accs[oi] is None else \
                            wcr_combine(es.wcr, accs[oi], red)
                    else:  # revisited location: last write wins
                        accs[oi] = val[:, -1]
            kids = self._ids(kidx, torch.zeros(1, dtype=torch.long,
                                               device=device))
            kids = {p: v for p, v in kids.items() if p in grid_names}
            for oi, es in enumerate(spec.outputs):
                self._scatter(news[oi], es, kids, accs[oi])
        return news

    def _mask_partial(self, val, es: EdgeSpec, ids):
        pd = dict(es.fact.param_dims)
        for q, counter, ts, ext in self.spec.partial_tiles:
            if q in pd:
                continue
            ax = 1 + self.block_order.index(q)
            shape = [1] * val.dim()
            shape[ax] = val.shape[ax]
            lane = torch.arange(val.shape[ax], device=val.device).reshape(shape)
            cshape = [val.shape[0]] + [1] * (val.dim() - 1)
            gidx = ids[counter].reshape(cshape) * ts + lane
            val = torch.where(gidx < ext, val, torch.as_tensor(
                wcr_identity(es.wcr, val.dtype), dtype=val.dtype,
                device=val.device))
        return val

    def _run_two_phase(self, values, prev):
        spec, bp, block_order = self.spec, self.bp, self.block_order
        device = prev[0].device
        p2 = set(spec.phase2_nodes)
        p1_nodes = [ti for ti in range(len(self.chain)) if ti not in p2]
        wcr_keys = [w.key for w in spec.internal_wcr]
        kept_intra = set(spec.internal_wcr[0].kept_intra)
        kept_order = [q for q in block_order if q in kept_intra]
        red_axes = tuple(1 + i for i, q in enumerate(block_order)
                         if q not in kept_intra)

        def chain1(opvals):
            local, _ = _run_chain(self.state, self.chain, spec, opvals,
                                  p1_nodes)
            return tuple(local[k] for k in wcr_keys)

        def chain2(opvals, accs):
            _, results = _run_chain(self.state, self.chain, spec, opvals,
                                    sorted(p2), dict(zip(wcr_keys, accs)))
            return tuple(results)

        news = [torch.zeros_like(p.reshape(1) if es.scalar else p)
                for p, es in zip(prev, spec.outputs)]
        grid_names = [p for p, _ in spec.grid]
        f1 = _vmap_over(chain1, _tile_axes(spec, block_order))
        for kidx, rbatches in self._batches(device):
            accs = [None] * len(wcr_keys)
            for ridx in rbatches:
                ids = self._ids(kidx, ridx)
                opvals = {i: self._gather(values[es.data], es, ids)
                          for i, es in enumerate(spec.inputs)}
                vals1 = torch.func.vmap(f1)(opvals) if block_order \
                    else torch.func.vmap(chain1)(opvals)
                for k, (w, v) in enumerate(zip(spec.internal_wcr, vals1)):
                    part = wcr_reduce(w.wcr, v, red_axes) if red_axes else v
                    part = part.reshape((len(kidx), len(ridx)) +
                                        part.shape[1:])
                    part = wcr_reduce(w.wcr, part, (1,))
                    accs[k] = part if accs[k] is None else \
                        wcr_combine(w.wcr, accs[k], part)
            kids = self._ids(kidx, torch.zeros(1, dtype=torch.long,
                                               device=device))
            kids = {p: v for p, v in kids.items() if p in grid_names}
            opvals = {i: self._gather(values[es.data], es, kids)
                      for i, es in enumerate(spec.inputs)}
            f2 = chain2
            for q in reversed(kept_order):
                axes = {i: (0 if q in dict(es.fact.param_dims) else None)
                        for i, es in enumerate(spec.inputs)}
                f2 = torch.func.vmap(f2, in_dims=(axes, 0))
            results = torch.func.vmap(f2)(opvals, tuple(accs))
            for oi, es in enumerate(spec.outputs):
                val = torch.as_tensor(results[oi])
                if block_order:
                    trail = tuple(val.shape[1 + len(kept_order):])
                    val = val.reshape(
                        (val.shape[0],) + tuple(bp[q] if q in kept_intra
                                                else 1 for q in block_order)
                        + trail)
                    val = torch.broadcast_to(
                        val, (val.shape[0],) + self.tile_shape + trail)
                val = self._assemble(val, es)
                self._scatter(news[oi], es, kids, val)
        return news


# ---------------------------------------------------------------------------
# Launching the generated kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _load_module(src: str, name: str):
    """Import generated Triton source (``@triton.jit`` needs real source
    in a file). Triton is imported here and nowhere at module import, so
    the package imports where Triton is absent."""
    from ..kernels.build import build_dir
    root = build_dir()
    # keep Triton's compile cache inside the build directory
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "triton_cache"))
    import triton  # noqa: F401  (fails loudly where Triton is absent)
    digest = hashlib.sha1(src.encode()).hexdigest()[:16]
    path = root / f"{name}_{digest}.py"
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(src)
        tmp.replace(path)
    mod_name = f"repro_torch_generated_{name}_{digest}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def _num_warps(desc: KernelDesc) -> int:
    if desc.row:
        return 4
    elems = math.prod(b for _, _, b in desc.tiles)
    if any(a.window for a in desc.loads):
        elems = max(elems, CHUNK_ELEMS)
    return 4 if elems >= 512 else 1


def launch_plan(desc: KernelDesc, inputs: Dict[str, torch.Tensor],
                outputs: Dict[str, torch.Tensor]):
    """The launches of a generated kernel, in order: (function name, grid,
    arguments). ``inputs`` are read, ``outputs`` (copies of the prior
    contents) are written in place; a two-stage reduction adds its fp32
    partials buffer."""
    fn = _fn_name(desc)
    em = _TritonEmitter(desc, fn)
    args = [inputs[c] for c in em.in_args] + [outputs[c] for c in em.out_args]
    if desc.row:
        return [(f"{fn}_main", (desc.n_kept * desc.n_lanes,), args)]
    if desc.splits == 1:
        return [(f"{fn}_main", (desc.n_kept,), args)]
    parts = [torch.empty(desc.splits * desc.n_kept * em.part_size(),
                         dtype=torch.float32, device=args[0].device)
             for _ in desc.outputs]
    return [(f"{fn}_main", (desc.n_kept, desc.splits), args + parts),
            (f"{fn}_final", (desc.n_kept,), args + parts)]


def launch_kernel(desc: KernelDesc, src: str, inputs: Dict[str, torch.Tensor],
                  outputs: Dict[str, torch.Tensor]):
    """Launch a generated kernel on CUDA tensors (see :func:`launch_plan`)."""
    for c, t in list(inputs.items()) + list(outputs.items()):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"grid kernel {desc.name!r}: operand {c!r} must "
                             f"be a contiguous CUDA tensor")
    mod = _load_module(src, _fn_name(desc))
    warps = _num_warps(desc)
    for name, grid, args in launch_plan(desc, inputs, outputs):
        getattr(mod, name)[grid](*args, num_warps=warps)


class GridLaunchError(RuntimeError):
    """A scope that ``GridConversionPass`` converted cannot run its
    generated kernel (its annotation is missing or stale)."""


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch_or_plain(kernel: GridKernel, program: "GridProgram",
                     values: Dict[str, torch.Tensor],
                     current: Dict[str, torch.Tensor]):
    """The new contents of the output containers, and whether the kernel
    launched. CPU tensors run the plain block program; CUDA tensors launch
    the generated kernel."""
    if _on_cpu(list(values.values()) + list(current.values())):
        spec = program.spec
        news = program.run(values, [current[es.data] for es in spec.outputs])
        return stitch_results(spec, current, news), False
    ins = {c: (v.reshape(1) if v.dim() == 0 else v).contiguous()
           for c, v in values.items()}
    outs = {c: (v.reshape(1) if v.dim() == 0 else v).contiguous().clone()
            for c, v in current.items()}
    launch_kernel(kernel.desc, kernel.source, ins, outs)
    return {c: v.reshape(current[c].shape) for c, v in outs.items()}, True


#: callables run as ``fn(kernel, program, values, current)`` after each
#: launch of a generated kernel on the card, with the operands it read and
#: the prior contents of its outputs: a tool that times or checks a kernel
#: on the operands the main path gave it appends here
LAUNCH_OBSERVERS: List[Callable] = []


def _run_counted(wrapper, kernel: GridKernel, program: "GridProgram",
                 values, current) -> Dict[str, torch.Tensor]:
    out, launched = _launch_or_plain(kernel, program, values, current)
    if launched:
        name = kernel.desc.name
        wrapper.launches += 1
        wrapper.launches_by_name[name] = \
            wrapper.launches_by_name.get(name, 0) + 1
        for fn in LAUNCH_OBSERVERS:
            fn(kernel, program, values, current)
    return out


def run_grid_kernel(kernel: GridKernel, program: "GridProgram", values,
                    current) -> Dict[str, torch.Tensor]:
    """Wrapper of the single-phase emitter's kernels (the TPU kernel it
    replaces: ``repro/codegen/pallas_backend.py::PallasStateLowering.
    _emit_grid_kernel``); counts its launches, in all and per kernel."""
    return _run_counted(run_grid_kernel, kernel, program, values, current)


def run_two_phase(kernel: GridKernel, program: "GridProgram", values,
                  current) -> Dict[str, torch.Tensor]:
    """Wrapper of the two-phase emitter's kernels (the TPU kernel it
    replaces: ``repro/codegen/pallas_backend.py::PallasStateLowering.
    _emit_two_phase``); counts its launches, in all and per kernel."""
    return _run_counted(run_two_phase, kernel, program, values, current)


def reset_launch_counts():
    """Set both wrappers' launch counts to 0."""
    for wrapper in (run_grid_kernel, run_two_phase):
        wrapper.launches = 0
        wrapper.launches_by_name = {}


reset_launch_counts()


def stitch_results(spec: GridSpec, current: Dict[str, torch.Tensor],
                   results) -> Dict[str, torch.Tensor]:
    """Stitch each written box into the prior container contents (the
    reference's ``_stitch_results``): grid kernels only define the blocks
    their block coordinates touch; wcr outputs combine with the prior
    contents, other outputs are written only into their box. Two edges may
    target the same container, so each sees the previous one's result."""
    cur = dict(current)
    for es, new in zip(spec.outputs, results):
        prev = cur[es.data]
        if es.scalar:
            prev = prev.reshape(1)
        sl = tuple(slice(lo, hi) for lo, hi in es.box)
        if es.wcr in WCR_MODES:
            val = apply_wcr_at(prev, sl, es.wcr, new[sl])
        elif all((lo, hi) == (0, n) for (lo, hi), n
                 in zip(es.box, prev.shape)):
            val = new
        else:
            val = apply_wcr_at(prev, sl, None, new[sl])
        cur[es.data] = val.reshape(()) if es.scalar else val
    return cur


# ---------------------------------------------------------------------------
# State lowering
# ---------------------------------------------------------------------------


class CudaStateLowering(StateLowering):
    """State lowering that runs generated grid kernels for map scopes
    annotated by ``GridConversionPass`` and shares the structural
    interpreter for everything else. On CUDA tensors the generated Triton
    kernel launches; on CPU tensors its plain block program runs."""

    def _lower_map_custom(self, entry: MapEntry, exit_: MapExit,
                          inner: List) -> bool:
        spec: Optional[GridSpec] = entry.map.annotations.get(GRID_ANNOTATION)
        if spec is None:
            return False
        # GridConversionPass converted this scope and the report names its
        # kernel: a scope that cannot run it is an error, never a quiet
        # switch to the interpreter
        kernel = entry.map.annotations.get(KERNEL_ANNOTATION)
        if kernel is None:
            raise GridLaunchError(f"map {spec.kernel_name!r}: converted to a "
                                  f"grid kernel, but no kernel is attached")
        if not inner or not all(isinstance(n, Tasklet) for n in inner):
            raise GridLaunchError(f"map {spec.kernel_name!r}: the scope no "
                                  f"longer holds only tasklets")
        inner_set = set(inner)
        chain = [n for n in self.topological_nodes() if n in inner_set]
        labels = tuple(t.label for t in chain)
        if spec.tasklet_labels and labels != spec.tasklet_labels:
            raise GridLaunchError(
                f"map {spec.kernel_name!r}: stale grid annotation, the "
                f"tasklet chain {labels} differs from the kernel's "
                f"{spec.tasklet_labels}")
        values = {es.data: self.ensure_value(es.data) for es in spec.inputs}
        current = {es.data: self.ensure_value(es.data)
                   for es in spec.outputs}
        wrapper = run_two_phase if spec.internal_wcr else run_grid_kernel
        program = GridProgram(self.state, chain, spec, kernel.whole_block)
        self.env.update(wrapper(kernel, program, values, current))
        return True


def build_callable(sdfg: SDFG, device: torch.device):
    """Build fn(**arrays) using the grid-kernel lowering strategy."""
    return _build_callable(sdfg, device, lowering=CudaStateLowering)
