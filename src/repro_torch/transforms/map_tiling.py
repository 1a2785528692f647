"""MapTiling: split map dimensions into (tile-counter, intra-tile) pairs —
the platform-agnostic transformation the paper lists among the DaCe toolbox
(§3.2), used on Hopper to shape the block each generated grid program
covers.

Tiling is **multi-dimensional and alignment-aware**: every eligible map
parameter is split independently (mixed radix — one tile parameter per
dimension), and the default tile sizes follow the Hopper tile table
(``core.dtypes``) the way the paper's Vectorization transform (§3.2.4)
widens the FPGA data path: the minor (innermost) parameter tiles to the
vector width recorded by ``Vectorization`` (``sdfg.metadata
['vector_width']``, default 128 — one warp's 16-byte fp32 loads), the next
parameter to the **dtype-aware row count** (fp32 -> 16, bf16/fp16 -> 32,
int8/fp8 -> 64 — the narrowest container accessed by the scope wins,
falling back to the Vectorization-recorded ``sublane_width``). Tiles are
powers of two wherever the extent allows, because a Triton block's
``tl.arange`` extent must be one. Non-divisible extents are
remainder-safe: the tile
counter ranges over ``ceil(n / tile)`` blocks and the grid code generator
masks the partial final block (the structural interpreter enumerates only
valid lattice points).

Tiled maps are annotated with the tile structure: ``annotations['tiling']``
maps each intra-tile parameter to
``{"tile", "counter", "extent", "blocks", "start"}``. The grid code
generator (``GridConversionPass`` + ``cuda_backend``) consumes it to
derive block shapes: intra-tile parameters widen memlet index dimensions
into the block one program holds while tile-counter parameters become
grid dimensions. The annotation — not the ``_tiled`` label suffix, which
is purely cosmetic — is also what makes the transformation idempotent, so
fuse-after-tile and per-dimension re-tiling compose.

``range_equivalence`` is the annotation-aware iteration-space matcher
``MapFusion`` consults so that tiling and fusion commute: a tiled
producer matches an untiled consumer over the same underlying extent
(the consumer parameter renames onto ``start + counter*tile + intra``),
two maps tiled with the same annotation match pair-for-pair, and an
untiled producer facing a tiled consumer is retiled in place with the
consumer's tile structure.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..core.dtypes import (HOPPER_LANES, HOPPER_ROWS, ScheduleType,
                           rows_for_bytes)
from ..core.memlet import Range
from ..core.sdfg import Array, MapEntry, SDFG
from ..core.symbolic import Expr, sym
from .base import Transformation

#: schedules whose maps tile (grid-eligible schedules; UNROLLED / MESH
#: scopes are replicated hardware and keep their per-lane identity).
_TILABLE = (ScheduleType.PIPELINED, ScheduleType.DEVICE)


def normalize_tiling(ann: Dict) -> Dict[str, Dict]:
    """Normalize a ``tiling`` annotation to the rich per-parameter form.
    Legacy entries (``{param: extent_int}``) carry no counter/extent
    information and are treated as exactly-divisible."""
    out = {}
    for q, info in (ann or {}).items():
        if isinstance(info, dict):
            out[q] = info
        else:
            out[q] = {"tile": int(info), "counter": None,
                      "extent": None, "blocks": None}
    return out


def _pow2_floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _choose_tile(n: int, preferred: int,
                 floor: Optional[int] = None) -> Optional[int]:
    """Tile size for an extent of ``n`` elements given a preferred
    (alignment) width, rounded down to a power of two: the preferred width
    when it divides ``n``, else the largest power-of-two divisor of ``n``
    within [floor, preferred] (aligned blocks, no remainder; ``floor``
    defaults to preferred/4), else the preferred width with a masked
    partial final block. An extent that fits one block is one
    whole-dimension tile (the program's power-of-two block masks the lanes
    past it). None when ``n`` is too small to be worth splitting.

    A partial block is the last resort: its tile counter's range covers
    elements past the extent, which the static verifier's bounds check
    (BND001) reports, as it does for the reference's partial tiles."""
    if n <= 1 or preferred <= 1:
        return None
    preferred = _pow2_floor(preferred)
    if n <= preferred:
        return n                      # whole dimension in one block
    d = preferred
    while d >= max(2, preferred // 4 if floor is None else floor):
        if n % d == 0:
            return d
        d //= 2
    return preferred                  # ceil-division, masked partial block


# ---------------------------------------------------------------------------
# Annotation-aware iteration-space equivalence (MapFusion support)
# ---------------------------------------------------------------------------


def _logical_dims(m) -> Optional[List[Tuple]]:
    """Group a map's parameters into logical iteration dimensions: a
    MapTiling'd (counter, intra) pair is ONE dimension over its original
    extent; every other parameter is its own dimension. Entries are
    ``("tiled", counter, intra, info)`` / ``("plain", param, range)``.
    Returns None when the parameter order interleaves pairs in a way the
    positional reconstruction cannot express."""
    tiling = normalize_tiling(m.annotations.get("tiling"))
    rich = {q: info for q, info in tiling.items()
            if info.get("counter") in m.params
            and info.get("extent") is not None and q in m.params}
    counters = {info["counter"]: q for q, info in rich.items()}
    dims, order, seen = [], [], set()
    for p, r in zip(m.params, m.ranges):
        if p in seen:
            continue
        if p in rich:
            info = rich[p]
            dims.append(("tiled", info["counter"], p, info))
            seen |= {p, info["counter"]}
            order += [info["counter"], p]
        elif p in counters:
            q = counters[p]
            dims.append(("tiled", p, q, rich[q]))
            seen |= {p, q}
            order += [p, q]
        else:
            dims.append(("plain", p, r))
            order.append(p)
    if order != list(m.params):
        return None   # non-adjacent pair members: positional form ambiguous
    return dims


def range_equivalence(prod, cons, env: Dict[str, int]) -> Optional[Dict]:
    """Match the iteration spaces of a producer and consumer map up to
    MapTiling splits, using ``annotations['tiling']`` as the contract.

    Returns None when the spaces differ, else a plan::

        {"ren":       consumer param -> Expr over final producer params,
         "prod_repl": producer param -> Expr   (retile substitution; only
                      non-empty when an untiled producer dim must adopt
                      the consumer's tiling),
         "params", "ranges": the fused map's final parameter list,
         "sizes":     final param -> int range size (None if symbolic),
         "tiling":    tiling annotation entries the fused map must carry}
    """
    pdims, cdims = _logical_dims(prod), _logical_dims(cons)
    if pdims is None or cdims is None or len(pdims) != len(cdims):
        return None
    ren: Dict[str, Expr] = {}
    prod_repl: Dict[str, Expr] = {}
    params: List[str] = []
    ranges: List[Range] = []
    tiling: Dict[str, Dict] = {}
    plain_pairs = []
    taken = set(prod.params)

    def _static(e) -> Optional[int]:
        try:
            return int(Expr.wrap(e).evaluate(env))
        except Exception:
            return None

    def _info_nums(info) -> Optional[Tuple[int, int, int, int]]:
        start = info.get("start", 0)
        if start is None:
            return None
        try:
            return (int(info["tile"]), int(info["extent"]),
                    int(info["blocks"]), int(start))
        except (KeyError, TypeError, ValueError):
            return None

    def _fresh(name: str) -> str:
        while name in taken:
            name += "_f"
        taken.add(name)
        return name

    for pd, cd in zip(pdims, cdims):
        if pd[0] == "plain" and cd[0] == "plain":
            _, pp, pr = pd
            _, cp, cr = cd
            if cp != pp:
                ren[cp] = Expr.sym(pp)
            plain_pairs.append((pr, cr))
            params.append(pp)
            ranges.append(pr)
        elif pd[0] == "tiled" and cd[0] == "tiled":
            _, pctr, pq, pinfo = pd
            _, cctr, cq, cinfo = cd
            pn, cn = _info_nums(pinfo), _info_nums(cinfo)
            if pn is None or cn is None or pn != cn:
                return None
            if cctr != pctr:
                ren[cctr] = Expr.sym(pctr)
            if cq != pq:
                ren[cq] = Expr.sym(pq)
            params += [pctr, pq]
            ranges += [Range.make(0, pn[2]), Range.make(0, pn[0])]
            tiling[pq] = dict(pinfo)
        elif pd[0] == "tiled":
            # tiled producer, untiled consumer: the consumer parameter is
            # the composed producer index
            _, pctr, pq, pinfo = pd
            _, cp, cr = cd
            pn = _info_nums(pinfo)
            cs, csz, cst = _static(cr.start), _static(cr.size), \
                _static(cr.step)
            if pn is None or None in (cs, csz, cst):
                return None
            if cst != 1 or cs != pn[3] or csz != pn[1]:
                return None
            taken |= {pctr, pq}
            ren[cp] = (Expr.const(pn[3]) + Expr.sym(pctr) * pn[0]
                       + Expr.sym(pq))
            params += [pctr, pq]
            ranges += [Range.make(0, pn[2]), Range.make(0, pn[0])]
            tiling[pq] = dict(pinfo)
        else:
            # untiled producer, tiled consumer: retile the producer in
            # place with the consumer's tile structure
            _, pp, pr = pd
            _, cctr, cq, cinfo = cd
            cn = _info_nums(cinfo)
            ps, psz, pst = _static(pr.start), _static(pr.size), \
                _static(pr.step)
            if cn is None or None in (ps, psz, pst):
                return None
            if pst != 1 or ps != cn[3] or psz != cn[1]:
                return None
            taken.discard(pp)         # pp is being replaced: its name frees up
            nctr, nq = _fresh(cctr), _fresh(cq)
            prod_repl[pp] = (Expr.const(cn[3]) + Expr.sym(nctr) * cn[0]
                             + Expr.sym(nq))
            if cctr != nctr:
                ren[cctr] = Expr.sym(nctr)
            if cq != nq:
                ren[cq] = Expr.sym(nq)
            params += [nctr, nq]
            ranges += [Range.make(0, cn[2]), Range.make(0, cn[0])]
            tiling[nq] = {**cinfo, "counter": nctr}
    for pr, cr in plain_pairs:
        if cr.subs(ren) != pr:
            return None
    sizes = {p: _static(r.size) for p, r in zip(params, ranges)}
    return {"ren": ren, "prod_repl": prod_repl, "params": params,
            "ranges": ranges, "sizes": sizes, "tiling": tiling or None}


class MapTiling(Transformation):
    """Split every eligible parameter of PIPELINED/DEVICE maps into a
    (counter, intra) pair. ``tile_size`` overrides the preferred *minor*
    (lane) width of the default policy and ``second_size`` the preferred
    second-minor (sublane) width — like the defaults, they plan each
    map exactly once (an already-annotated map is left alone, so fixpoint
    re-matches cannot whole-tile deliberately-skipped dims). Only
    ``tile_sizes`` — explicit per-parameter tiles — composes with earlier
    tilings, one dimension at a time."""

    def __init__(self, tile_size: int = None, map_label: str = None,
                 tile_sizes: Dict[str, int] = None, second_size: int = None):
        self.tile_size = tile_size
        self.map_label = map_label
        self.tile_sizes = tile_sizes
        self.second_size = second_size

    # ------------------------------------------------------------------
    def _scope_nodes(self, st, entry: MapEntry) -> set:
        scopes = st.scope_children()
        nodes = {entry}
        stack = list(scopes.get(entry, []))
        while stack:
            nd = stack.pop()
            if nd in nodes:
                continue
            nodes.add(nd)
            if isinstance(nd, MapEntry):
                stack.extend(scopes.get(nd, []))
        return nodes

    def _shared_dim_params(self, sdfg: SDFG, st, entry: MapEntry,
                          nodes: set) -> set:
        """Parameters that co-index a memlet dimension with another map
        parameter (e.g. ``x[c*K + l]``), that index a dimension with a
        non-unit coefficient (strided access like a pooling read
        ``t[2*ph + u]``), or that offset a non-unit *range* (a windowed
        read like a conv's ``x[ow:ow+5]``): splitting any of these would
        need a block index map BlockSpec factorization cannot express —
        leave them whole."""
        from ..core.symbolic import Expr
        pset = set(entry.map.params)
        shared = set()
        for e in st.edges:
            if e.src not in nodes and e.dst not in nodes:
                continue
            if e.memlet.subset is None:
                continue
            for r in e.memlet.subset:
                used = (r.start.free_symbols | r.stop.free_symbols) & pset
                if len(used) > 1:
                    shared |= used
                if used and not r.is_index():
                    shared |= used
                for expr in (r.start, r.stop):
                    for mono, c in Expr.wrap(expr).terms.items():
                        for name, _ in mono:
                            if name in pset and abs(c) != 1:
                                shared.add(name)
        return shared

    def _scope_sublanes(self, sdfg: SDFG, st, entry: MapEntry,
                        nodes: set) -> int:
        """Dtype-aware row preference for one scope: the narrowest Array
        element among the containers its memlets touch decides the block
        rows (fp32 -> 16, bf16 -> 32, int8 -> 64); scopes touching no
        sized array fall back to the Vectorization-recorded default."""
        min_bytes = None
        for e in st.edges:
            if e.src not in nodes and e.dst not in nodes:
                continue
            desc = sdfg.arrays.get(e.memlet.data) \
                if e.memlet.data is not None else None
            if isinstance(desc, Array) and not desc.is_stream and desc.shape:
                b = desc.dtype.bytes
                min_bytes = b if min_bytes is None else min(min_bytes, b)
        if min_bytes is None:
            return sdfg.metadata.get("sublane_width") or HOPPER_ROWS
        return rows_for_bytes(min_bytes)

    def _plan(self, sdfg: SDFG, st, entry: MapEntry,
              tile_size: int, tile_sizes: Dict[str, int],
              second_size: int = None) -> Dict[str, int]:
        """Per-parameter tile plan for one map (param -> tile size)."""
        m = entry.map
        tiling = normalize_tiling(m.annotations.get("tiling"))
        counters = {info.get("counter") for info in tiling.values()}
        if tiling and not tile_sizes:
            # the default policy plans a map exactly once: params it left
            # untiled (small second dims, outer/batch dims) were left
            # deliberately — a fixpoint re-match must not whole-tile them
            # as fresh "minor" dims. Explicit tile_sizes still compose.
            return {}
        env = sdfg.symbol_values
        sizes = {}
        for p, r in zip(m.params, m.ranges):
            if p in tiling or p in counters:
                continue              # already tiled: idempotence
            try:
                sizes[p] = int(r.size.evaluate(env))
            except Exception:
                continue              # dynamic extent: cannot tile
        if not sizes:
            return {}
        nodes = self._scope_nodes(st, entry)
        shared = self._shared_dim_params(sdfg, st, entry, nodes)
        candidates = [p for p in m.params if p in sizes and p not in shared]
        if not candidates:
            return {}
        plan: Dict[str, int] = {}
        if tile_sizes:
            for p in candidates:
                if p in tile_sizes and sizes[p] > 1:
                    plan[p] = max(1, min(int(tile_sizes[p]), sizes[p]))
            return plan
        lanes = tile_size or sdfg.metadata.get("vector_width") or HOPPER_LANES
        sublanes = second_size or self._scope_sublanes(sdfg, st, entry, nodes)
        minor = candidates[-1]
        if len(m.params) == 1:
            # a 1-D map only tiles when it yields >= 2 blocks (a whole-dim
            # block would collapse the grid to a single step)
            if sizes[minor] > lanes:
                plan[minor] = _choose_tile(sizes[minor], lanes)
        else:
            t = _choose_tile(sizes[minor], lanes)
            if t is not None:
                plan[minor] = t
            if len(candidates) >= 2:
                second = candidates[-2]
                if sizes[second] > sublanes:
                    # rows search down to the reference's floor for the
                    # dtype: its row table is half the port's, searched
                    # down to a quarter (fp32: 8 rows -> 2)
                    t2 = _choose_tile(sizes[second], sublanes,
                                      floor=max(2, sublanes // 8))
                    if t2 is not None:
                        plan[second] = t2
        return {p: t for p, t in plan.items() if t and t >= 1}

    # ------------------------------------------------------------------
    def find_matches(self, sdfg: SDFG, tile_size: int = None,
                     map_label: str = None, tile_sizes: Dict[str, int] = None,
                     second_size: int = None, **kwargs):
        ts = tile_size if tile_size is not None else self.tile_size
        label = map_label or self.map_label
        explicit = tile_sizes if tile_sizes is not None else self.tile_sizes
        second = second_size if second_size is not None else self.second_size
        for st in sdfg.states:
            for node in st.nodes:
                if not isinstance(node, MapEntry):
                    continue
                m = node.map
                if label and not m.label.startswith(label):
                    continue
                if m.schedule not in _TILABLE:
                    continue
                plan = self._plan(sdfg, st, node, ts, explicit, second)
                if plan:
                    yield {"state": st, "entry": node, "plan": plan}

    def apply_match(self, sdfg: SDFG, match: Dict):
        st, entry, plan = match["state"], match["entry"], match["plan"]
        m = entry.map
        env = sdfg.symbol_values
        ann = m.annotations.setdefault("tiling", {})
        new_params, new_ranges, repl = [], [], {}
        for p, r in zip(m.params, m.ranges):
            if p not in plan:
                new_params.append(p)
                new_ranges.append(r)
                continue
            ts = plan[p]
            n = int(r.size.evaluate(env))
            blocks = math.ceil(n / ts)
            lo = r.start
            try:
                start = int(lo.evaluate(env))
            except Exception:
                start = None          # symbolic start: fusion equivalence
                                      # across this split is refused
            pt, pi = f"{p}_tile", f"{p}_in"
            new_params += [pt, pi]
            new_ranges += [Range.make(0, blocks), Range.make(0, ts)]
            ann[pi] = {"tile": ts, "counter": pt, "extent": n,
                       "blocks": blocks, "start": start}
            # rewrite memlets in the scope: p -> lo + p_tile*ts + p_in
            repl[p] = lo + sym(pt) * ts + sym(pi)
        m.params = new_params
        m.ranges = new_ranges
        if not m.label.endswith("_tiled"):
            m.label += "_tiled"
        nodes = self._scope_nodes(st, entry)
        for e in st.edges:
            if e.src in nodes or e.dst in nodes:
                if e.memlet.subset is not None:
                    e.memlet.subset = e.memlet.subset.subs(repl)
