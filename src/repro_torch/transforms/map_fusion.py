"""MapFusion: fuse producer->consumer map scopes over matching ranges.

The paper's streaming composition removes an off-chip round-trip by
turning the intermediate container into a FIFO between two processing
elements. MapFusion is the tighter, whole-dataflow variant (cf. FLOWER's
fusion of adjacent processing stages): when a map writes a transient that
a second map reads back, the two scopes merge into one and the
intermediate stops being a container access altogether — it becomes a
per-iteration value carried on a direct tasklet->tasklet edge inside the
fused scope. On TPU the fused scope lowers to a single Pallas grid kernel
whose intermediate lives in registers/VMEM, where the unfused pair was
two kernel launches with an HBM array between them.

Three fusion modes, tried in order per (intermediate, consumer) match:

**exact** — the original whole-dataflow fusion: producer and consumer
iterate equivalent spaces (up to MapTiling splits,
:func:`transforms.map_tiling.range_equivalence`) and every consumer read
is element-for-element the producer's write. Handles producer DAGs,
multi-intermediate groups, scalar intermediates, and fuse-across-tiling
exactly as before.

**wcr** — a producer whose write carries write-conflict resolution
(``wcr="add"``) feeds a consumer that reads the finished reduction
element-exactly. The scopes merge over the *producer's* space (which
carries the reduction parameters); the intermediate becomes an
accumulating tasklet->tasklet edge (``Memlet(wcr="add")``) inside the
fused scope. The sequential interpreter accumulates in place and the
consumer's final re-execution wins; the vectorizing backends lower this
as a two-phase accumulate+consume grid (jnp: reduce between two vmapped
phases; Pallas: scratch accumulation with a ``@pl.when`` phase flip).
Restricted to ``add`` because its identity matches the zero-initialized
intermediate; the consumer must be idempotent under re-execution
(side-effect free, never reading a container it writes).

**halo** — the write-order = read-order rule shared with
StreamingComposition (:func:`transforms.streaming.solve_write_read_sigma`):
a producer writing ``t[p + c]`` per iteration and a consumer reading
``t[f(q)]`` fuse whenever the affine renaming ``sigma(p) = f(q) - c``
maps the consumer's iteration box into the producer's. The producer's
tasklets are *replicated* into the consumer scope once per distinct
``sigma`` (shifted-window reads of a stencil stage become shifted
replicas reading the producer's inputs directly), with content-addressed
deduplication so chained stencils grow linearly (a depth-k radius-1
chain costs 1+3+...+(2k-1) tasklets, not 3^k). Multi-consumer
intermediates fuse the same way: each consumer gets its own replicas and
the producer is kept while other readers remain (``keep``) or deleted
with the intermediate once the last reader fuses.

Legality (checked per match, mirrored by tests/test_map_fusion.py):

  * each intermediate is a transient ``Array``/``Scalar`` accessed at
    exactly one node in the whole SDFG, written once by the producer's
    exit; exact mode additionally requires the consumer's entry to be
    its only reader;
  * exact mode: iteration spaces equivalent under ``range_equivalence``,
    reads element-exact under the renaming, writes disjoint across
    iterations (:func:`_injective_write`), no wcr anywhere on the
    intermediate;
  * halo mode: both scopes untiled with static unit-step ranges, the
    write an injective unit-coefficient parameter shift, every read an
    affine index whose ``sigma`` image is covered by the producer's box,
    and the replication budget (``max_fused_tasklets``,
    ``max_replicated_producer`` for kept producers) not exceeded;
  * wcr mode: ``add`` only, single intermediate and single consumer,
    element-exact reads pairing consumer params to the write's output
    params over equal ranges, with at least one genuine reduction
    parameter left over;
  * both scopes contain only tasklets, and fusing must not reorder
    accesses to any *other* container shared between the two scopes.

Refusals record a typed reason (``MapFusion.explain``) that the pipeline
surfaces in ``report["grid_skipped"]`` / ``grid_decisions``.

After fusion each fully-consumed intermediate's descriptor is retargeted
to registers (``StorageType.REG``): it no longer appears at any access
node, so it contributes nothing to the off-chip volume metric. Fused
labels join the component labels with ``+`` (stripping the cosmetic
``_tiled`` suffix from components, re-appending it when the fused map
carries tiling annotations), so fuse-then-tile and tile-then-fuse name
the same kernel.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import networkx as nx

from ..core.dtypes import ScheduleType, StorageType
from ..core.memlet import Memlet, Subset
from ..core.sdfg import (AccessNode, Array, MapEntry, MapExit, Scalar, SDFG,
                         State, Stream, Tasklet)
from ..core.symbolic import Expr
from .base import Transformation
from .map_tiling import range_equivalence
from .streaming import affine_decompose, sigma_covered, solve_write_read_sigma

#: schedules whose scopes may fuse (grid-eligible schedules; UNROLLED /
#: MESH scopes are replicated hardware and keep their own identity).
_FUSIBLE = (ScheduleType.PIPELINED, ScheduleType.DEVICE)


def _consumer_entry(state: State, node: AccessNode) -> Optional[MapEntry]:
    """The single MapEntry consuming ``node``, or None."""
    dsts = {e.dst for e in state.out_edges(node)}
    if len(dsts) != 1:
        return None
    (dst,) = dsts
    return dst if isinstance(dst, MapEntry) else None


def _scope_tasklets(state: State, scopes, entry: MapEntry):
    """Directly-contained nodes minus the exit; None if any is not a
    Tasklet (nested maps / access nodes keep their scopes separate)."""
    inner = [n for n in scopes.get(entry, []) if not isinstance(n, MapExit)]
    if not inner or not all(isinstance(n, Tasklet) for n in inner):
        return None
    return inner


def _fusible_desc(desc) -> bool:
    return (isinstance(desc, (Array, Scalar)) and not isinstance(desc, Stream)
            and desc.transient)


def _scalar_like(desc) -> bool:
    return not getattr(desc, "shape", ())


def _base_label(lbl: str) -> str:
    return lbl[:-len("_tiled")] if lbl.endswith("_tiled") else lbl


def _group(state: State, px: MapExit, ce: MapEntry) -> Optional[List[AccessNode]]:
    """Every access node carried from ``px`` into ``ce``. All of them
    must fuse together (a leftover container between the pair would put a
    cycle through the fused scope); an access node that also feeds a
    third consumer poisons the whole pair — returns None."""
    members = []
    for e in state.out_edges(px):
        dst = e.dst
        if not isinstance(dst, AccessNode):
            continue
        outs = state.out_edges(dst)
        to_ce = [o for o in outs if o.dst is ce]
        if not to_ce:
            continue
        if len(to_ce) != len(outs):
            return None
        members.append(dst)
    return members or None


def _injective_write(subset: Optional[Subset],
                     sizes: Dict[str, Optional[int]]) -> bool:
    """True when the write subset touches a distinct location on every
    iteration of the (final) parameter space. Parameters whose range has
    a single iteration cannot revisit anything and are exempt; a
    dimension combining several parameters is accepted exactly when its
    coefficients form a positional (mixed-radix) system — the MapTiling
    ``start + counter*tile + intra`` shape — and rejected otherwise
    (``t[i+j]`` collides across iterations)."""
    used = set()
    pset = set(sizes)
    if subset is None or len(subset) == 0:
        return all(sz == 1 for sz in sizes.values())
    for r in subset:
        rsyms = (r.start.free_symbols | r.stop.free_symbols
                 | r.step.free_symbols)
        if (rsyms & pset) and not r.is_index():
            return False
        terms = []
        for mono, c in r.start.terms.items():
            if mono == ():
                continue
            names = [nm for nm, _ in mono]
            if not any(nm in pset for nm in names):
                continue
            if len(mono) != 1 or mono[0][1] != 1:
                return False          # non-affine in a parameter
            name = mono[0][0]
            if isinstance(c, Fraction):
                if c.denominator != 1:
                    return False
                c = c.numerator
            coeff = abs(int(c))
            if coeff == 0:
                continue
            sz = sizes.get(name)
            if sz is None:
                return False          # dynamic extent: cannot prove
            if sz <= 1:
                continue              # single iteration: no collision
            if name in used:
                return False          # same param indexes two dimensions
            terms.append((coeff, sz, name))
        terms.sort()
        span = 0
        for coeff, sz, name in terms:
            if coeff <= span:
                return False          # offsets of smaller terms overlap
            span += coeff * (sz - 1)
        used |= {name for _, _, name in terms}
    covering = {p for p, sz in sizes.items() if sz is None or sz > 1}
    return covering <= used


def _expr_key(e) -> tuple:
    return tuple(sorted(Expr.wrap(e).terms.items()))


def _subset_key(sub: Optional[Subset]):
    if sub is None:
        return None
    return tuple((_expr_key(r.start), _expr_key(r.stop), _expr_key(r.step))
                 for r in sub)


def _sigma_key(sigma: Dict[str, Expr]) -> tuple:
    return tuple(sorted((p, _expr_key(e)) for p, e in sigma.items()))


def _edge_symbols(memlet: Memlet) -> set:
    out = set()
    if memlet.subset is not None:
        for r in memlet.subset:
            out |= (r.start.free_symbols | r.stop.free_symbols
                    | r.step.free_symbols)
    return out


def prune_dead_scopes(sdfg: SDFG) -> List[str]:
    """Remove tasklet-only fusible scopes whose every output is an
    unread single-access transient (side-effect free dead code). Arises
    when halo fusion replicates a kept producer into its last remaining
    consumer: the producer's outputs lose their readers but the scope
    itself survives. Returns the removed map labels."""
    removed: List[str] = []
    for st in sdfg.states:
        changed = True
        while changed:
            changed = False
            scopes = st.scope_children()
            for entry, children in list(scopes.items()):
                if entry is None or entry.map.schedule not in _FUSIBLE:
                    continue
                inner = [n for n in children if not isinstance(n, MapExit)]
                if not inner or not all(
                        isinstance(n, Tasklet)
                        and getattr(n, "side_effect_free", True)
                        for n in inner):
                    continue
                px = next((n for n in children
                           if isinstance(n, MapExit) and n.entry is entry),
                          None)
                if px is None:
                    continue
                outs = st.out_edges(px)
                dead = True
                for e in outs:
                    dst = e.dst
                    if not isinstance(dst, AccessNode):
                        dead = False
                        break
                    desc = sdfg.arrays.get(dst.data)
                    if (desc is None or not getattr(desc, "transient", False)
                            or st.out_degree(dst) != 0
                            or st.in_degree(dst) != 1
                            or dst.data in sdfg.metadata.get("pin_hbm", ())):
                        dead = False
                        break
                    count = sum(1 for s in sdfg.states for n in s.data_nodes()
                                if n.data == dst.data)
                    if count != 1:
                        dead = False
                        break
                if not dead:
                    continue
                removed.append(entry.map.label)
                srcs = [e.src for e in st.in_edges(entry)]
                for n in [entry, px] + inner + [e.dst for e in outs]:
                    if n in st.graph:
                        st.remove_node(n)
                for s in srcs:
                    if (s in st.graph and st.graph.degree(s) == 0
                            and isinstance(s, AccessNode)):
                        desc = sdfg.arrays.get(s.data)
                        if desc is not None and getattr(desc, "transient",
                                                        False):
                            st.remove_node(s)
                changed = True
                break
    return removed


class MapFusion(Transformation):
    """Transient array/scalar node(s) between a map exit and a map entry
    -> merge the scopes (exact), fuse through the reduction (wcr), or
    replicate shifted producer tasklets into the consumer (halo)."""

    def __init__(self, max_fused_tasklets: int = 48,
                 max_replicated_producer: int = 4):
        #: refuse fusions whose fused scope would exceed this many
        #: tasklets after halo replication (content-deduplicated count)
        self.max_fused_tasklets = max_fused_tasklets
        #: refuse halo replication that keeps the producer alive (other
        #: readers remain) when the producer has more tasklets than this
        self.max_replicated_producer = max_replicated_producer
        #: typed reason for the most recent can_apply refusal
        self._reason: Optional[str] = None

    def find_matches(self, sdfg: SDFG, **kwargs):
        for st in sdfg.states:
            for node in st.data_nodes():
                desc = sdfg.arrays.get(node.data)
                if desc is None or not _fusible_desc(desc):
                    continue
                if st.in_degree(node) != 1:
                    continue
                if not isinstance(st.in_edges(node)[0].src, MapExit):
                    continue
                seen = set()
                for e in st.out_edges(node):
                    if isinstance(e.dst, MapEntry) and id(e.dst) not in seen:
                        seen.add(id(e.dst))
                        yield {"state": st, "node": node, "consumer": e.dst}

    # ------------------------------------------------------------------
    def _write_edge(self, st: State, px: MapExit, t: str):
        w_edges = [e for e in st.in_edges(px) if e.memlet.data == t]
        return w_edges[0] if len(w_edges) == 1 else None

    def _static_ranges(self, m, env) -> Optional[Dict[str, Tuple[int, int]]]:
        """param -> (start, size) for unit-step static ranges, else None."""
        out: Dict[str, Tuple[int, int]] = {}
        for p, r in zip(m.params, m.ranges):
            try:
                start = r.start.subs(env).as_int()
                stop = r.stop.subs(env).as_int()
                step = r.step.subs(env).as_int()
            except (ValueError, KeyError, TypeError):
                return None
            if step != 1 or stop - start < 1:
                return None
            out[p] = (start, stop - start)
        return out

    def _member_legal(self, sdfg: SDFG, st: State, member: AccessNode,
                      px: MapExit, ce: MapEntry, plan: Dict) -> bool:
        t = member.data
        desc = sdfg.arrays.get(t)
        if desc is None or not _fusible_desc(desc):
            return False
        if t in sdfg.metadata.get("pin_hbm", ()):
            return False
        # the one access node in the whole SDFG (no cross-PE aliasing)
        count = sum(1 for s in sdfg.states for n in s.data_nodes()
                    if n.data == t)
        if count != 1 or st.in_degree(member) != 1:
            return False
        in_e = st.in_edges(member)[0]
        if in_e.src is not px or in_e.memlet.wcr is not None:
            return False
        w = self._write_edge(st, px, t)
        if w is None or w.memlet.wcr is not None or w.memlet.dynamic:
            return False
        scalar = _scalar_like(desc)
        if w.memlet.subset is None and not scalar:
            return False
        wsub = w.memlet.subset.subs(plan["prod_repl"]) \
            if w.memlet.subset is not None else None
        # writes must be disjoint across iterations — otherwise the fused
        # consumer reads its iteration's private value where the
        # sequential schedule delivered the LAST write
        if not _injective_write(wsub, plan["sizes"]):
            return False
        # every consumer read must be the element the producer just wrote
        r_edges = [e for e in st.out_edges(ce) if e.memlet.data == t]
        if not r_edges:
            return False
        for e in r_edges:
            if e.memlet.wcr is not None or e.memlet.dynamic:
                return False
            rsub = e.memlet.subset
            if rsub is None and wsub is None:
                continue              # whole-scalar write, whole-scalar read
            if rsub is None or wsub is None:
                return False
            if rsub.subs(plan["ren"]) != wsub:
                return False
        return True

    # ------------------------------------------------------------------
    def can_apply(self, sdfg: SDFG, match: Dict) -> bool:
        self._reason = None
        st: State = match["state"]
        node: AccessNode = match["node"]
        if node not in st.graph:
            return False
        desc = sdfg.arrays.get(node.data)
        if desc is None or not _fusible_desc(desc):
            return False
        if st.in_degree(node) != 1:
            return False
        in_e = st.in_edges(node)[0]
        if not isinstance(in_e.src, MapExit):
            return False
        px: MapExit = in_e.src
        ce = match.get("consumer")
        if ce is None:
            ce = _consumer_entry(st, node)
            match["consumer"] = ce
        if (ce is None or ce not in st.graph or not isinstance(ce, MapEntry)
                or ce is px.entry):
            return False
        if not any(e.dst is ce for e in st.out_edges(node)):
            return False
        prod, cons = px.map, ce.map
        if prod.schedule not in _FUSIBLE or cons.schedule not in _FUSIBLE:
            return False
        scopes = st.scope_children()
        if _scope_tasklets(st, scopes, px.entry) is None:
            return False
        if _scope_tasklets(st, scopes, ce) is None:
            return False
        cx = next((n for n in st.nodes
                   if isinstance(n, MapExit) and n.entry is ce), None)
        if cx is None:
            return False

        # exact first — it is free (no replication) and preserves the
        # historical behavior when the consumer is the sole reader
        if _consumer_entry(st, node) is ce:
            if self._can_apply_exact(sdfg, st, node, px, ce, cx):
                match["mode"] = "exact"
                return True
        w = self._write_edge(st, px, node.data)
        if w is not None and w.memlet.wcr is not None:
            if self._can_apply_wcr(sdfg, st, node, px, ce, cx, match):
                match["mode"] = "wcr"
                return True
            return False
        if self._can_apply_halo(sdfg, st, node, px, ce, cx, match):
            match["mode"] = "halo"
            return True
        return False

    # -- exact mode ----------------------------------------------------
    def _can_apply_exact(self, sdfg: SDFG, st: State, node: AccessNode,
                         px: MapExit, ce: MapEntry, cx: MapExit) -> bool:
        prod, cons = px.map, ce.map
        plan = range_equivalence(prod, cons, sdfg.symbol_values)
        if plan is None:
            return False
        members = _group(st, px, ce)
        if members is None or node not in members:
            return False
        for member in members:
            if not self._member_legal(sdfg, st, member, px, ce, plan):
                return False
        tset = {m.data for m in members}
        # renaming must not capture a consumer-scope symbol that already
        # means something else (a free symbol equal to a fused-map param)
        cons_free = set()
        for e in st.out_edges(ce) + st.in_edges(cx):
            cons_free |= _edge_symbols(e.memlet)
        cons_free -= set(cons.params)
        if cons_free & set(plan["params"]):
            return False
        if not self._hazards_ok(st, px, ce, cx, tset):
            return False
        # no consumer input may depend on the producer through a path
        # OTHER than the fused intermediates (a third scope in between):
        # rerouting those inputs to the fused entry would create a cycle
        member_set = set(members)
        for e in st.in_edges(ce):
            if e.src in member_set:
                continue
            if nx.has_path(st.graph, px, e.src):
                return False
        return True

    def _hazards_ok(self, st: State, px: MapExit, ce: MapEntry, cx: MapExit,
                    tset: set) -> bool:
        """Fusing must not reorder accesses to other shared containers."""
        prod_writes = {e.memlet.data for e in st.in_edges(px)
                       if e.memlet.data} - tset
        prod_reads = {e.memlet.data for e in st.out_edges(px.entry)
                      if e.memlet.data}
        cons_reads = {e.memlet.data for e in st.out_edges(ce)
                      if e.memlet.data} - tset
        cons_writes = {e.memlet.data for e in st.in_edges(cx)
                       if e.memlet.data}
        if prod_writes & (cons_reads | cons_writes):
            self._reason = ("fusion would reorder accesses to a container "
                            "both scopes touch")
            return False
        if cons_writes & prod_reads:
            self._reason = ("fusion would reorder accesses to a container "
                            "both scopes touch")
            return False
        return True

    # -- halo mode -----------------------------------------------------
    def _can_apply_halo(self, sdfg: SDFG, st: State, node: AccessNode,
                        px: MapExit, ce: MapEntry, cx: MapExit,
                        match: Dict) -> bool:
        prod, cons = px.map, ce.map
        pe = px.entry
        if prod.annotations.get("tiling") or cons.annotations.get("tiling"):
            self._reason = ("halo fusion requires untiled scopes "
                            "(runs before MapTiling)")
            return False
        env = sdfg.symbol_values
        prod_rngs = self._static_ranges(prod, env)
        cons_rngs = self._static_ranges(cons, env)
        if prod_rngs is None or cons_rngs is None:
            self._reason = ("halo fusion requires static unit-step "
                            "iteration ranges")
            return False
        scopes = st.scope_children()
        prod_tasklets = _scope_tasklets(st, scopes, pe)
        cons_inner = _scope_tasklets(st, scopes, ce)

        # halo group: every access node the producer feeds into this
        # consumer; anything else the producer writes keeps it alive
        members: List[AccessNode] = []
        keep = False
        for e in st.out_edges(px):
            dst = e.dst
            if not isinstance(dst, AccessNode):
                keep = True
                continue
            outs = st.out_edges(dst)
            if not any(o.dst is ce for o in outs):
                keep = True
                continue
            if dst not in members:
                members.append(dst)
            if any(o.dst is not ce for o in outs):
                keep = True
        if node not in members:
            return False
        tset = {m.data for m in members}

        writer_of: Dict[str, Tuple[Tasklet, str]] = {}
        w_subsets: Dict[str, Optional[Subset]] = {}
        for member in members:
            t = member.data
            desc = sdfg.arrays.get(t)
            if desc is None or not _fusible_desc(desc):
                self._reason = f"intermediate {t} is not a fusible transient"
                return False
            if t in sdfg.metadata.get("pin_hbm", ()):
                self._reason = f"intermediate {t} is pinned to HBM"
                return False
            count = sum(1 for s in sdfg.states for n in s.data_nodes()
                        if n.data == t)
            if count != 1 or st.in_degree(member) != 1:
                self._reason = (f"intermediate {t} is accessed at more than "
                                f"one node")
                return False
            in_e = st.in_edges(member)[0]
            if in_e.src is not px:
                return False
            w = self._write_edge(st, px, t)
            if w is None or w.memlet.dynamic:
                self._reason = f"intermediate {t} has no unique static write"
                return False
            if w.memlet.wcr is not None or in_e.memlet.wcr is not None:
                self._reason = "intermediate group mixes wcr and plain writes"
                return False
            writer_of[t] = (w.src, w.src_conn)
            w_subsets[t] = w.memlet.subset

        # producer structure: side-effect-free tasklets with plain edges,
        # every external input traceable to an outer source
        prod_set = set(prod_tasklets)
        for T in prod_tasklets:
            if not getattr(T, "side_effect_free", True):
                self._reason = ("producer tasklet is not side-effect free "
                                "(cannot replicate)")
                return False
            if st.in_degree(T) == 0:
                self._reason = ("producer tasklet without inputs cannot be "
                                "replicated into the consumer scope")
                return False
        prod_src = {e.memlet.data: e.src for e in st.in_edges(pe)
                    if e.memlet.data is not None}
        cparams = set(cons.params)
        pparams = set(prod.params)
        for e in st.edges:
            inside = ((e.src is pe or e.src in prod_set)
                      and (e.dst in prod_set or e.dst is px))
            if not inside:
                continue
            if e.memlet.wcr is not None or e.memlet.dynamic:
                self._reason = "producer carries wcr or dynamic edges"
                return False
            if (_edge_symbols(e.memlet) - pparams) & cparams:
                self._reason = ("producer memlet captures a consumer "
                                "parameter name")
                return False
            if e.src is pe:
                d = e.memlet.data
                if d is None or d not in prod_src or d in tset:
                    self._reason = "producer input without an outer source"
                    return False

        # per-read sigma: the write-order = read-order rule
        read_edges: List[Tuple] = []
        for e in st.out_edges(ce):
            t = e.memlet.data
            if t not in tset:
                continue
            if e.memlet.wcr is not None or e.memlet.dynamic:
                self._reason = "dynamic or wcr read of the intermediate"
                return False
            sigma, reason = solve_write_read_sigma(
                w_subsets[t], e.memlet.subset, prod.params, prod_rngs,
                cons.params)
            if sigma is None:
                self._reason = reason
                return False
            if not sigma_covered(sigma, prod_rngs, cons_rngs):
                self._reason = ("shifted reads fall outside the producer's "
                                "iteration box")
                return False
            read_edges.append((e, sigma))
        if not read_edges:
            return False

        if not self._hazards_ok(st, px, ce, cx, tset):
            return False
        member_set = set(members)
        for e in st.in_edges(ce):
            if e.src in member_set:
                continue
            if nx.has_path(st.graph, px, e.src):
                self._reason = ("consumer depends on the producer through "
                                "another path")
                return False
        for d, s in prod_src.items():
            if s is ce or nx.has_path(st.graph, cx, s):
                self._reason = ("routing a producer input into the consumer "
                                "would create a cycle")
                return False

        n_rep = self._count_replicas(st, pe, writer_of, read_edges)
        if n_rep + len(cons_inner) > self.max_fused_tasklets:
            self._reason = (f"fused scope would exceed "
                            f"{self.max_fused_tasklets} tasklets after "
                            f"producer replication")
            return False
        if keep and len(prod_tasklets) > self.max_replicated_producer:
            self._reason = ("multi-consumer replication of the producer "
                            "exceeds the replication cost threshold")
            return False
        match["halo"] = {
            "members": members, "keep": keep, "read_edges": read_edges,
            "writer_of": writer_of, "pe": pe, "px": px, "cx": cx,
            "prod_src": prod_src, "prod_tasklets": prod_tasklets,
        }
        return True

    def _replica_key_fn(self, st: State, pe: MapEntry):
        """Content-addressed replica identity: a producer tasklet under a
        substitution sigma is the same replica as another exactly when the
        computation (fn), output connectors, and the full substituted
        input structure coincide — so shifted copies of shifted copies
        deduplicate across fusion rounds."""
        memo: Dict[Tuple, Tuple] = {}

        def key_of(T, skey, sigma):
            mk = (id(T), skey)
            if mk in memo:
                return memo[mk]
            sigs = []
            for e in st.in_edges(T):
                sub = (e.memlet.subset.subs(sigma)
                       if e.memlet.subset is not None else None)
                if e.src is pe:
                    sigs.append(("ext", e.dst_conn, e.memlet.data,
                                 _subset_key(sub)))
                else:
                    sigs.append(("int", e.dst_conn, e.src_conn,
                                 key_of(e.src, skey, sigma)))
            k = (id(T.fn), tuple(sorted(T.outputs)),
                 tuple(sorted(sigs, key=repr)))
            memo[mk] = k
            return k

        return key_of

    def _count_replicas(self, st: State, pe: MapEntry, writer_of: Dict,
                        read_edges: List[Tuple]) -> int:
        key_of = self._replica_key_fn(st, pe)
        all_keys = set()

        def collect(T, skey, sigma):
            k = key_of(T, skey, sigma)
            if k in all_keys:
                return
            all_keys.add(k)
            for e in st.in_edges(T):
                if e.src is not pe:
                    collect(e.src, skey, sigma)

        for e, sigma in read_edges:
            T_w, _ = writer_of[e.memlet.data]
            collect(T_w, _sigma_key(sigma), sigma)
        return len(all_keys)

    def _apply_halo(self, sdfg: SDFG, match: Dict):
        st: State = match["state"]
        ce: MapEntry = match["consumer"]
        h = match["halo"]
        members, keep = h["members"], h["keep"]
        read_edges, writer_of = h["read_edges"], h["writer_of"]
        pe, px = h["pe"], h["px"]
        prod_src, prod_tasklets = h["prod_src"], h["prod_tasklets"]
        prod, cons = px.map, ce.map
        tset = {m.data for m in members}

        routed = {e.memlet.data for e in st.in_edges(ce)
                  if e.memlet.data is not None and e.memlet.data not in tset}
        key_of = self._replica_key_fn(st, pe)
        created: Dict[Tuple, Tasklet] = {}
        serial = [0]

        def materialize(T, skey, sigma) -> Tasklet:
            k = key_of(T, skey, sigma)
            if k in created:
                return created[k]
            R = st.add_tasklet(f"{T.label}.{serial[0]}", list(T.inputs),
                               list(T.outputs), T.fn)
            serial[0] += 1
            created[k] = R
            for e in st.in_edges(T):
                sub = (e.memlet.subset.subs(sigma)
                       if e.memlet.subset is not None else None)
                vol = (e.memlet.volume.subs(sigma)
                       if isinstance(e.memlet.volume, Expr)
                       else e.memlet.volume)
                m = Memlet(data=e.memlet.data, subset=sub, volume=vol)
                if e.src is pe:
                    d = e.memlet.data
                    if d not in routed:
                        st.add_edge(prod_src[d], None, ce, f"IN_{d}",
                                    Memlet.simple(d))
                        routed.add(d)
                    st.add_edge(ce, f"OUT_{d}", R, e.dst_conn, m)
                else:
                    U = materialize(e.src, skey, sigma)
                    st.add_edge(U, e.src_conn, R, e.dst_conn, m)
            return R

        # shifted reads become edges from the matching replica, keeping
        # the consumer-space subset (the element this iteration consumes)
        for e, sigma in read_edges:
            T_w, conn_w = writer_of[e.memlet.data]
            R = materialize(T_w, _sigma_key(sigma), sigma)
            st.add_edge(R, conn_w, e.dst, e.dst_conn,
                        Memlet(data=e.memlet.data, subset=e.memlet.subset,
                               volume=e.memlet.volume))
            st.remove_edge(e)
        for member in members:
            for oe in [o for o in st.out_edges(member) if o.dst is ce]:
                st.remove_edge(oe)

        if not keep:
            for n in [pe, px] + list(prod_tasklets) + members:
                if n in st.graph:
                    st.remove_node(n)
            for d, s in prod_src.items():
                if (s in st.graph and st.graph.degree(s) == 0
                        and isinstance(s, AccessNode)):
                    desc = sdfg.arrays.get(s.data)
                    if desc is not None and getattr(desc, "transient", False):
                        st.remove_node(s)
            # the intermediates now live on per-iteration edges only:
            # pure on-chip storage, out of the off-chip volume metric
            for t in tset:
                sdfg.arrays[t].storage = StorageType.REG

        cons.label = f"{_base_label(prod.label)}+{_base_label(cons.label)}"

    # -- wcr mode ------------------------------------------------------
    def _can_apply_wcr(self, sdfg: SDFG, st: State, node: AccessNode,
                       px: MapExit, ce: MapEntry, cx: MapExit,
                       match: Dict) -> bool:
        prod, cons = px.map, ce.map
        pe = px.entry
        t = node.data
        w = self._write_edge(st, px, t)
        if w is None or w.memlet.dynamic:
            self._reason = f"intermediate {t} has no unique static write"
            return False
        mode = w.memlet.wcr
        if mode != "add":
            self._reason = (f"wcr mode {mode!r} unsupported for fused "
                            f"reductions (identity differs from zero init)")
            return False
        if prod.annotations.get("tiling") or cons.annotations.get("tiling"):
            self._reason = ("wcr fusion requires untiled scopes "
                            "(runs before MapTiling)")
            return False
        env = sdfg.symbol_values
        prod_rngs = self._static_ranges(prod, env)
        cons_rngs = self._static_ranges(cons, env)
        if prod_rngs is None or cons_rngs is None:
            self._reason = ("wcr fusion requires static unit-step "
                            "iteration ranges")
            return False
        if _consumer_entry(st, node) is not ce:
            self._reason = (f"reduction intermediate {t} has multiple "
                            f"consumers")
            return False
        count = sum(1 for s in sdfg.states for n in s.data_nodes()
                    if n.data == t)
        if count != 1 or st.in_degree(node) != 1:
            self._reason = (f"intermediate {t} is accessed at more than "
                            f"one node")
            return False
        if t in sdfg.metadata.get("pin_hbm", ()):
            self._reason = f"intermediate {t} is pinned to HBM"
            return False
        # the reduction must be the producer's only product
        for e in st.out_edges(px):
            if not (isinstance(e.dst, AccessNode) and e.dst is node):
                self._reason = ("wcr producer has outputs besides the "
                                "reduction")
                return False
        for e in st.in_edges(px):
            if e.memlet.data != t:
                self._reason = ("wcr producer has outputs besides the "
                                "reduction")
                return False

        # write subset: out params (indexing the reduction) vs reduction
        # params (summed away)
        wsub = w.memlet.subset
        if wsub is None:
            self._reason = "whole-container wcr write"
            return False
        out_of: Dict[int, Tuple[str, int]] = {}
        used = set()
        for d, r in enumerate(wsub):
            if not r.is_index():
                self._reason = "wcr write is not element-indexed"
                return False
            dec = affine_decompose(r.start, prod.params)
            if dec is None:
                self._reason = f"non-affine wcr write index in dim {d}"
                return False
            c0, coeffs = dec
            live = {p: c for p, c in coeffs.items() if c != 0}
            if len(live) != 1 or next(iter(live.values())) != 1:
                self._reason = ("wcr write index is not a unit-coefficient "
                                "single-parameter shift")
                return False
            (p,) = live
            if p in used:
                self._reason = (f"producer parameter {p} indexes two "
                                f"dimensions")
                return False
            used.add(p)
            out_of[d] = (p, c0)
        red_params = [p for p in prod.params
                      if p not in used and prod_rngs[p][1] > 1]
        if not red_params:
            self._reason = ("wcr write with no reduction parameters "
                            "(producer revisits no elements)")
            return False

        # consumer reads: element-exact bijection onto the out params
        ren: Dict[str, str] = {}
        r_edges = [e for e in st.out_edges(ce) if e.memlet.data == t]
        if not r_edges:
            return False
        for e in r_edges:
            if e.memlet.wcr is not None or e.memlet.dynamic:
                self._reason = "dynamic or wcr read of the reduction"
                return False
            rsub = e.memlet.subset
            if rsub is None or len(rsub) != len(wsub):
                self._reason = "reduction read/write rank mismatch"
                return False
            for d, r in enumerate(rsub):
                if not r.is_index():
                    self._reason = ("consumer reads a windowed slice of the "
                                    "reduction")
                    return False
                dec = affine_decompose(r.start, cons.params)
                if dec is None:
                    self._reason = (f"reduction read index in dim {d} is not "
                                    f"affine over the consumer parameters")
                    return False
                c0, coeffs = dec
                live = {q: c for q, c in coeffs.items() if c != 0}
                p, wc = out_of[d]
                if len(live) != 1 or next(iter(live.values())) != 1:
                    self._reason = ("consumer read of the reduction is not "
                                    "element-exact")
                    return False
                (q,) = live
                if c0 != wc:
                    self._reason = ("consumer reads the reduction at a "
                                    "shifted offset")
                    return False
                if ren.get(q, p) != p or any(
                        pp == p for qq, pp in ren.items() if qq != q):
                    self._reason = ("inconsistent parameter pairing on the "
                                    "reduction read")
                    return False
                ren[q] = p
                if cons_rngs[q] != prod_rngs[p]:
                    self._reason = ("consumer range differs from the "
                                    "reduction's output range")
                    return False
        for q in cons.params:
            if q not in ren and cons_rngs[q][1] != 1:
                self._reason = (f"consumer parameter {q} is not bound by the "
                                f"reduction read")
                return False

        # consumer must be idempotent under re-execution: the fused scope
        # runs it once per reduction step, only the final write survives
        scopes = st.scope_children()
        prod_tasklets = _scope_tasklets(st, scopes, pe)
        cons_inner = _scope_tasklets(st, scopes, ce)
        for T in cons_inner:
            if not getattr(T, "side_effect_free", True):
                self._reason = ("consumer tasklet is not side-effect free "
                                "(re-executed per reduction step)")
                return False
        cons_reads = {e.memlet.data for e in st.out_edges(ce)
                      if e.memlet.data} - {t}
        cons_writes = {e.memlet.data for e in st.in_edges(cx)
                       if e.memlet.data}
        if cons_reads & cons_writes:
            self._reason = ("consumer reads a container it writes (not "
                            "idempotent under re-execution)")
            return False
        for e in st.in_edges(cx):
            if e.memlet.wcr is not None:
                self._reason = ("wcr consumer write behind a fused "
                                "reduction")
                return False
        for e in st.edges:
            if e.src in set(prod_tasklets) and e.dst in set(prod_tasklets):
                if e.memlet.wcr is not None:
                    self._reason = "nested wcr inside the wcr producer"
                    return False
        if len(prod_tasklets) + len(cons_inner) > self.max_fused_tasklets:
            self._reason = (f"fused scope would exceed "
                            f"{self.max_fused_tasklets} tasklets")
            return False

        # renaming must not capture symbols; shared containers must not
        # be reordered; no third scope between the pair
        cons_free = set()
        for e in st.out_edges(ce) + st.in_edges(cx):
            cons_free |= _edge_symbols(e.memlet)
        cons_free -= set(cons.params)
        if cons_free & set(prod.params):
            self._reason = ("consumer memlet captures a producer parameter "
                            "name")
            return False
        if not self._hazards_ok(st, px, ce, cx, {t}):
            return False
        for e in st.in_edges(ce):
            if e.src is node:
                continue
            if nx.has_path(st.graph, px, e.src):
                self._reason = ("consumer depends on the producer through "
                                "another path")
                return False

        ren_expr = {q: Expr.sym(p) for q, p in ren.items()}
        for q in cons.params:
            if q not in ren_expr:
                ren_expr[q] = Expr.const(cons_rngs[q][0])
        match["wcr"] = {"ren": ren_expr, "wsub": wsub}
        return True

    def _apply_wcr_fusion(self, sdfg: SDFG, match: Dict):
        st: State = match["state"]
        node: AccessNode = match["node"]
        ce: MapEntry = match["consumer"]
        in_e = st.in_edges(node)[0]
        px: MapExit = in_e.src
        pe = px.entry
        prod, cons = px.map, ce.map
        cx = next(n for n in st.nodes
                  if isinstance(n, MapExit) and n.entry is ce)
        ren = match["wcr"]["ren"]
        wsub = match["wcr"]["wsub"]
        t = node.data
        w = self._write_edge(st, px, t)
        writer, writer_conn = w.src, w.src_conn

        def rn(memlet: Memlet) -> Memlet:
            if ren and memlet.subset is not None:
                return Memlet(data=memlet.data,
                              subset=memlet.subset.subs(ren),
                              volume=memlet.volume, wcr=memlet.wcr,
                              dynamic=memlet.dynamic)
            return memlet

        scopes = st.scope_children()
        cons_inner = set(_scope_tasklets(st, scopes, ce))
        outer_src = {e.memlet.data: e.src for e in st.in_edges(ce)
                     if e.memlet.data is not None and e.memlet.data != t}
        pe_in = {(e.src, e.dst_conn) for e in st.in_edges(pe)}

        # consumer reads of the reduction ride an accumulating edge from
        # the producer's writer; other reads route through the fused entry
        for e in list(st.out_edges(ce)):
            if e.memlet.data == t:
                st.add_edge(writer, writer_conn, e.dst, e.dst_conn,
                            Memlet(data=t, subset=wsub, wcr="add"))
                continue
            st.add_edge(pe, e.src_conn, e.dst, e.dst_conn, rn(e.memlet))
            d = e.memlet.data
            if d is not None and d in outer_src:
                key = (outer_src[d], f"IN_{d}")
                if key not in pe_in:
                    st.add_edge(outer_src[d], None, pe, f"IN_{d}",
                                Memlet.simple(d))
                    pe_in.add(key)
        for e in st.edges:
            if e.src in cons_inner and e.dst in cons_inner:
                e.memlet = rn(e.memlet)
        for e in list(st.in_edges(cx)):
            st.add_edge(e.src, e.src_conn, px, e.dst_conn, rn(e.memlet))
        for e in list(st.out_edges(cx)):
            st.add_edge(px, e.src_conn, e.dst, e.dst_conn, e.memlet)

        st.remove_edge(w)
        st.remove_node(node)
        st.remove_node(ce)
        st.remove_node(cx)
        prod.label = f"{_base_label(prod.label)}+{_base_label(cons.label)}"
        sdfg.arrays[t].storage = StorageType.REG

    # ------------------------------------------------------------------
    def apply_match(self, sdfg: SDFG, match: Dict):
        mode = match.get("mode", "exact")
        if mode == "halo":
            return self._apply_halo(sdfg, match)
        if mode == "wcr":
            return self._apply_wcr_fusion(sdfg, match)
        return self._apply_exact(sdfg, match)

    def _apply_exact(self, sdfg: SDFG, match: Dict):
        st: State = match["state"]
        node: AccessNode = match["node"]
        in_e = st.in_edges(node)[0]
        px: MapExit = in_e.src
        pe: MapEntry = px.entry
        prod = px.map
        ce = _consumer_entry(st, node)
        cons = ce.map
        cx = next(n for n in st.nodes
                  if isinstance(n, MapExit) and n.entry is ce)
        plan = range_equivalence(prod, cons, sdfg.symbol_values)
        ren = plan["ren"]
        members = _group(st, px, ce)
        tset = {m.data for m in members}

        # adopt the consumer's tile structure on retiled producer dims
        if plan["prod_repl"]:
            prod.params = list(plan["params"])
            prod.ranges = list(plan["ranges"])
            if plan["tiling"]:
                prod.annotations.setdefault("tiling", {}).update(
                    {q: info for q, info in plan["tiling"].items()
                     if q in prod.params})
            scopes0 = st.scope_children()
            nodes = {pe, px} | set(scopes0.get(pe, []))
            for e in st.edges:
                if e.src in nodes or e.dst in nodes:
                    if e.memlet.subset is not None:
                        e.memlet.subset = e.memlet.subset.subs(
                            plan["prod_repl"])

        def rn(memlet: Memlet) -> Memlet:
            if ren and memlet.subset is not None:
                return Memlet(data=memlet.data,
                              subset=memlet.subset.subs(ren),
                              volume=memlet.volume, wcr=memlet.wcr,
                              dynamic=memlet.dynamic)
            return memlet

        scopes = st.scope_children()
        cons_inner = set(_scope_tasklets(st, scopes, ce))

        # the producer tasklet and output connector behind each member
        writer_of: Dict[str, Tuple] = {}
        w_edges = []
        for member in members:
            w = self._write_edge(st, px, member.data)
            writer_of[member.data] = (w.src, w.src_conn)
            w_edges.append(w)

        # outer sources feeding the consumer entry, and existing producer
        # entry inputs (dedupe key: (source node, entry connector))
        outer_src = {e.memlet.data: e.src for e in st.in_edges(ce)
                     if e.memlet.data is not None
                     and e.memlet.data not in tset}
        pe_in = {(e.src, e.dst_conn) for e in st.in_edges(pe)}

        # consumer-scope reads: through the fused entry, or — for the
        # intermediates — straight off their producer tasklets
        for e in list(st.out_edges(ce)):
            if e.memlet.data in tset:
                writer, writer_conn = writer_of[e.memlet.data]
                st.add_edge(writer, writer_conn, e.dst, e.dst_conn,
                            rn(e.memlet))
                continue
            st.add_edge(pe, e.src_conn, e.dst, e.dst_conn, rn(e.memlet))
            d = e.memlet.data
            if d is not None and d in outer_src:
                key = (outer_src[d], f"IN_{d}")
                if key not in pe_in:
                    st.add_edge(outer_src[d], None, pe, f"IN_{d}",
                                Memlet.simple(d))
                    pe_in.add(key)

        # consumer-internal tasklet->tasklet edges: rename in place
        for e in st.edges:
            if e.src in cons_inner and e.dst in cons_inner:
                e.memlet = rn(e.memlet)

        # consumer-scope writes: through the fused exit
        for e in list(st.in_edges(cx)):
            st.add_edge(e.src, e.src_conn, px, e.dst_conn, rn(e.memlet))
        for e in list(st.out_edges(cx)):
            st.add_edge(px, e.src_conn, e.dst, e.dst_conn, e.memlet)

        # drop the intermediate round-trips and the consumed scope shell
        for w in w_edges:
            st.remove_edge(w)
        for member in members:
            st.remove_node(member)
        st.remove_node(ce)
        st.remove_node(cx)

        prod.label = f"{_base_label(prod.label)}+{_base_label(cons.label)}"
        if prod.annotations.get("tiling"):
            prod.label += "_tiled"
        # the intermediates now live on per-iteration edges only: pure
        # on-chip storage, out of the off-chip volume metric
        for t in tset:
            sdfg.arrays[t].storage = StorageType.REG

    # ------------------------------------------------------------------
    def explain(self, sdfg: SDFG) -> List[Tuple[str, str]]:
        """Post-fixpoint: (consumer label, typed reason) for every
        remaining producer->consumer pair that refused to fuse."""
        out: List[Tuple[str, str]] = []
        seen = set()
        for m in self.find_matches(sdfg):
            if self.can_apply(sdfg, m):
                continue           # racing fixpoint leftovers; ignore
            if not self._reason:
                continue
            ce = m.get("consumer")
            label = ce.map.label if isinstance(ce, MapEntry) else "?"
            key = (label, self._reason)
            if key not in seen:
                seen.add(key)
                out.append(key)
        return out
