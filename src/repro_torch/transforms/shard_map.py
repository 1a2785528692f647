"""ShardMap partition analysis: memlets decide what crosses the mesh.

The same ``factor_subset`` idea that turns affine memlet subsets into
grid blocks extends one level up (ROADMAP scale-out item): the
outermost dimension of an eligible DEVICE/PIPELINED map scope is
partitioned across a 1-D mesh axis, and every data container is
classified from its memlets as

  * **shard-local** — a scope parameter indexes the dimension exactly
    (coefficient 1, offset 0): each shard owns ``extent / n_shards`` of
    it and the per-shard trace sees the local shape;
  * **replicated** — never addressed by a partitioned parameter (weights,
    lookup tables): every shard holds the full array;
  * **collective** — written with ``wcr`` reduced *over* a partitioned
    parameter: each shard produces a partial value and a ``psum`` over
    the mesh axis completes the reduction (data-parallel gradients).

Reads that cross the shard boundary — a partitioned parameter appearing
with an offset (``p0 + 1``: a halo), inside a slice bound, or in a step —
are a **typed refusal**: the partition either replicates the operand (a
read-only halo input) or refuses the whole SDFG with the reason recorded
in ``report["grid_decisions"]``, never silently computes
the wrong thing.

Containers that only appear through whole-container memlets (the serving
step's monolithic tasklets wire everything with ``Memlet.simple(name)``)
are statically opaque; two escape hatches cover them:

  * ``sdfg.metadata["shard_declared"]`` — the *builder* declares the
    partition dim (or ``None`` for replicated) per container; the page
    pools' in-shard-ness is a pool-protocol invariant no static analysis
    can see, so the serving builder declares it (decision ``declared``).
  * transients whose leading-dim extent equals a sharded extent inherit
    dim-0 partitioning (the per-layer activations between monolithic
    tasklets); everything else defaults to replicated.

``partition_sdfg`` mutates the SDFG in place — container shapes and map
ranges divide by ``n_shards`` — and stamps ``sdfg.metadata["shard_map"]``
(pure data, content-hash safe) for the backend. Running the
shard-local program on a mesh is ROADMAP step 10a; until then the
backends refuse a program whose ``shard_map`` names more than one shard.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..core.dtypes import ScheduleType
from ..core.memlet import Range
from ..core.sdfg import SDFG, Array, MapEntry, MapExit
from ..core.symbolic import Expr

#: metadata key carrying the partition result to codegen
SHARD_ANNOTATION = "shard_map"
#: metadata key for builder-declared container partitions
DECLARED_KEY = "shard_declared"

#: sentinel: container pinned replicated (vs. "not yet classified")
_REPLICATED = -1


class ShardRefusal(Exception):
    """Typed refusal: the SDFG cannot be partitioned as requested."""

    def __init__(self, reason: str, container: str = None, scope: str = None):
        self.reason = reason
        self.container = container
        self.scope = scope
        super().__init__(reason)


def _scope_memlets(state, entry: MapEntry, scopes) -> List:
    """All distinct memlets incident to a map scope's nodes (entry, exit,
    children): the outer whole-container edges plus the per-iteration
    subset edges the classification reads."""
    nodes = {entry}
    for n in scopes.get(entry, []):
        nodes.add(n)
        if isinstance(n, MapEntry):  # nested scopes contribute their edges
            nodes |= set(scopes.get(n, []))
    nodes |= {n for n in state.nodes
              if isinstance(n, MapExit) and n.entry is entry}
    out = []
    seen = set()
    for e in state.edges:
        if (e.src in nodes or e.dst in nodes) and e.memlet.data is not None:
            if id(e) not in seen:
                seen.add(id(e))
                out.append(e)
    return out


def _exact_index_dim(r: Range, p: str) -> Optional[bool]:
    """True: ``r`` is exactly ``[p]``. False: ``p`` appears some other way
    (offset/slice/step — a shard-boundary crossing). None: ``p`` unused."""
    syms = r.start.free_symbols | r.stop.free_symbols | r.step.free_symbols
    if p not in syms:
        return None
    return bool(r.is_index() and r.start == Expr.sym(p))


class _Analysis:
    """One fixpoint partition analysis over an SDFG."""

    def __init__(self, sdfg: SDFG, n_shards: int, axis: str):
        self.sdfg = sdfg
        self.k = n_shards
        self.axis = axis
        self.env = {k: v for k, v in sdfg.symbol_values.items()
                    if isinstance(v, int)}
        #: container -> shard dim, or _REPLICATED (pinned)
        self.assign: Dict[str, int] = {}
        self.psum: Set[str] = set()
        self.decisions: List[dict] = []
        #: (map label, param) pairs whose range divides by k
        self.divided: Set[Tuple[int, str]] = set()
        self._maps: Dict[int, object] = {}

    # -- helpers --------------------------------------------------------
    def _extent(self, name: str, dim: int) -> Optional[int]:
        desc = self.sdfg.arrays.get(name)
        if not isinstance(desc, Array) or dim >= len(desc.shape):
            return None
        try:
            return int(desc.shape[dim].evaluate(self.env))
        except Exception:  # symbolic extent: not partitionable statically
            return None

    def _assign_shard(self, name: str, dim: int, how: str):
        cur = self.assign.get(name)
        if cur == dim:
            return False
        if cur is not None and cur != dim:
            if cur == _REPLICATED:
                raise ShardRefusal(
                    f"container {name!r} must stay replicated "
                    f"(declared or halo-read) but a scope indexes its "
                    f"dim {dim} with a partitioned parameter",
                    container=name)
            raise ShardRefusal(
                f"container {name!r} partitioned on two different dims "
                f"({cur} and {dim}) by different scopes", container=name)
        ext = self._extent(name, dim)
        if ext is None or ext % self.k:
            raise ShardRefusal(
                f"container {name!r} dim {dim} extent {ext} is not "
                f"divisible by n_shards={self.k}", container=name)
        self.assign[name] = dim
        self.decisions.append({"map": None, "container": name,
                               "decision": "shard", "dim": dim,
                               "how": how, "extent": ext})
        return True

    # -- per-scope classification ---------------------------------------
    def _scope_uses(self, state, entry, scopes):
        """param -> {(container, dim)} exact uses, plus violations
        (param -> [(container, reason)]) and wcr reductions."""
        exact: Dict[str, Set[Tuple[str, int]]] = {}
        bad: Dict[str, List[Tuple[str, str]]] = {}
        wcr_over: List[Tuple[str, Set[str]]] = []  # (container, used params)
        params = set()
        m = entry.map
        params |= set(m.params)
        for n in scopes.get(entry, []):
            if isinstance(n, MapEntry):
                params |= set(n.map.params)
        for e in _scope_memlets(state, entry, scopes):
            ml = e.memlet
            if ml.subset is None:
                if ml.wcr is not None and not self.sdfg.arrays[ml.data].transient:
                    wcr_over.append((ml.data, set()))
                continue
            used = set()
            for d, r in enumerate(ml.subset):
                for p in params:
                    res = _exact_index_dim(r, p)
                    if res is None:
                        continue
                    used.add(p)
                    if res:
                        exact.setdefault(p, set()).add((ml.data, d))
                    else:
                        bad.setdefault(p, []).append(
                            (ml.data,
                             f"parameter {p!r} addresses {ml.data!r} dim "
                             f"{d} as {r!r} (offset/slice crosses the "
                             f"shard boundary)"))
            if ml.wcr is not None:
                wcr_over.append((ml.data, used))
        return exact, bad, wcr_over

    def _run_scope(self, state, entry, scopes, seed: bool) -> bool:
        """Process one scope; returns True if the assignment changed."""
        m = entry.map
        if not m.params:
            return False
        exact, bad, wcr_over = self._scope_uses(state, entry, scopes)

        # which params already touch sharded dims?
        hot = [p for p, uses in exact.items()
               if any(self.assign.get(c) == d for c, d in uses)]
        if not hot and seed:
            # seed from the outermost param of an eligible DEVICE scope
            if m.schedule not in (ScheduleType.DEVICE,
                                  ScheduleType.PIPELINED):
                return False
            p0 = m.params[0]
            r0 = m.ranges[0]
            try:
                ext = int(r0.size.evaluate(self.env))
                start = int(r0.start.evaluate(self.env))
            except Exception:
                return False
            if start != 0 or ext < self.k or ext % self.k:
                self.decisions.append({
                    "map": m.label, "decision": "unsharded",
                    "reason": f"outermost extent {ext} not divisible by "
                              f"n_shards={self.k}"})
                return False
            if p0 in bad:
                self.decisions.append({
                    "map": m.label, "decision": "unsharded",
                    "reason": bad[p0][0][1]})
                return False
            if p0 not in exact:
                return False
            hot = [p0]
        if not hot:
            return False
        if len(hot) > 1:
            raise ShardRefusal(
                f"scope {m.label!r}: parameters {sorted(hot)} both index "
                f"partitioned dims — 2-D sharding is not supported",
                scope=m.label)
        p = hot[0]
        if p in bad:
            # a partitioned parameter also reads across the boundary
            raise ShardRefusal(bad[p][0][1], container=bad[p][0][0],
                               scope=m.label)
        changed = False
        for c, d in exact[p]:
            changed |= self._assign_shard(c, d, how=f"indexed in {m.label}")
        # wcr writes not addressed by p reduce over the partition: the
        # per-shard partial needs a psum to complete
        for c, used in wcr_over:
            if p not in used:
                desc = self.sdfg.arrays[c]
                if not desc.transient:
                    if self.assign.get(c, _REPLICATED) != _REPLICATED:
                        raise ShardRefusal(
                            f"container {c!r} is both partitioned and "
                            f"wcr-reduced over the partition",
                            container=c, scope=m.label)
                    self.assign[c] = _REPLICATED
                    if c not in self.psum:
                        self.psum.add(c)
                        self.decisions.append({
                            "map": m.label, "container": c,
                            "decision": "collective", "op": "psum"})
                        changed = True
        return changed

    # -- driver ----------------------------------------------------------
    def run(self):
        declared = self.sdfg.metadata.get(DECLARED_KEY) or {}
        for name, dim in declared.items():
            if name not in self.sdfg.arrays:
                continue
            if dim is None:
                self.assign[name] = _REPLICATED
                self.decisions.append({"map": None, "container": name,
                                       "decision": "replicated",
                                       "how": "declared"})
            else:
                self._assign_shard(name, int(dim), how="declared")

        scopes_of = {}
        for st in self.sdfg.states:
            scopes_of[st] = st.scope_children()
        seed = not declared
        for _ in range(64):  # fixpoint; scope count bounds real iterations
            changed = False
            for st in self.sdfg.states:
                for node in st.nodes:
                    if isinstance(node, MapEntry):
                        changed |= self._run_scope(st, node, scopes_of[st],
                                                   seed)
            if not changed:
                break

        if not any(d != _REPLICATED for d in self.assign.values()):
            raise ShardRefusal("no eligible scope: nothing to partition")

        # transients touched only by whole-container memlets: inherit dim-0
        # partitioning when the leading extent matches a sharded extent
        shard_extents = {self._extent(c, d)
                         for c, d in self.assign.items() if d != _REPLICATED}
        shard_extents.discard(None)
        for name, desc in self.sdfg.arrays.items():
            if name in self.assign or not isinstance(desc, Array):
                continue
            if not desc.shape:
                continue
            if desc.transient and self._extent(name, 0) in shard_extents:
                self.assign[name] = 0
                self.decisions.append({"map": None, "container": name,
                                       "decision": "shard", "dim": 0,
                                       "how": "transient_extent"})
            elif not desc.transient:
                self.decisions.append({"map": None, "container": name,
                                       "decision": "replicated",
                                       "how": "default"})

    # -- transform --------------------------------------------------------
    def transform(self):
        """Divide sharded container shapes and the map ranges addressing
        them by ``n_shards``; stamp the partition metadata.

        Validation happens before any mutation: a refusal raised here must
        leave the SDFG untouched (the caller then compiles unsharded)."""
        planned = []  # (map, range index, new Range)
        for st in self.sdfg.states:
            scopes = st.scope_children()
            for node in st.nodes:
                if not isinstance(node, MapEntry):
                    continue
                m = node.map
                exact, _, _ = self._scope_uses(st, node, scopes)
                owners = {}  # param -> required divided extent
                for p, uses in exact.items():
                    for c, d in uses:
                        if self.assign.get(c, _REPLICATED) == d:
                            ext = self._extent(c, d)
                            if p in owners and owners[p] != ext:
                                raise ShardRefusal(
                                    f"scope {m.label!r}: parameter {p!r} "
                                    f"indexes partitioned dims of "
                                    f"different extents", scope=m.label)
                            owners[p] = ext
                for me in ([node] + [n for n in scopes.get(node, [])
                                     if isinstance(n, MapEntry)]):
                    mm = me.map
                    for i, p in enumerate(mm.params):
                        if p not in owners:
                            continue
                        r = mm.ranges[i]
                        try:
                            ext = int(r.size.evaluate(self.env))
                            start = int(r.start.evaluate(self.env))
                        except Exception as exc:
                            raise ShardRefusal(
                                f"scope {mm.label!r}: symbolic range for "
                                f"partitioned parameter {p!r}",
                                scope=mm.label) from exc
                        if start != 0 or ext != owners[p]:
                            raise ShardRefusal(
                                f"scope {mm.label!r}: parameter {p!r} "
                                f"iterates [{start}:{start + ext}) but "
                                f"the partitioned dim extent is "
                                f"{owners[p]} — partial iteration cannot "
                                f"shard", scope=mm.label)
                        planned.append((mm, i, Range.make(0, ext // self.k)))
                        self.divided.add((mm.label, p))
        for mm, i, r in planned:
            mm.ranges[i] = r
        # container shapes
        for name, dim in self.assign.items():
            if dim == _REPLICATED:
                continue
            desc = self.sdfg.arrays[name]
            shape = list(desc.shape)
            ext = int(shape[dim].evaluate(self.env))
            shape[dim] = Expr.const(ext // self.k)
            desc.shape = tuple(shape)
        self.sdfg.metadata[SHARD_ANNOTATION] = {
            "axis": self.axis, "n_shards": self.k,
            "specs": {name: (None if dim == _REPLICATED else dim)
                      for name, dim in sorted(self.assign.items())
                      if not self.sdfg.arrays[name].transient},
            "psum": sorted(self.psum),
            # (map label, param) pairs whose range was divided by the
            # shard count — the verifier (analysis.annotations, SHD003)
            # uses this to prove replicated containers are not written
            # per shard.
            "divided": sorted(self.divided),
        }


def partition_sdfg(sdfg: SDFG, n_shards: int, axis: str = "shard") -> dict:
    """Partition ``sdfg`` in place across ``n_shards`` mesh shards.

    Returns ``{"sharded": bool, "decisions": [...], "specs": {...}}``.
    On a typed refusal the SDFG is left untouched and the refusal reason
    is the single decision — the caller compiles unsharded.
    """
    if n_shards <= 1:
        return {"sharded": False, "decisions": [], "specs": {}}
    ana = _Analysis(sdfg, n_shards, axis)
    try:
        ana.run()
        ana.transform()
    except ShardRefusal as e:
        return {"sharded": False,
                "decisions": ana.decisions + [{
                    "map": e.scope, "container": e.container,
                    "decision": "shard_refused", "reason": e.reason}],
                "specs": {}}
    meta = sdfg.metadata[SHARD_ANNOTATION]
    return {"sharded": True, "decisions": ana.decisions,
            "specs": meta["specs"], "psum": meta["psum"]}
