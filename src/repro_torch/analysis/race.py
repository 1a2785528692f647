"""Map-scope and inter-state data-race detection.

Three checks, all built on the mixed-radix/affine machinery the
transforms already trust:

``RACE001`` — a map scope writes a container without ``wcr`` and the
    write subset is *not* provably injective across iteration points
    (the same :func:`~repro_torch.transforms.map_fusion._injective_write`
    proof MapFusion uses for its write-order = read-order rule).
``RACE002`` — a map scope both reads and writes a container at
    *different* per-iteration subsets: iteration ``i`` may observe
    iteration ``j``'s write. Element-local read-modify-write (equal
    subsets, plain write) is the benign in-place pattern and passes.
``RACE003`` — two states with no control-flow ordering between them
    access the same container and at least one writes it.

Everything is prove-or-stay-silent in the *safe* direction for a
verifier: a race is only reported when the subset is affine in the map
parameters and every relevant extent is static, so a symbolic program
is never flagged on spec alone — but canonical pipeline output (which
is fully static after specialization) gets the exact proof.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.memlet import Subset
from ..core.sdfg import (AccessNode, MapEntry, MapExit, NestedSDFG, SDFG,
                         State, Tasklet)
from ..core.symbolic import Expr
from ..transforms.map_fusion import _injective_write
from .affine import edge_scope, param_box, scope_map, static_env
from .diagnostics import Diagnostic

import networkx as nx


def _subset_key(subset: Optional[Subset]) -> Tuple:
    """Canonical per-iteration identity of a subset (symbolic, exact)."""
    if subset is None:
        return ("*",)
    key = []
    for r in subset:
        key.append((tuple(sorted(Expr.wrap(r.start).terms.items())),
                    tuple(sorted(Expr.wrap(r.stop).terms.items())),
                    tuple(sorted(Expr.wrap(r.step).terms.items()))))
    return tuple(key)


def _params_affine(subset: Optional[Subset], params) -> bool:
    """True when every range bound is affine in the map parameters —
    the precondition under which ``_injective_write``'s rejection is a
    meaningful non-injectivity verdict rather than "could not prove"."""
    if subset is None:
        return True
    pset = set(params)
    for r in subset:
        for e in (r.start, r.stop, r.step):
            for mono, _ in Expr.wrap(e).terms.items():
                names = [nm for nm, p in mono]
                if any(nm in pset for nm in names):
                    if len(mono) != 1 or mono[0][1] != 1:
                        return False
    return True


def _scope_sizes(entry: MapEntry,
                 scope_of: Dict,
                 env: Dict[str, int]) -> Optional[Dict[str, int]]:
    """{param: static iteration count} for ``entry`` and all enclosing
    scopes; None when any extent is unevaluable (stay silent)."""
    sizes: Dict[str, int] = {}
    cur: Optional[MapEntry] = entry
    seen = set()
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        for p, r in zip(cur.map.params, cur.map.ranges):
            try:
                sizes[p] = r.size.subs(env).as_int()
            except Exception:
                return None
        cur = scope_of.get(cur)
    return sizes


def _is_stream(sdfg: SDFG, name: str) -> bool:
    desc = sdfg.arrays.get(name)
    return desc is not None and not hasattr(desc, "shape") \
        and type(desc).__name__ == "Stream"


def _scope_accesses(state: State, scope_of: Dict):
    """Per innermost scope: the tasklet-level read and write edges.

    Reads are ``MapEntry -> Tasklet`` edges (the per-iteration element
    view); writes are ``Tasklet -> MapExit`` edges. Aggregated restated
    memlets on the outside of the scope (``AccessNode -> MapEntry``,
    ``MapExit -> AccessNode``) and fused register edges between tasklets
    are deliberately excluded — they describe the same movement at a
    different granularity.
    """
    accesses: Dict[MapEntry, Dict[str, list]] = {}
    for e in state.edges:
        if e.memlet is None or e.memlet.data is None:
            continue
        if isinstance(e.src, Tasklet) and isinstance(e.dst, Tasklet):
            continue  # fused register traffic, iteration-private
        kind = None
        if isinstance(e.src, MapEntry) and isinstance(e.dst, Tasklet):
            kind = "read"
        elif isinstance(e.src, Tasklet) and isinstance(e.dst, MapExit):
            kind = "write"
        elif isinstance(e.src, Tasklet) and isinstance(e.dst, AccessNode):
            kind = "write"
        if kind is None:
            continue
        scope = edge_scope(e, scope_of)
        if scope is None:
            continue  # top-level tasklet: single execution, no race
        accesses.setdefault(scope, {}).setdefault(
            e.memlet.data, []).append((kind, e))
    return accesses


def check_state_races(sdfg: SDFG, state: State,
                      env: Dict[str, int]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    scope_of = scope_map(state)
    accesses = _scope_accesses(state, scope_of)
    for scope, by_container in accesses.items():
        sizes = _scope_sizes(scope, scope_of, env)
        for name, acc in by_container.items():
            if _is_stream(sdfg, name):
                continue  # push/pop semantics, ordered by construction
            writes = [e for k, e in acc if k == "write"]
            reads = [e for k, e in acc if k == "read"]
            # RACE001: non-injective plain write across iterations
            for e in writes:
                m = e.memlet
                if m.wcr is not None or m.dynamic:
                    continue
                if sizes is None:
                    continue  # extent unprovable: stay silent
                if not _params_affine(m.subset, sizes):
                    continue  # cannot reason: stay silent
                if not _injective_write(m.subset, dict(sizes)):
                    diags.append(Diagnostic(
                        code="RACE001",
                        message=(f"map '{scope.map.label}' writes "
                                 f"'{name}' at {m.subset!r} without wcr "
                                 "and distinct iterations overlap"),
                        state=state.label, scope=scope.map.label,
                        container=name))
            # RACE002: read subset differs from every write subset
            if writes and reads:
                wkeys = {_subset_key(e.memlet.subset) for e in writes}
                wcr_write = any(e.memlet.wcr is not None for e in writes)
                for e in reads:
                    rk = _subset_key(e.memlet.subset)
                    if not wcr_write and rk in wkeys:
                        continue  # element-local RMW
                    if sizes is None or any(sz is None
                                            for sz in sizes.values()):
                        continue
                    if all(sz <= 1 for sz in sizes.values()):
                        continue  # single iteration point
                    diags.append(Diagnostic(
                        code="RACE002",
                        message=(f"map '{scope.map.label}' reads "
                                 f"'{name}' at {e.memlet.subset!r} while "
                                 "another iteration writes it"),
                        state=state.label, scope=scope.map.label,
                        container=name))
    return diags


def _state_container_access(state: State):
    """(reads, writes) container-name sets at state granularity."""
    reads, writes = set(), set()
    for n in state.nodes:
        if not isinstance(n, AccessNode):
            continue
        if state.out_edges(n):
            reads.add(n.data)
        if state.in_edges(n):
            writes.add(n.data)
    return reads, writes


def check_interstate_races(sdfg: SDFG) -> List[Diagnostic]:
    """RACE003: unordered state pairs sharing a container with a writer."""
    diags: List[Diagnostic] = []
    states = list(sdfg.states)
    if len(states) < 2:
        return diags
    reach = {s: nx.descendants(sdfg.cfg, s) | {s} for s in states
             if s in sdfg.cfg}
    summary = {s: _state_container_access(s) for s in states}

    def guarded(s):
        # A state entered through a conditional edge may be mutually
        # exclusive with its unordered siblings — stay silent.
        return any(d.get("edge") is not None
                   and getattr(d["edge"], "condition", None) is not None
                   for _, _, d in sdfg.cfg.in_edges(s, data=True))

    for i, a in enumerate(states):
        for b in states[i + 1:]:
            if a not in reach or b not in reach:
                continue
            if b in reach[a] or a in reach[b]:
                continue  # ordered by control flow
            if guarded(a) or guarded(b):
                continue
            ra, wa = summary[a]
            rb, wb = summary[b]
            conflict = (wa & wb) | (wa & rb) | (ra & wb)
            for name in sorted(conflict):
                if _is_stream(sdfg, name):
                    continue
                diags.append(Diagnostic(
                    code="RACE003",
                    message=(f"states '{a.label}' and '{b.label}' are "
                             f"unordered in the CFG but both access "
                             f"'{name}' and at least one writes it"),
                    state=f"{a.label}|{b.label}", container=name))
    return diags


def check_races(sdfg: SDFG) -> List[Diagnostic]:
    """All race diagnostics for an SDFG (recursing into nested SDFGs)."""
    env = static_env(sdfg)
    diags: List[Diagnostic] = []
    for st in sdfg.states:
        diags.extend(check_state_races(sdfg, st, env))
        for n in st.nodes:
            if isinstance(n, NestedSDFG):
                diags.extend(check_races(n.sdfg))
    diags.extend(check_interstate_races(sdfg))
    return diags
