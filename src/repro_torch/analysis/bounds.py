"""Static memlet bounds / volume checking and the donation lint.

``BND001`` — a memlet subset provably escapes its container under the
    map ranges binding its parameters (interval arithmetic over the
    scope's iteration box; unprovable dimensions stay silent).
``BND002`` — a transient is consumed outside the region any producer
    writes: the consumed interval hull escapes the produced hull in
    some dimension. Hulls over-approximate the produced region, so a
    finding is a proof that some read touches a never-written element.
``BND003`` — a memlet carries an explicit volume smaller than its
    subset's element count (the Fig.-7 consistency direction: the
    annotated movement cannot cover the annotated region).
``DON001``/``DON002`` — donation lints over ``metadata["donated"]``:
    a donated buffer that is never written is handed to the step as a
    live buffer that the step may update in place (the served step's
    pages and states, and the buffer pairs of its CUDA graphs) while
    readers still expect the old value, and a donated name must be a
    program argument.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.sdfg import (AccessNode, MapEntry, MapExit, NestedSDFG, SDFG,
                         State, Tasklet)
from .affine import (container_extents, edge_scope, expr_bounds, param_box,
                     scope_map, static_env, subset_box)
from .diagnostics import Diagnostic


def _edge_label(e) -> str:
    return f"{getattr(e.src, 'label', type(e.src).__name__)}->" \
           f"{getattr(e.dst, 'label', type(e.dst).__name__)}"


def check_state_bounds(sdfg: SDFG, state: State,
                       env: Dict[str, int]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    scope_of = scope_map(state)
    boxes: Dict[Optional[MapEntry], Dict] = {}
    for e in state.edges:
        m = e.memlet
        if m is None or m.data is None:
            continue
        desc = sdfg.arrays.get(m.data)
        if desc is None or not hasattr(desc, "shape"):
            continue
        extents = container_extents(sdfg, m.data, env)
        scope = edge_scope(e, scope_of)
        if scope not in boxes:
            boxes[scope] = param_box(scope, scope_of, env)[0]
        box = boxes[scope]
        scope_label = scope.map.label if scope is not None else None
        # BND001: per-dimension interval containment
        if m.subset is not None and extents is not None \
                and len(m.subset) == len(extents):
            for d, (r, ext) in enumerate(zip(m.subset, extents)):
                b_start = expr_bounds(r.start, box, env)
                b_stop = expr_bounds(r.stop, box, env)
                if b_start is not None and b_start[0] < 0:
                    diags.append(Diagnostic(
                        code="BND001",
                        message=(f"memlet {_edge_label(e)} subset dim {d} "
                                 f"reaches index {b_start[0]} < 0 in "
                                 f"'{m.data}'"),
                        state=state.label, scope=scope_label,
                        container=m.data))
                elif b_stop is not None and b_stop[1] - 1 >= ext:
                    diags.append(Diagnostic(
                        code="BND001",
                        message=(f"memlet {_edge_label(e)} subset dim {d} "
                                 f"reaches index {b_stop[1] - 1} >= extent "
                                 f"{ext} of '{m.data}'"),
                        state=state.label, scope=scope_label,
                        container=m.data))
        # BND003: explicit volume vs subset element count
        if m.volume is not None and m.subset is not None and not m.dynamic:
            try:
                vol = int(m.volume.subs(env).as_int())
                count = 1
                for r in m.subset:
                    count *= int(r.size.subs(env).as_int())
            except Exception:
                vol = count = None
            if vol is not None and vol < count:
                diags.append(Diagnostic(
                    code="BND003",
                    message=(f"memlet {_edge_label(e)} declares volume "
                             f"{vol} but its subset holds {count} "
                             f"elements of '{m.data}'"),
                    state=state.label, scope=scope_label,
                    container=m.data))
    return diags


# ---------------------------------------------------------------------------
# Transient produced-vs-consumed regions (BND002)
# ---------------------------------------------------------------------------


def _hull(a: Optional[Tuple], b: Tuple) -> Tuple:
    if a is None:
        return b
    return tuple((min(x[0], y[0]), max(x[1], y[1])) for x, y in zip(a, b))


def _tasklet_level_accesses(state: State, scope_of):
    """Yield (kind, edge, scope) at tasklet granularity — the same
    element-view selection the race checker uses."""
    for e in state.edges:
        m = e.memlet
        if m is None or m.data is None or m.subset is None:
            continue
        if isinstance(e.src, Tasklet) and isinstance(e.dst, Tasklet):
            continue
        if isinstance(e.src, MapEntry) and isinstance(e.dst, Tasklet):
            yield "read", e, edge_scope(e, scope_of)
        elif isinstance(e.src, AccessNode) and isinstance(e.dst, Tasklet):
            yield "read", e, edge_scope(e, scope_of)
        elif isinstance(e.src, Tasklet):
            yield "write", e, edge_scope(e, scope_of)


def check_transient_regions(sdfg: SDFG) -> List[Diagnostic]:
    env = static_env(sdfg)
    produced: Dict[str, Optional[Tuple]] = {}
    consumed: Dict[str, List] = {}
    opaque = set()   # transients with an unprovable producer: stay silent
    for state in sdfg.states:
        scope_of = scope_map(state)
        boxes: Dict[Optional[MapEntry], Dict] = {}
        for kind, e, scope in _tasklet_level_accesses(state, scope_of):
            name = e.memlet.data
            desc = sdfg.arrays.get(name)
            if desc is None or not getattr(desc, "transient", False) \
                    or not hasattr(desc, "shape"):
                continue
            extents = container_extents(sdfg, name, env)
            if extents is None or len(e.memlet.subset) != len(extents):
                opaque.add(name)
                continue
            if scope not in boxes:
                boxes[scope] = param_box(scope, scope_of, env)[0]
            sb = subset_box(e.memlet.subset, boxes[scope], env)
            if sb is None:
                opaque.add(name)
                continue
            if kind == "write":
                produced[name] = _hull(produced.get(name), sb)
            else:
                consumed.setdefault(name, []).append((state.label, sb))
    diags: List[Diagnostic] = []
    for name, uses in consumed.items():
        if name in opaque or name not in produced:
            continue
        phull = produced[name]
        for state_label, sb in uses:
            for d, ((rlo, rhi), (plo, phi)) in enumerate(zip(sb, phull)):
                if rlo < plo or rhi > phi:
                    diags.append(Diagnostic(
                        code="BND002",
                        message=(f"transient '{name}' consumed at dim {d} "
                                 f"interval [{rlo},{rhi}] outside the "
                                 f"produced region [{plo},{phi}]"),
                        state=state_label, container=name))
                    break
    return diags


# ---------------------------------------------------------------------------
# Donation lints (DON001/DON002)
# ---------------------------------------------------------------------------


def _written_containers(sdfg: SDFG) -> set:
    out = set()
    for state in sdfg.states:
        for e in state.edges:
            m = e.memlet
            if m is None or m.data is None:
                continue
            if isinstance(e.dst, (AccessNode, MapExit)) \
                    and not isinstance(e.src, (AccessNode, MapEntry)):
                out.add(m.data)
            elif isinstance(e.dst, AccessNode) and isinstance(e.src,
                                                              AccessNode):
                out.add(e.dst.data)   # copy edge
    return out


def check_donation(sdfg: SDFG) -> List[Diagnostic]:
    donated = sdfg.metadata.get("donated") or []
    if not donated:
        return []
    diags: List[Diagnostic] = []
    args = set(sdfg.argument_names())
    written = _written_containers(sdfg)
    for name in donated:
        if name not in args:
            diags.append(Diagnostic(
                code="DON002",
                message=(f"donated name '{name}' is not a program "
                         "argument (nothing to donate)"),
                container=name))
            continue
        if name not in written:
            diags.append(Diagnostic(
                code="DON001",
                message=(f"donated buffer '{name}' is never written: the "
                         "step may alias its storage to an output while it "
                         "is still read"),
                container=name))
    return diags


def check_bounds(sdfg: SDFG) -> List[Diagnostic]:
    """All bounds/volume/donation diagnostics (recursing into nests)."""
    env = static_env(sdfg)
    diags: List[Diagnostic] = []
    for st in sdfg.states:
        diags.extend(check_state_bounds(sdfg, st, env))
        for n in st.nodes:
            if isinstance(n, NestedSDFG):
                diags.extend(check_bounds(n.sdfg))
    diags.extend(check_transient_regions(sdfg))
    diags.extend(check_donation(sdfg))
    return diags
