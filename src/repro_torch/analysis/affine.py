"""Shared affine/interval machinery for the static analyses.

The race and bounds checkers reason about memlet subsets *under the map
ranges that bind their parameters*: which scope an edge executes in,
what integer box each parameter iterates over, and the provable
min/max of an affine index expression over that box. Everything here is
conservative — when a value cannot be proven (symbolic extent, mutated
symbol, non-affine index) the caller stays silent rather than guessing.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional, Tuple

from ..core.memlet import Range, Subset
from ..core.sdfg import (AccessNode, MapEntry, MapExit, Node, SDFG, State)
from ..core.symbolic import Expr


def static_env(sdfg: SDFG) -> Dict[str, int]:
    """Symbol bindings that are compile-time constants: ``symbol_values``
    minus symbols mutated by interstate assignments (the same exclusion
    ``GridConversionPass`` applies)."""
    mutated = set()
    for _, _, d in sdfg.cfg.edges(data=True):
        e = d.get("edge")
        if e is not None and getattr(e, "assignments", None):
            mutated |= set(e.assignments)
    return {k: v for k, v in sdfg.symbol_values.items()
            if k not in mutated and isinstance(v, int)}


def scope_map(state: State) -> Dict[Node, Optional[MapEntry]]:
    """node -> innermost enclosing MapEntry (None = top level)."""
    out: Dict[Node, Optional[MapEntry]] = {}
    for scope, children in state.scope_children().items():
        for n in children:
            out[n] = scope
    return out


def edge_scope(e, scope_of: Dict[Node, Optional[MapEntry]]
               ) -> Optional[MapEntry]:
    """The scope an edge's data movement executes in. Edges leaving a
    MapEntry (the ``OUT_*`` side) and entering a MapExit (the ``IN_*``
    side) are *inside* that map; edges entering an entry / leaving an
    exit are outside."""
    if isinstance(e.src, MapEntry):
        return e.src
    if isinstance(e.dst, MapExit):
        return e.dst.entry
    if isinstance(e.src, MapExit):
        return scope_of.get(e.src.entry)
    if isinstance(e.dst, MapEntry):
        return scope_of.get(e.dst)
    return scope_of.get(e.dst, scope_of.get(e.src))


def param_box(entry: Optional[MapEntry],
              scope_of: Dict[Node, Optional[MapEntry]],
              env: Dict[str, int]
              ) -> Tuple[Dict[str, Tuple[int, int]], bool]:
    """Inclusive (lo, hi) iteration box per parameter for ``entry`` and
    every enclosing scope. Returns ``(box, complete)``; ``complete`` is
    False when some enclosing range could not be evaluated (those
    parameters are omitted — expressions using them stay unprovable)."""
    box: Dict[str, Tuple[int, int]] = {}
    complete = True
    seen = set()
    while entry is not None and id(entry) not in seen:
        seen.add(id(entry))
        m = entry.map
        for p, r in zip(m.params, m.ranges):
            try:
                start = r.start.subs(env).as_int()
                size = r.size.subs(env).as_int()
                step = r.step.subs(env).as_int()
            except Exception:
                complete = False
                continue
            if size < 1:
                complete = False
                continue
            box[p] = (start, start + (size - 1) * step) if step >= 0 \
                else (start + (size - 1) * step, start)
        entry = scope_of.get(entry)
    return box, complete


def expr_bounds(e: Expr, box: Dict[str, Tuple[int, int]],
                env: Dict[str, int]) -> Optional[Tuple[int, int]]:
    """Provable inclusive (min, max) of ``e`` with parameters ranging
    over ``box`` and other symbols bound by ``env``; None when the
    expression is non-affine or uses an unbound symbol."""
    e = e.subs(env)
    lo = hi = Fraction(0)
    for mono, c in e.terms.items():
        if mono == ():
            lo += c
            hi += c
            continue
        if len(mono) != 1 or mono[0][1] != 1:
            return None                       # non-affine
        name = mono[0][0]
        if name not in box:
            return None                       # unbound parameter/symbol
        plo, phi = box[name]
        if c >= 0:
            lo += c * plo
            hi += c * phi
        else:
            lo += c * phi
            hi += c * plo
    if lo.denominator != 1 or hi.denominator != 1:
        return None
    return int(lo), int(hi)


def subset_box(subset: Subset, box: Dict[str, Tuple[int, int]],
               env: Dict[str, int]
               ) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Element box touched by a subset over the whole iteration space:
    per dimension the provable inclusive ``(min_start, max_last)`` where
    ``max_last`` is the largest element index the half-open range can
    reach. None when any dimension is unprovable."""
    dims = []
    for r in subset:
        b_start = expr_bounds(r.start, box, env)
        b_stop = expr_bounds(r.stop, box, env)
        if b_start is None or b_stop is None:
            return None
        dims.append((b_start[0], b_stop[1] - 1))
    return tuple(dims)


def container_extents(sdfg: SDFG, name: str,
                      env: Dict[str, int]) -> Optional[Tuple[int, ...]]:
    """Static dimension extents of a container, or None per-unknown."""
    desc = sdfg.arrays.get(name)
    shape = getattr(desc, "shape", None)
    if not shape:
        return ()
    out = []
    for s in shape:
        try:
            out.append(int(Expr.wrap(s).evaluate(env)))
        except Exception:
            return None
    return tuple(out)
