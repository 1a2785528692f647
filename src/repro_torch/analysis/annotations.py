"""Pass-to-codegen annotation consistency checks.

The transforms communicate with the grid code generator
(``codegen.cuda_backend``) through annotations — ``Map.annotations
["tiling"]`` (MapTiling), the derived ``grid`` GridSpec
(GridConversionPass), and the SDFG-level
``shard_map`` metadata (ShardMapPass). A transform that edits a map
after another pass annotated it can silently desynchronize the two
views; these checks re-derive the cheap invariants from scratch.

``ANN001`` — a tiling annotation disagrees with the map's ranges
    (missing intra/counter parameter, wrong tile/block extent, or a
    block count that cannot cover the recorded extent).
``ANN002`` — a ``grid`` GridSpec names parameters the map no
    longer has, or its grid/block extents disagree with the ranges.
``SHD001`` — a shard spec names an unknown container or a dimension
    outside the container's rank.
``SHD002`` — a psum-classified container has no wcr write anywhere
    (nothing produces the partial values the collective combines).
``SHD003`` — a replicated-classified container receives a plain write
    inside a shard-divided map scope (each shard would write different
    values into a buffer declared identical across shards).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..core.sdfg import (MapEntry, MapExit, NestedSDFG, SDFG, Tasklet)
from ..transforms.map_tiling import normalize_tiling
from .affine import edge_scope, scope_map, static_env
from .diagnostics import Diagnostic


def _range_size(m, param, env) -> Optional[int]:
    for p, r in zip(m.params, m.ranges):
        if p == param:
            try:
                return r.size.subs(env).as_int()
            except Exception:
                return None
    return None


def check_tiling(sdfg: SDFG) -> List[Diagnostic]:
    env = static_env(sdfg)
    diags: List[Diagnostic] = []
    for state in sdfg.states:
        for node in state.nodes:
            if not isinstance(node, MapEntry):
                continue
            m = node.map
            tiling = normalize_tiling(m.annotations.get("tiling"))
            for pi, info in tiling.items():
                pt = info.get("counter")
                if pt is None:
                    continue            # legacy exact-divisible entry
                problems = []
                if pi not in m.params:
                    problems.append(f"intra parameter '{pi}' missing")
                if pt not in m.params:
                    problems.append(f"counter parameter '{pt}' missing")
                tile, blocks = info.get("tile"), info.get("blocks")
                extent = info.get("extent")
                sz_pi = _range_size(m, pi, env)
                sz_pt = _range_size(m, pt, env)
                if tile is not None and sz_pi is not None and sz_pi != tile:
                    problems.append(f"'{pi}' iterates {sz_pi} != tile "
                                    f"{tile}")
                if blocks is not None and sz_pt is not None \
                        and sz_pt != blocks:
                    problems.append(f"'{pt}' iterates {sz_pt} != blocks "
                                    f"{blocks}")
                if tile and blocks is not None and extent is not None \
                        and blocks != math.ceil(extent / tile):
                    problems.append(f"{blocks} blocks of {tile} cannot "
                                    f"tile extent {extent}")
                for p in problems:
                    diags.append(Diagnostic(
                        code="ANN001",
                        message=(f"tiling annotation of map '{m.label}' "
                                 f"desynchronized: {p}"),
                        state=state.label, scope=m.label))
    return diags


def check_grid_specs(sdfg: SDFG) -> List[Diagnostic]:
    from ..codegen.cuda_backend import GRID_ANNOTATION
    env = static_env(sdfg)
    diags: List[Diagnostic] = []
    for state in sdfg.states:
        for node in state.nodes:
            if not isinstance(node, MapEntry):
                continue
            m = node.map
            spec = m.annotations.get(GRID_ANNOTATION)
            if spec is None:
                continue
            problems = []
            for p, size in getattr(spec, "grid", ()):
                sz = _range_size(m, p, env)
                if p not in m.params:
                    problems.append(f"grid parameter '{p}' missing from "
                                    "the map")
                elif sz is not None and sz != size:
                    problems.append(f"grid dim '{p}' spans {size} but the "
                                    f"map iterates {sz}")
            for p, extent in getattr(spec, "block_params", ()):
                sz = _range_size(m, p, env)
                if p not in m.params:
                    problems.append(f"block parameter '{p}' missing from "
                                    "the map")
                elif sz is not None and sz != extent:
                    problems.append(f"block dim '{p}' spans {extent} but "
                                    f"the map iterates {sz}")
            for p in problems:
                diags.append(Diagnostic(
                    code="ANN002",
                    message=(f"grid spec of map '{m.label}' "
                             f"desynchronized: {p}"),
                    state=state.label, scope=m.label))
    return diags


# ---------------------------------------------------------------------------
# Shard classification (SHD001-SHD003)
# ---------------------------------------------------------------------------


def check_shard(sdfg: SDFG) -> List[Diagnostic]:
    from ..transforms.shard_map import SHARD_ANNOTATION
    meta = sdfg.metadata.get(SHARD_ANNOTATION)
    if not meta:
        return []
    diags: List[Diagnostic] = []
    specs: Dict[str, Optional[int]] = meta.get("specs", {})
    psum = set(meta.get("psum", ()))
    divided_labels = {lbl for lbl, _ in meta.get("divided", ())}
    for name, dim in specs.items():
        desc = sdfg.arrays.get(name)
        if desc is None:
            diags.append(Diagnostic(
                code="SHD001",
                message=f"shard spec names unknown container '{name}'",
                container=name))
            continue
        rank = len(getattr(desc, "shape", ()) or ())
        if dim is not None and not (0 <= dim < rank):
            diags.append(Diagnostic(
                code="SHD001",
                message=(f"shard spec partitions dim {dim} of '{name}' "
                         f"(rank {rank})"),
                container=name))
    wcr_written = set()
    plain_writes = []   # (state, scope_chain_labels, container)
    for state in sdfg.states:
        scope_of = scope_map(state)
        for e in state.edges:
            m = e.memlet
            if m is None or m.data is None:
                continue
            is_write = (isinstance(e.src, Tasklet)
                        and isinstance(e.dst, (MapExit,))) \
                or (isinstance(e.src, Tasklet)
                    and not isinstance(e.dst, Tasklet))
            if not is_write:
                continue
            if m.wcr is not None:
                wcr_written.add(m.data)
                continue
            scope = edge_scope(e, scope_of)
            chain = []
            seen = set()
            while scope is not None and id(scope) not in seen:
                seen.add(id(scope))
                chain.append(scope.map.label)
                scope = scope_of.get(scope)
            plain_writes.append((state.label, chain, m.data))
    for name in sorted(psum):
        if name not in wcr_written:
            diags.append(Diagnostic(
                code="SHD002",
                message=(f"psum-classified container '{name}' has no "
                         "wcr('add') write producing shard partials"),
                container=name))
    flagged = set()
    for state_label, chain, name in plain_writes:
        if name in flagged or name in psum:
            continue
        if specs.get(name, 0) is not None:   # sharded or not classified
            continue
        if any(lbl in divided_labels for lbl in chain):
            flagged.add(name)
            diags.append(Diagnostic(
                code="SHD003",
                message=(f"replicated-classified container '{name}' is "
                         f"written inside shard-divided scope(s) "
                         f"{[l for l in chain if l in divided_labels]}"),
                state=state_label, container=name))
    return diags


def check_annotations(sdfg: SDFG) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    diags.extend(check_tiling(sdfg))
    diags.extend(check_grid_specs(sdfg))
    diags.extend(check_shard(sdfg))
    for st in sdfg.states:
        for n in st.nodes:
            if isinstance(n, NestedSDFG):
                diags.extend(check_annotations(n.sdfg))
    return diags
