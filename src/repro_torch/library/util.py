"""Helpers for Library-Node expansions (paper §3)."""
from __future__ import annotations

from typing import Callable, Dict

from ..core.memlet import Memlet
from ..core.sdfg import AccessNode, LibraryNode, SDFG, State, Tasklet


def in_edge(state: State, node, conn: str):
    for e in state.in_edges(node):
        if e.dst_conn == conn:
            return e
    raise KeyError(f"{node.label}: no in-edge on connector {conn!r}")


def out_edge(state: State, node, conn: str):
    for e in state.out_edges(node):
        if e.src_conn == conn:
            return e
    raise KeyError(f"{node.label}: no out-edge on connector {conn!r}")


def replace_with_tasklet(node: LibraryNode, sdfg: SDFG, state: State,
                         fn: Callable, name_suffix: str = "impl") -> Tasklet:
    """Swap a library node for a single tasklet with identical connectors —
    the 'delegate to a high-performance implementation' expansion level
    (paper §3.3: cuBLAS/MKL analogue; here a jnp or Pallas composite)."""
    t = state.add_tasklet(f"{node.label}_{name_suffix}", node.inputs,
                          node.outputs, fn)
    for e in state.in_edges(node):
        state.add_edge(e.src, e.src_conn, t, e.dst_conn, e.memlet)
    for e in state.out_edges(node):
        state.add_edge(t, e.src_conn, e.dst, e.dst_conn, e.memlet)
    state.remove_node(node)
    return t


def operand_nodes(state: State, node: LibraryNode) -> Dict[str, AccessNode]:
    """Connector name -> neighboring access node."""
    out: Dict[str, AccessNode] = {}
    for e in state.in_edges(node):
        if isinstance(e.src, AccessNode) and e.dst_conn:
            out[e.dst_conn] = e.src
    for e in state.out_edges(node):
        if isinstance(e.dst, AccessNode) and e.src_conn:
            out[e.src_conn] = e.dst
    return out


def unique_name(sdfg: SDFG, base: str) -> str:
    name = base
    i = 0
    while name in sdfg.arrays:
        i += 1
        name = f"{base}_{i}"
    return name
