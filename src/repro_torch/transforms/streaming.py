"""StreamingMemory and StreamingComposition (paper §3.2.2-§3.2.3).

StreamingMemory extracts reads/writes of off-chip containers into dedicated
streaming accessor components (on FPGA: burst readers; on TPU: the
HBM->VMEM pipeline stage that Pallas double-buffers). It does not change
off-chip volume — it restructures access for bandwidth.

StreamingComposition fuses consecutive computations through a stream when
the producer's write order equals the consumer's read order, removing the
off-chip round-trip entirely: the container becomes a VMEM stream and its
2x HBM volume disappears. This is the transformation behind the paper's
headline Table-1/2/3 gains.

This module also hosts the shared write-order = read-order legality
front-end (:func:`solve_write_read_sigma`, :func:`sigma_covered`) that
both StreamingComposition's access-order matching and MapFusion's
halo-aware grid fusion build on: a producer writing ``t[p + c]`` per
iteration and a consumer reading ``t[f(q) ]`` are order-compatible
exactly when the affine renaming sigma(p) = f(q) - c exists and maps the
consumer's iteration box into the producer's — then the consumer's read
order IS the producer's write order composed with sigma, and the
intermediate can ride through the fused scope as shifted in-VMEM reads
instead of an off-chip round-trip.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import networkx as nx

from ..core.dtypes import StorageType
from ..core.memlet import Memlet, Subset
from ..core.sdfg import (AccessNode, Array, LibraryNode, MapEntry, MapExit,
                         Scalar, SDFG, State, Stream, Tasklet)
from ..core.symbolic import Expr
from .base import Transformation


# ---------------------------------------------------------------------------
# Shared write-order = read-order front-end (consumed by MapFusion's
# halo path; see module docstring)
# ---------------------------------------------------------------------------


def affine_decompose(expr: Expr, params) -> Optional[Tuple[int, Dict[str, int]]]:
    """Decompose ``expr`` as ``const + sum(coeff_p * p)`` over ``params``.
    Returns ``(const, {p: coeff})`` with integer values, or None when the
    expression is non-affine, has fractional coefficients, or references a
    symbol outside ``params``."""
    pset = set(params)
    const = 0
    coeffs: Dict[str, int] = {}
    for mono, c in Expr.wrap(expr).terms.items():
        if isinstance(c, Fraction):
            if c.denominator != 1:
                return None
            c = c.numerator
        c = int(c)
        if mono == ():
            const += c
            continue
        if len(mono) != 1 or mono[0][1] != 1:
            return None
        name = mono[0][0]
        if name not in pset:
            return None
        coeffs[name] = coeffs.get(name, 0) + c
    return const, coeffs


def solve_write_read_sigma(write_subset: Optional[Subset],
                           read_subset: Optional[Subset],
                           prod_params: List[str],
                           prod_ranges: Dict[str, Tuple[int, int]],
                           cons_params: List[str]):
    """Solve the affine renaming sigma that makes the producer's write
    order equal the consumer's read order for one intermediate edge pair.

    The producer must write ``t[..., p_d + c_d, ...]`` — every dimension an
    index addressed by exactly one distinct producer parameter with
    coefficient 1 (plus a constant); producer parameters absent from the
    write subset must have single-iteration ranges (otherwise the write
    revisits elements). The consumer read must be all-index with each
    dimension affine over the consumer parameters; then
    ``sigma(p_d) = read_d - c_d``.

    Returns ``(sigma, None)`` on success — ``sigma`` maps each producer
    parameter to an :class:`Expr` over consumer parameters — or
    ``(None, reason)`` with a typed refusal reason.
    """
    if write_subset is None or read_subset is None:
        return None, "whole-container access to the intermediate"
    if len(write_subset) != len(read_subset):
        return None, "read/write rank mismatch on the intermediate"
    sigma: Dict[str, Expr] = {}
    for d, (wr, rr) in enumerate(zip(write_subset, read_subset)):
        if not wr.is_index():
            return None, "producer writes a slice of the intermediate"
        if not rr.is_index():
            return None, ("consumer reads a windowed slice of the "
                          "intermediate")
        wdec = affine_decompose(wr.start, prod_params)
        if wdec is None:
            return None, f"non-affine write index in dim {d}"
        wconst, wcoeffs = wdec
        live = {p: c for p, c in wcoeffs.items() if c != 0}
        if len(live) != 1 or next(iter(live.values())) != 1:
            return None, (f"write index in dim {d} is not a unit-coefficient "
                          f"single-parameter shift")
        (p,) = live
        if p in sigma:
            return None, f"producer parameter {p} indexes two dimensions"
        rdec = affine_decompose(rr.start, cons_params)
        if rdec is None:
            return None, (f"read index in dim {d} is not affine over the "
                          f"consumer parameters")
        rconst, rcoeffs = rdec
        e = Expr.const(rconst - wconst)
        for q, c in rcoeffs.items():
            e = e + Expr.sym(q) * c
        sigma[p] = e
    for p in prod_params:
        if p in sigma:
            continue
        rng = prod_ranges.get(p)
        if rng is None or rng[1] != 1:
            return None, (f"producer parameter {p} does not address the "
                          f"intermediate (broadcast write revisits elements)")
        sigma[p] = Expr.const(rng[0])
    return sigma, None


def sigma_covered(sigma: Dict[str, Expr],
                  prod_ranges: Dict[str, Tuple[int, int]],
                  cons_ranges: Dict[str, Tuple[int, int]]) -> bool:
    """True when the image of the consumer's iteration box under ``sigma``
    lies inside the producer's iteration box (interval arithmetic over the
    affine shifts) — every shifted read then hits an iteration the
    producer actually executed. Producer iterations outside the image are
    dead once the intermediate has no other reader."""
    for p, expr in sigma.items():
        dec = affine_decompose(expr, list(cons_ranges))
        if dec is None:
            return False
        c0, coeffs = dec
        lo = hi = c0
        for q, (qs, qn) in cons_ranges.items():
            a = coeffs.get(q, 0)
            if a >= 0:
                lo += a * qs
                hi += a * (qs + qn - 1)
            else:
                lo += a * (qs + qn - 1)
                hi += a * qs
        ps, pn = prod_ranges[p]
        if lo < ps or hi > ps + pn - 1:
            return False
    return True


def _access_order_key(state: State, edge, endpoint: str):
    """Canonical access-order key for a producer/consumer edge.

    For edges into/out of map scopes, the key combines the scope's
    iteration ranges with the memlet's index expressions, both canonicalized
    over positional parameters (paper §3.2.3: 'canonicalizing the memlets'
    symbolic expressions by remapping symbol names to indices'). For
    whole-array accesses the key is ('FULL', shape).
    """
    node = edge.src if endpoint == "producer" else edge.dst
    scope_map = None
    if endpoint == "producer" and isinstance(node, MapExit):
        scope_map = node.map
    if endpoint == "consumer" and isinstance(node, MapEntry):
        scope_map = node.map
    memlet = edge.memlet
    if scope_map is None:
        return ("FULL",)
    params = scope_map.params
    env = {p: f"__i{k}" for k, p in enumerate(params)}
    ranges = tuple((r.start.subs(env), r.stop.subs(env), r.step.subs(env))
                   for r in scope_map.ranges)
    # find the inner memlet (through the scope) for the same data
    inner = None
    if endpoint == "producer":
        for e in state.in_edges(node):
            if e.memlet.data == memlet.data:
                inner = e.memlet
                break
    else:
        for e in state.out_edges(node):
            if e.memlet.data == memlet.data:
                inner = e.memlet
                break
    if inner is None or inner.subset is None:
        return ("FULL",)
    order = inner.access_order(params)
    return (ranges, order)


class StreamingComposition(Transformation):
    """array node with in-degree 1 / out-degree 1 and matching access
    orders -> convert the container into a VMEM stream."""

    def find_matches(self, sdfg: SDFG, **kwargs):
        counts: Dict[str, int] = {}
        for st in sdfg.states:
            for node in st.data_nodes():
                counts[node.data] = counts.get(node.data, 0) + 1
        for st in sdfg.states:
            for node in st.data_nodes():
                desc = sdfg.arrays[node.data]
                if (desc.transient and isinstance(desc, Array)
                        and not isinstance(desc, Stream)
                        and not isinstance(desc, Scalar)
                        and st.in_degree(node) == 1
                        and st.out_degree(node) == 1
                        and counts[node.data] == 1):
                    yield {"state": st, "node": node}

    def can_apply(self, sdfg: SDFG, match: Dict) -> bool:
        st, node = match["state"], match["node"]
        if node not in st.graph:
            return False
        if node.data in sdfg.metadata.get("pin_hbm", ()):
            return False  # performance engineer pinned it off-chip
        desc = sdfg.arrays[node.data]
        if isinstance(desc, Stream):
            return False
        in_e = st.in_edges(node)[0]
        out_e = st.out_edges(node)[0]
        prod_key = _access_order_key(st, in_e, "producer")
        cons_key = _access_order_key(st, out_e, "consumer")
        return prod_key == cons_key

    def apply_match(self, sdfg: SDFG, match: Dict):
        st, node = match["state"], match["node"]
        desc: Array = sdfg.arrays[node.data]
        sdfg.arrays[node.data] = Stream(
            dtype=desc.dtype, storage=StorageType.VMEM, transient=True,
            buffer_size=4, shape=(), element_shape=tuple(desc.shape),
            total_volume=desc.num_elements)
        # split into producer-side and consumer-side access nodes: the two
        # PEs hold no dataflow edge, synchronizing only through the stream
        # container (paper §2.5 / Fig. 3)
        out_e = st.out_edges(node)[0]
        consumer_side = st.add_access(node.data)
        st.add_edge(consumer_side, None, out_e.dst, out_e.dst_conn,
                    out_e.memlet)
        st.remove_edge(out_e)


class StreamingMemory(Transformation):
    """Extract off-chip reads/writes into streaming accessor components.

    Reads: for each HBM access node feeding computation, insert a reader
    tasklet (memory -> stream) and redirect the consumer to the stream.
    Multiple consumers with the same access order share one reader with
    multiple output streams (paper: broadcast); dependent accesses get
    separate components (deadlock avoidance via reachability).
    """

    def find_matches(self, sdfg: SDFG, **kwargs):
        for st in sdfg.states:
            for node in st.data_nodes():
                desc = sdfg.arrays[node.data]
                if isinstance(desc, (Stream, Scalar)) or not isinstance(desc, Array):
                    continue
                if not desc.storage.off_chip:
                    continue
                if sdfg.metadata.get("streamed_" + node.data):
                    continue
                reads = [e for e in st.out_edges(node)
                         if not isinstance(e.dst, AccessNode)]
                writes = [e for e in st.in_edges(node)
                          if not isinstance(e.src, AccessNode)]
                if reads:
                    yield {"state": st, "node": node, "edges": reads,
                           "mode": "read"}
                if writes:
                    yield {"state": st, "node": node, "edges": writes,
                           "mode": "write"}

    def can_apply(self, sdfg: SDFG, match: Dict) -> bool:
        return match["node"] in match["state"].graph and not \
            sdfg.metadata.get("streamed_" + match["node"].data + "_" +
                              match["mode"])

    def apply_match(self, sdfg: SDFG, match: Dict):
        st: State = match["state"]
        node: AccessNode = match["node"]
        desc: Array = sdfg.arrays[node.data]
        mode = match["mode"]
        sdfg.metadata["streamed_" + node.data + "_" + mode] = True

        # group consumer/producer edges by access order; dependent groups
        # (reachability between endpoints) are kept separate
        groups: List[List] = []
        for e in match["edges"]:
            key = _access_order_key(
                st, e, "consumer" if mode == "read" else "producer")
            placed = False
            for g in groups:
                if g[0][0] == key and not self._dependent(st, g[0][1], e):
                    g.append((key, e))
                    placed = True
                    break
            if not placed:
                groups.append([(key, e)])

        for gi, group in enumerate(groups):
            stream_names = []
            for si, (_, e) in enumerate(group):
                sname = f"{node.data}_{mode}_stream"
                if gi or si:
                    sname += f"_{gi}_{si}"
                base = sname
                k = 0
                while sname in sdfg.arrays:
                    k += 1
                    sname = f"{base}_{k}"
                sdfg.add_stream(sname, desc.dtype, buffer_size=4,
                                element_shape=tuple(desc.shape),
                                total_volume=desc.num_elements,
                                storage=StorageType.VMEM)
                stream_names.append(sname)
            if mode == "read":
                # reader PE: mem -> stream(s)  (paper red/black boxes, Fig. 3)
                reader = st.add_tasklet(
                    f"read_{node.data}" + (f"_{gi}" if gi else ""),
                    ["mem"], [f"s{k}" for k in range(len(group))],
                    (lambda n_out: (lambda mem: {f"s{k}": mem for k in
                                                 range(n_out)}))(len(group)))
                st.add_edge(node, None, reader, "mem",
                            Memlet.simple(node.data,
                                          volume=desc.num_elements))
                for k, ((key, e), sname) in enumerate(zip(group, stream_names)):
                    s_prod = st.add_access(sname)   # producer-side node
                    s_cons = st.add_access(sname)   # consumer-side node (no
                    #                       edge between PEs, paper Fig. 3)
                    st.add_edge(reader, f"s{k}", s_prod, None,
                                Memlet.simple(sname,
                                              volume=desc.num_elements))
                    st.add_edge(s_cons, None, e.dst, e.dst_conn,
                                self._retarget(e.memlet, sname))
                    self._retarget_scope(st, e.dst, node.data, sname)
                    st.remove_edge(e)
            else:
                # writer PE: stream -> mem (paper blue box)
                writer = st.add_tasklet(
                    f"write_{node.data}" + (f"_{gi}" if gi else ""),
                    [f"s{k}" for k in range(len(group))], ["mem"],
                    (lambda n_in: (lambda **kw: {"mem": kw["s0"]}))(len(group)))
                st.add_edge(writer, "mem", node, None,
                            Memlet.simple(node.data,
                                          volume=desc.num_elements))
                for k, ((key, e), sname) in enumerate(zip(group, stream_names)):
                    s_prod = st.add_access(sname)
                    s_cons = st.add_access(sname)
                    st.add_edge(e.src, e.src_conn, s_prod, None,
                                self._retarget(e.memlet, sname))
                    st.add_edge(s_cons, None, writer, f"s{k}",
                                Memlet.simple(sname,
                                              volume=desc.num_elements))
                    self._retarget_scope(st, e.src, node.data, sname)
                    st.remove_edge(e)

    @staticmethod
    def _retarget(memlet: Memlet, new_data: str) -> Memlet:
        return Memlet(data=new_data, subset=memlet.subset,
                      volume=memlet.volume, wcr=memlet.wcr)

    @staticmethod
    def _retarget_scope(st: State, scope_node, old: str, new: str):
        """Rewrite memlets inside a map scope that reference the old
        container (reads through OUT_<old> connectors)."""
        if not isinstance(scope_node, (MapEntry, MapExit)):
            return
        stack = [scope_node]
        seen = set()
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            for e in st.out_edges(n):
                if e.memlet.data == old:
                    e.memlet.data = new
                if e.src_conn and e.src_conn == f"OUT_{old}":
                    e.src_conn = f"OUT_{new}"
                if e.dst_conn and e.dst_conn == f"IN_{old}":
                    e.dst_conn = f"IN_{new}"
                if not isinstance(e.dst, (AccessNode,)):
                    stack.append(e.dst)
            for e in st.in_edges(n):
                if e.memlet.data == old:
                    e.memlet.data = new
                if e.src_conn and e.src_conn == f"OUT_{old}":
                    e.src_conn = f"OUT_{new}"
                if e.dst_conn and e.dst_conn == f"IN_{old}":
                    e.dst_conn = f"IN_{new}"

    @staticmethod
    def _dependent(st: State, e1, e2) -> bool:
        """Reachability between the two consumers/producers => dependent
        accesses must not share a streaming component (deadlock avoidance,
        paper §3.2.2)."""
        try:
            return (nx.has_path(st.graph, e1.dst, e2.dst)
                    or nx.has_path(st.graph, e2.dst, e1.dst))
        except Exception:
            return True
