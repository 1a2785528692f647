"""The torch backend: the structural interpreter (Intel-OpenCL analogue).

Lowers a fully-expanded SDFG into an eager PyTorch callable by structural
interpretation: states execute in control-flow order; within a state, the
dataflow graph is traversed topologically; tasklets call their bodies on
torch tensors; map scopes lower to vectorized code (``torch.func.vmap``)
when the scope holds only tasklets (single mapped tasklets, and MapFusion
chains whose per-iteration intermediates thread through the vmapped body
as local values), to unrolled Python loops for UNROLLED/MESH schedules,
and to sequential Python loops otherwise. PyTorch's own kernels then do
the work — the 'library does the scheduling' vendor. Every container value
lives on the compiled device.

Write-conflict-resolution memlets lower to accumulating index writes;
streams materialize as arrays shaped by their logical element volume
(SPSC + matching access order — enforced by validation — make this
semantics-preserving).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.dtypes import torch_dtype
from ..core.memlet import Memlet
from ..core.sdfg import (AccessNode, Array, LibraryNode, MapEntry, MapExit,
                         NestedSDFG, Scalar, SDFG, State, Stream, Tasklet)
from ..core.symbolic import Expr
from .common import (DynamicStrideError, WCR_MODES, apply_wcr_at, eval_expr,
                     read_memlet, wcr_combine, wcr_reduce, write_memlet)

# Maps whose scope is not a single tasklet fall back to a Python loop; cap
# the trip count so mistakes fail loudly instead of hanging the
# interpreter.
SEQUENTIAL_TRIP_LIMIT = 4096


def container_shape(desc, env: Dict[str, int]):
    if isinstance(desc, Scalar):
        return ()
    if isinstance(desc, Stream):
        shape = desc.element_shape or ()
        if desc.shape:  # array-of-streams: outer dims first
            shape = tuple(desc.shape) + tuple(shape)
        return tuple(int(eval_expr(s, env)) for s in shape)
    return tuple(int(eval_expr(s, env)) for s in desc.shape)


class FrozenState:
    """A state as one run of a compiled program sees it: every query of its
    graph (nodes, edges, each node's edges, the topological order, the
    scopes, the order of its processing elements) is answered once and
    kept. A compiled callable keeps one for each state across its calls
    (``build_callable``), so a served decode step does not re-sort its
    graph every step; labels, annotations and values are still read on
    every run. The graph must not change while the callable lives."""

    def __init__(self, state: State):
        self.state = state
        self._memo: Dict = {}

    def memo(self, key, make):
        """``make()``, worked out on the first call with ``key``."""
        try:
            return self._memo[key]
        except KeyError:
            v = self._memo[key] = make()
            return v

    def __getattr__(self, name):
        return getattr(self.state, name)

    @property
    def nodes(self):
        return self.memo("nodes", lambda: self.state.nodes)

    @property
    def edges(self):
        return self.memo("edges", lambda: self.state.edges)

    def in_edges(self, node):
        return self.memo(("in", node), lambda: self.state.in_edges(node))

    def out_edges(self, node):
        return self.memo(("out", node), lambda: self.state.out_edges(node))

    def in_degree(self, node):
        return len(self.in_edges(node))

    def out_degree(self, node):
        return len(self.out_edges(node))

    def topological_nodes(self):
        return self.memo("topo", self.state.topological_nodes)

    def scope_children(self):
        return self.memo("scopes", self.state.scope_children)


def frozen(state, states: Optional[Dict] = None) -> FrozenState:
    """``state`` as a :class:`FrozenState`, the one kept in ``states`` (a
    compiled callable's) when given."""
    if isinstance(state, FrozenState):
        return state
    if states is None:
        return FrozenState(state)
    if state not in states:
        states[state] = FrozenState(state)
    return states[state]


class StateLowering:
    """Structural interpreter over one state's dataflow graph.

    Node dispatch, memlet reads/writes, and the generic map lowerings
    (sequential / vmap) are shared backend infrastructure; subclasses plug
    in platform map-lowering strategies by overriding
    :meth:`_lower_map_custom` (e.g. the cuda backend's grid kernels).
    """

    def __init__(self, sdfg: SDFG, state: State, env: Dict[str, object],
                 symenv: Dict[str, object], device: torch.device,
                 states: Optional[Dict] = None):
        self.sdfg = sdfg
        self.state = frozen(state, states)
        self.states = states    # the callable's FrozenStates, for nesting
        self.env = env          # container name -> tensor on ``device``
        self.symenv = symenv    # symbol name -> int (or vmapped index)
        self.device = device
        self.scopes = self.state.scope_children()

    def topological_nodes(self) -> List:
        """The state's nodes in topological order (sorted once: the graph
        does not change while it runs)."""
        return self.state.topological_nodes()

    # ------------------------------------------------------------------
    def ensure_value(self, name: str):
        if name in self.env:
            return self.env[name]
        if name in self.sdfg.constants:
            self.env[name] = to_tensor(self.sdfg.constants[name], self.device)
            return self.env[name]
        desc = self.sdfg.arrays[name]
        shape = container_shape(desc, self._static_syms())
        self.env[name] = torch.zeros(shape, dtype=torch_dtype(desc.dtype),
                                     device=self.device)
        return self.env[name]

    def _static_syms(self):
        return {k: v for k, v in self.symenv.items() if isinstance(v, int)}

    # ------------------------------------------------------------------
    def run(self):
        """Schedule processing elements (weakly connected components,
        paper §2.4) in producer->consumer order over shared containers; on
        FPGA they run concurrently synchronized by FIFOs, here the stream
        contents materialize between pipeline stages."""
        for nodes in self.state.memo("run_order", self._run_order):
            self._run_nodes(nodes)

    def _run_order(self) -> List[List]:
        """The top-level nodes, one list a processing element, in the order
        ``run`` takes them."""
        import networkx as nx
        comps = [frozenset(c) for c in
                 nx.weakly_connected_components(self.state.graph)]
        top = set(self.scopes.get(None, []))
        if len(comps) <= 1:
            return [[n for n in self.topological_nodes() if n in top]]
        writers: Dict[str, set] = {}
        readers: Dict[str, set] = {}
        for i, comp in enumerate(comps):
            for n in comp:
                if isinstance(n, AccessNode):
                    if self.state.in_degree(n) > 0:
                        writers.setdefault(n.data, set()).add(i)
                    if self.state.out_degree(n) > 0:
                        readers.setdefault(n.data, set()).add(i)
        meta = nx.DiGraph()
        meta.add_nodes_from(range(len(comps)))
        for name, ws in writers.items():
            for w in ws:
                for r in readers.get(name, ()):  # producer before consumer
                    if r != w:
                        meta.add_edge(w, r)
        try:
            comp_order = list(nx.topological_sort(meta))
        except nx.NetworkXUnfeasible as exc:
            raise NotImplementedError(
                "feedback between processing elements requires bounded-FIFO "
                "simulation, unsupported in the materializing backend"
            ) from exc
        comp_of = {n: i for i, comp in enumerate(comps) for n in comp}
        by_comp: List[List] = [[] for _ in comps]
        for n in self.topological_nodes():
            if n in top:
                by_comp[comp_of[n]].append(n)
        return [by_comp[ci] for ci in comp_order]

    def _run_nodes(self, nodes: List):
        for node in nodes:
            if isinstance(node, AccessNode):
                self._run_access(node)
            elif isinstance(node, Tasklet):
                self._run_tasklet(node)
            elif isinstance(node, MapEntry):
                self._run_map(node)
            elif isinstance(node, MapExit):
                pass  # handled with its entry
            elif isinstance(node, NestedSDFG):
                self._run_nested(node)
            elif isinstance(node, LibraryNode):
                raise RuntimeError(
                    f"unexpanded library node {node.label!r} at codegen; call "
                    f"sdfg.expand_library_nodes() first")
            else:
                raise NotImplementedError(type(node).__name__)

    # ------------------------------------------------------------------
    def _run_access(self, node: AccessNode):
        # direct data->data edges = copies (paper §2.3 host/device copies)
        self.ensure_value(node.data)
        for e in self.state.out_edges(node):
            if isinstance(e.dst, AccessNode):
                src_val = read_memlet(self.env[node.data], e.memlet, self.symenv)
                dst_desc = self.sdfg.arrays[e.dst.data]
                self.ensure_value(e.dst.data)
                out_memlet = Memlet(data=e.dst.data, subset=None)
                self.env[e.dst.data] = write_memlet(
                    self.env[e.dst.data], out_memlet, src_val, self.symenv)

    def _gather_inputs(self, node) -> Dict[str, object]:
        kwargs = {}
        for e in self.state.in_edges(node):
            if e.dst_conn is None or e.memlet.data is None:
                continue
            src_name = e.memlet.data
            self.ensure_value(src_name)
            kwargs[e.dst_conn] = read_memlet(self.env[src_name], e.memlet,
                                             self.symenv)
        return kwargs

    def _scatter_outputs(self, node, result):
        out_edges = [e for e in self.state.out_edges(node)
                     if e.src_conn is not None and e.memlet.data is not None]
        if not isinstance(result, dict):
            conns = sorted({e.src_conn for e in out_edges})
            if isinstance(result, tuple):
                result = dict(zip(getattr(node, "outputs", conns), result))
            elif len(conns) == 1:
                # single output connector (possibly forked to several
                # access nodes — manual replication, paper §4.2)
                result = {conns[0]: result}
        for e in out_edges:
            val = result[e.src_conn]
            name = e.memlet.data
            self.ensure_value(name)
            self.env[name] = write_memlet(self.env[name], e.memlet, val,
                                          self.symenv)

    def _run_tasklet(self, node: Tasklet):
        kwargs = self._gather_inputs(node)
        result = node.fn(**kwargs)
        self._scatter_outputs(node, result)

    def _run_nested(self, node: NestedSDFG):
        inner = node.sdfg
        inner_env: Dict[str, object] = {}
        conn_to_container = {}
        for e in self.state.in_edges(node):
            if e.dst_conn is None:
                continue
            self.ensure_value(e.memlet.data)
            inner_env[e.dst_conn] = read_memlet(
                self.env[e.memlet.data], e.memlet, self.symenv)
        inner_syms = dict(inner.symbol_values)
        for k, v in node.symbol_mapping.items():
            inner_syms[k] = eval_expr(v, self.symenv)
        lower_sdfg_body(inner, inner_env, inner_syms, lowering=type(self),
                        device=self.device, states=self.states)
        for e in self.state.out_edges(node):
            if e.src_conn is None:
                continue
            self.ensure_value(e.memlet.data)
            self.env[e.memlet.data] = write_memlet(
                self.env[e.memlet.data], e.memlet, inner_env[e.src_conn],
                self.symenv)

    # ------------------------------------------------------------------
    # Map lowering
    # ------------------------------------------------------------------
    def _map_scope_edges(self, entry: MapEntry):
        return self.state.memo(("exit", entry), lambda: next(
            n for n in self.state.nodes
            if isinstance(n, MapExit) and n.entry is entry))

    def _run_map(self, entry: MapEntry):
        from ..core.dtypes import ScheduleType
        exit_ = self._map_scope_edges(entry)
        children = self.scopes.get(entry, [])
        inner = [n for n in children if not isinstance(n, MapExit)]
        if self._lower_map_custom(entry, exit_, inner):
            return
        m = entry.map
        static = self._static_syms()
        sizes = [int(eval_expr(r.size, static)) for r in m.ranges]
        starts = [eval_expr(r.start, static) for r in m.ranges]

        # tasklet-only scopes (single mapped tasklets and MapFusion chains
        # threading per-iteration transients) vectorize with one vmap
        tasklet_chain = (all(isinstance(n, Tasklet) for n in inner)
                         and len(inner) >= 1)

        def sequential():
            total = int(np.prod(sizes)) if sizes else 1
            if total > SEQUENTIAL_TRIP_LIMIT:
                raise NotImplementedError(
                    f"map {m.label!r}: {total} sequential iterations exceeds "
                    f"the interpreter's loop limit; restructure as mapped "
                    f"tasklet or compile with the cuda backend's grid "
                    f"kernels")
            self._run_map_sequential(entry, exit_, inner, sizes, starts)

        if m.schedule in (ScheduleType.UNROLLED, ScheduleType.MESH,
                          ScheduleType.MXU):
            self._run_map_sequential(entry, exit_, inner, sizes, starts)
        elif (tasklet_chain
              and not any(self._has_param_slice_writes(t, m) for t in inner)
              and not self._has_dynamic_strides(entry, inner, exit_)):
            snapshot = dict(self.env)
            try:
                self._run_map_vmap(entry, exit_, inner, sizes, starts)
            except DynamicStrideError:
                # a stride only the vmapped parameter bindings reveal:
                # restore the env and take the sequential loop
                self.env.clear()
                self.env.update(snapshot)
                sequential()
        else:
            sequential()

    def _lower_map_custom(self, entry: MapEntry, exit_: MapExit,
                          inner: List) -> bool:
        """Platform map-lowering hook; return True when the map was handled.
        The base (interpreter) backend has no platform strategy."""
        return False

    def _has_dynamic_strides(self, entry: MapEntry, inner: List,
                             exit_: MapExit) -> bool:
        """A subset whose *step* references a map parameter is only known
        once the parameter is bound — the vectorized lowering would see a
        tensor and ``read_memlet``/``write_memlet`` would refuse; route
        such scopes to the sequential loop, where bindings are ints."""
        params = set(entry.map.params)
        nodes = {entry, exit_} | set(inner)
        for e in self.state.edges:
            if e.src not in nodes and e.dst not in nodes:
                continue
            if e.memlet.subset is None:
                continue
            for r in e.memlet.subset:
                if r.step.free_symbols & params:
                    return True
        return False

    def _has_param_slice_writes(self, tasklet: Tasklet, m) -> bool:
        """Vectorized lowering cannot scatter a per-iteration *slice*; such
        maps fall back to the sequential schedule instead of hard-failing.
        Only exit-bound writes count: tasklet->tasklet edges inside a fused
        scope carry per-iteration values, not container writes."""
        params = set(m.params)
        for e in self.state.out_edges(tasklet):
            if isinstance(e.dst, Tasklet):
                continue
            subset = e.memlet.subset
            if subset is None:
                continue
            used = set()
            for r in subset:
                used |= (r.start.free_symbols & params)
            if used and any(not r.is_index() for r in subset):
                return True
        return False

    @staticmethod
    def _partial_tile_pairs(m):
        """(counter, intra, tile, extent) for MapTiling'd parameter pairs
        whose extent is not a tile multiple — the lattice points where
        ``counter*tile + intra >= extent`` are padding and must be
        skipped by the structural lowerings."""
        from ..transforms.map_tiling import normalize_tiling
        pairs = []
        pset = set(m.params)
        for q, info in normalize_tiling(m.annotations.get("tiling", {})).items():
            ext, ts, ctr = info.get("extent"), info.get("tile"), \
                info.get("counter")
            if (q in pset and ctr in pset and ext is not None
                    and int(ext) % int(ts)):
                pairs.append((ctr, q, int(ts), int(ext)))
        return pairs

    def _run_map_sequential(self, entry, exit_, inner, sizes, starts):
        """Python loop (paper: unrolled map = replicated hardware)."""
        m = entry.map
        partial = self._partial_tile_pairs(m)

        def rec(d):
            if d == len(sizes):
                for ctr, q, ts, ext in partial:
                    if self.symenv[ctr] * ts + self.symenv[q] >= ext:
                        return  # padding lane of a partial final tile
                self._exec_scope_once(entry, exit_, inner)
                return
            for i in range(sizes[d]):
                self.symenv[m.params[d]] = starts[d] + i
                rec(d + 1)
            del self.symenv[m.params[d]]

        rec(0)

    def _exec_scope_once(self, entry, exit_, inner):
        """Execute scope contents with params bound in symenv. Edges through
        entry/exit apply their memlets against the enclosing env."""
        order = [n for n in self.topological_nodes() if n in inner]
        for node in order:
            if isinstance(node, Tasklet):
                kwargs = {}
                for e in self.state.in_edges(node):
                    if e.dst_conn is None or e.memlet.data is None:
                        continue
                    self.ensure_value(e.memlet.data)
                    kwargs[e.dst_conn] = read_memlet(
                        self.env[e.memlet.data], e.memlet, self.symenv)
                result = node.fn(**kwargs)
                out_edges = [e for e in self.state.out_edges(node)
                             if e.memlet.data is not None]
                if len(out_edges) == 1 and not isinstance(result, dict):
                    result = {out_edges[0].src_conn: result}
                for e in out_edges:
                    name = e.memlet.data
                    self.ensure_value(name)
                    self.env[name] = write_memlet(
                        self.env[name], e.memlet, result[e.src_conn],
                        self.symenv)
            elif isinstance(node, MapEntry):
                self._run_map(node)
            elif isinstance(node, MapExit):
                pass
            elif isinstance(node, AccessNode):
                self._run_access(node)
            elif isinstance(node, NestedSDFG):
                self._run_nested(node)
            else:
                raise NotImplementedError(type(node).__name__)

    def _run_map_vmap(self, entry, exit_, inner, sizes, starts):
        """Vectorized lowering of tasklet-only scopes: the canonical mapped
        tasklet, and MapFusion chains whose tasklet->tasklet edges thread
        per-iteration transients as local values through one vmapped body.

        Chains carrying *wcr* tasklet->tasklet edges (MapFusion's reduction
        mode) cannot thread per-iteration values — the consumer needs the
        fully accumulated reduction — so they lower through the two-phase
        path: a full-lattice vmap of the producer side, a ``wcr_reduce``
        over the reduction axes, then a kept-lattice vmap of the consumer
        side fed with the reduced values."""
        m = entry.map
        chain_set = set(inner)
        chain = [n for n in self.topological_nodes() if n in chain_set]
        ext_in = {}    # tasklet -> container-reading in-edges
        int_in = {}    # tasklet -> in-kernel intermediate in-edges
        out_edges = []  # exit-bound writes, in chain order
        for t in chain:
            ext_in[t] = [e for e in self.state.in_edges(t)
                         if e.memlet.data is not None
                         and e.src not in chain_set]
            int_in[t] = [e for e in self.state.in_edges(t)
                         if e.src in chain_set]
            out_edges.extend(e for e in self.state.out_edges(t)
                             if e.memlet.data is not None
                             and e.dst not in chain_set)
        for t in chain:
            for e in ext_in[t]:
                self.ensure_value(e.memlet.data)

        captured = {id(e): self.env[e.memlet.data]
                    for t in chain for e in ext_in[t]}
        base_env = dict(self.symenv)
        groups, gsizes = self._vmap_groups(m, sizes, starts)

        wcr_edges = [e for t in chain for e in int_in[t]
                     if e.memlet.wcr is not None]
        if wcr_edges:
            self._run_map_vmap_phased(m, chain, chain_set, ext_in, int_in,
                                      out_edges, captured, base_env,
                                      groups, gsizes, wcr_edges)
            return

        def body(*param_vals):
            local = dict(base_env)
            local.update(dict(zip(m.params, param_vals)))
            vals = {}   # (producer tasklet, connector) -> iteration value
            outs = {}   # id(exit edge) -> value
            for t in chain:
                kwargs = {}
                for e in ext_in[t]:
                    kwargs[e.dst_conn] = read_memlet(captured[id(e)],
                                                     e.memlet, local)
                for e in int_in[t]:
                    kwargs[e.dst_conn] = vals[(e.src, e.src_conn)]
                result = self._normalize_result(t, result_of=t.fn(**kwargs))
                for e in self.state.out_edges(t):
                    if e.dst not in chain_set and e.memlet.data is None:
                        continue
                    v = result[e.src_conn]
                    if e.dst in chain_set:
                        vals[(t, e.src_conn)] = v
                    else:
                        outs[id(e)] = v
            return tuple(outs[id(e)] for e in out_edges)

        if sizes:
            pvals = self._lattice_param_values(groups, gsizes)
            outs = torch.func.vmap(body)(*[pvals[p] for p in m.params])
            stacked = tuple(o.reshape(tuple(gsizes) + o.shape[1:])
                            for o in outs)
        else:
            stacked = body()
        self._scatter_map_outputs(m, groups, gsizes, out_edges, stacked)

    def _normalize_result(self, t, result_of):
        """Coerce a tasklet return value into a connector->value dict."""
        result = result_of
        if isinstance(result, dict):
            return result
        t_out = [e for e in self.state.out_edges(t)
                 if isinstance(e.dst, Tasklet) or e.memlet.data is not None]
        conns = [e.src_conn for e in t_out]
        if isinstance(result, tuple):
            return dict(zip(t.outputs or conns, result))
        return {conns[0]: result}

    def _vmap_groups(self, m, sizes, starts):
        """The vmap lattice is built over *groups*: normally one group per
        parameter (the classic meshgrid), but a MapTiling'd pair whose
        extent is not a tile multiple collapses into one flat group that
        enumerates only the valid (counter, intra) points — the padding
        lanes of the partial final tile never execute, mirroring the grid
        kernels' in-program masking."""
        partial = self._partial_tile_pairs(m)
        pos = {p: i for i, p in enumerate(m.params)}
        in_pair = {}
        for ctr, q, ts, ext in partial:
            in_pair[ctr] = in_pair[q] = (ctr, q, ts, ext)
        groups = []  # (member params, 1-D member value arrays, size)
        done = set()
        for p in m.params:
            if p in done:
                continue
            if p in in_pair and all(x in pos for x in in_pair[p][:2]):
                ctr, q, ts, ext = in_pair[p]
                flat = torch.arange(ext, device=self.device)
                groups.append(((ctr, q),
                               (starts[pos[ctr]] + flat // ts,
                                starts[pos[q]] + flat % ts), ext))
                done |= {ctr, q}
            else:
                i = pos[p]
                groups.append(((p,), (torch.arange(
                    sizes[i], device=self.device) + starts[i],), sizes[i]))
                done.add(p)
        gsizes = [g[2] for g in groups]
        return groups, gsizes

    def _lattice_param_values(self, groups, gsizes):
        """Flat per-parameter coordinate arrays over the full group mesh."""
        mesh = torch.meshgrid(*[torch.arange(s, device=self.device)
                                for s in gsizes], indexing="ij")
        flat_idx = [g.reshape(-1) for g in mesh]
        pvals = {}
        for gi, (params, vals, _) in enumerate(groups):
            for p, v in zip(params, vals):
                pvals[p] = v[flat_idx[gi]]
        return pvals

    def _run_map_vmap_phased(self, m, chain, chain_set, ext_in, int_in,
                             out_edges, captured, base_env, groups, gsizes,
                             wcr_edges):
        """Two-phase vectorized lowering for MapFusion's reduction mode.

        Phase 1 (producer side) runs over the full iteration lattice and
        yields the per-iteration reduction contributions; they are combined
        with :func:`wcr_reduce` over the *reduction axes* — lattice groups
        whose parameters do not address the reduction subset. Phase 2
        (consumer side) then runs once per kept lattice point with the
        reduced value bound to the wcr connector. Shapes the phased path
        cannot express raise :class:`DynamicStrideError`, routing the scope
        to the (already correct) sequential loop."""
        pset = set(m.params)
        phase2 = set()
        work = [e.dst for e in wcr_edges]
        while work:
            t = work.pop()
            if t in phase2:
                continue
            phase2.add(t)
            work.extend(e.dst for e in self.state.out_edges(t)
                        if e.dst in chain_set)
        phase1 = [t for t in chain if t not in phase2]
        p2chain = [t for t in chain if t in phase2]

        for t in phase1:
            for e in self.state.out_edges(t):
                if (e.dst in phase2 and e.memlet.wcr is None):
                    raise DynamicStrideError(
                        "plain producer->consumer edge alongside a wcr edge")
                if e.dst not in chain_set and e.memlet.data is not None:
                    raise DynamicStrideError(
                        "reduction producer also writes through the exit")
        used_sets = []
        for e in wcr_edges:
            if e.memlet.wcr not in WCR_MODES or e.memlet.subset is None:
                raise DynamicStrideError("unsupported in-chain wcr edge")
            used = set()
            for r in e.memlet.subset:
                used |= (r.start.free_symbols & pset)
            used_sets.append(used)
        kept_params = used_sets[0]
        if any(u != kept_params for u in used_sets):
            raise DynamicStrideError(
                "in-chain wcr edges disagree on reduction parameters")
        red_params = pset - kept_params
        for t in p2chain:
            p2_memlets = [e.memlet for e in ext_in[t]]
            p2_memlets += [e.memlet for e in self.state.out_edges(t)
                           if e.dst not in chain_set
                           and e.memlet.data is not None]
            for ml in p2_memlets:
                if ml.subset is None:
                    continue
                for r in ml.subset:
                    syms = (r.start.free_symbols | r.stop.free_symbols
                            | r.step.free_symbols)
                    if syms & red_params:
                        raise DynamicStrideError(
                            "consumer memlet uses a reduction parameter")
        kept = [gi for gi, (params, _, _) in enumerate(groups)
                if set(params) & kept_params]
        for gi in kept:
            if not set(groups[gi][0]) <= kept_params:
                raise DynamicStrideError(
                    "partial-tile group straddles the reduction boundary")
        red_axes = tuple(gi for gi in range(len(groups)) if gi not in kept)
        if not red_axes:
            raise DynamicStrideError("wcr chain reduces over no lattice axis")

        wcr_keys, key_mode = [], {}
        for e in wcr_edges:
            k = (e.src, e.src_conn)
            if k not in key_mode:
                wcr_keys.append(k)
                key_mode[k] = e.memlet.wcr
            elif key_mode[k] != e.memlet.wcr:
                raise DynamicStrideError(
                    "one reduction value consumed under two wcr modes")

        def body1(*param_vals):
            local = dict(base_env)
            local.update(dict(zip(m.params, param_vals)))
            vals = {}
            for t in phase1:
                kwargs = {}
                for e in ext_in[t]:
                    kwargs[e.dst_conn] = read_memlet(captured[id(e)],
                                                     e.memlet, local)
                for e in int_in[t]:
                    kwargs[e.dst_conn] = vals[(e.src, e.src_conn)]
                result = self._normalize_result(t, result_of=t.fn(**kwargs))
                for e in self.state.out_edges(t):
                    if e.dst in chain_set:
                        vals[(t, e.src_conn)] = result[e.src_conn]
            return tuple(vals[k] for k in wcr_keys)

        pvals = self._lattice_param_values(groups, gsizes)
        outs1 = torch.func.vmap(body1)(*[pvals[p] for p in m.params])
        stacked1 = tuple(o.reshape(tuple(gsizes) + o.shape[1:])
                         for o in outs1)
        reduced = tuple(wcr_reduce(key_mode[k], v, red_axes)
                        for k, v in zip(wcr_keys, stacked1))

        kept_groups = [groups[gi] for gi in kept]
        kept_gsizes = [gsizes[gi] for gi in kept]
        kept_plist = [p for g in kept_groups for p in g[0]]

        def body2(red_vals, *param_vals):
            local = dict(base_env)
            local.update(dict(zip(kept_plist, param_vals)))
            vals = dict(zip(wcr_keys, red_vals))
            outs = {}
            for t in p2chain:
                kwargs = {}
                for e in ext_in[t]:
                    kwargs[e.dst_conn] = read_memlet(captured[id(e)],
                                                     e.memlet, local)
                for e in int_in[t]:
                    kwargs[e.dst_conn] = vals[(e.src, e.src_conn)]
                result = self._normalize_result(t, result_of=t.fn(**kwargs))
                for e in self.state.out_edges(t):
                    if e.dst not in chain_set and e.memlet.data is None:
                        continue
                    v = result[e.src_conn]
                    if e.dst in chain_set:
                        vals[(t, e.src_conn)] = v
                    else:
                        outs[id(e)] = v
            return tuple(outs[id(e)] for e in out_edges)

        if kept_gsizes:
            pvals2 = self._lattice_param_values(kept_groups, kept_gsizes)
            red_flat = tuple(r.reshape((-1,) + r.shape[len(kept):])
                             for r in reduced)
            outs2 = torch.func.vmap(body2)(red_flat,
                                           *[pvals2[p] for p in kept_plist])
            stacked2 = tuple(o.reshape(tuple(kept_gsizes) + o.shape[1:])
                             for o in outs2)
        else:
            stacked2 = body2(reduced)
        self._scatter_map_outputs(m, kept_groups, kept_gsizes,
                                  out_edges, stacked2)

    def _scatter_map_outputs(self, m, groups, gsizes, out_edges,
                             stacked):
        """Write the stacked per-lattice-point results of a vmapped scope
        through their exit memlets (index scatter, wcr reduce/combine,
        scalar targets)."""
        static = self._static_syms()
        group_params = [set(g[0]) for g in groups]
        for e, val in zip(out_edges, stacked):
            name = e.memlet.data
            self.ensure_value(name)
            subset = e.memlet.subset
            if subset is None:
                # whole-container write from a mapped tasklet => reduction
                axes = tuple(range(len(groups)))
                if e.memlet.wcr in WCR_MODES:
                    self.env[name] = wcr_combine(
                        e.memlet.wcr, self.env[name],
                        wcr_reduce(e.memlet.wcr, val, axes))
                else:
                    self.env[name] = val
                continue
            # which params appear in each subset dim?
            used_params = set()
            for r in subset:
                used_params |= (r.start.free_symbols & set(m.params))
            unused_axes = tuple(gi for gi, ps in enumerate(group_params)
                                if not (ps & used_params))
            if e.memlet.wcr in WCR_MODES and unused_axes:
                val = wcr_reduce(e.memlet.wcr, val, unused_axes)
                kept = [gi for gi in range(len(groups))
                        if gi not in unused_axes]
            else:
                kept = list(range(len(groups)))
            if not used_params:
                # scalar target
                out_memlet = e.memlet
                self.env[name] = write_memlet(self.env[name], out_memlet, val,
                                              static)
                continue
            # build index arrays per dim over the kept group grid
            kept_grids = torch.meshgrid(
                *[torch.arange(gsizes[gi], device=self.device)
                  for gi in kept], indexing="ij")
            kept_env = dict(static)
            for ax, gi in enumerate(kept):
                params, vals, _ = groups[gi]
                for p, v in zip(params, vals):
                    kept_env[p] = v[kept_grids[ax]]
            idx_arrays = []
            is_slice = False
            for r in subset:
                if not r.is_index():
                    is_slice = True
                    break
                idx_arrays.append(eval_expr(r.start, kept_env))
            if is_slice:
                # slice writes: fall back to sequential semantics
                raise NotImplementedError(
                    f"vectorized slice-write for map {m.label!r}; use "
                    f"sequential schedule")
            idx_arrays = [ia if isinstance(ia, torch.Tensor) else
                          torch.as_tensor(ia, device=self.device)
                          for ia in idx_arrays]
            idx_arrays = torch.broadcast_tensors(*idx_arrays)
            self.env[name] = apply_wcr_at(self.env[name], tuple(idx_arrays),
                                          e.memlet.wcr, val)


# ---------------------------------------------------------------------------
def lower_sdfg_body(sdfg: SDFG, env: Dict[str, object],
                    symenv: Dict[str, object], lowering=None,
                    device: torch.device = torch.device("cpu"),
                    states: Optional[Dict] = None):
    """Execute states in control-flow order against ``env`` in place.
    ``lowering`` selects the per-backend :class:`StateLowering` strategy;
    ``states`` keeps each state's :class:`FrozenState` across calls."""
    lowering = lowering or StateLowering
    order = sdfg.state_order()
    visited_guard = 0
    current = sdfg.start_state if sdfg.start_state is not None else (
        order[0] if order else None)
    done = set()
    while current is not None:
        lowering(sdfg, current, env, symenv, device, states).run()
        done.add(current)
        succs = list(sdfg.cfg.successors(current))
        nxt = None
        for s in succs:
            edge = sdfg.cfg.edges[current, s]["edge"]
            if edge.condition is None or edge.condition(symenv):
                for k, fn in edge.assignments.items():
                    symenv[k] = fn(symenv)
                nxt = s
                break
        visited_guard += 1
        if visited_guard > 10_000:
            raise RuntimeError("control-flow did not terminate")
        current = nxt


def classify_arguments(sdfg: SDFG):
    """inputs = non-transients read before first write (in program order);
    outputs = non-transients written anywhere. A container can be both
    (in/out parameters, DaCe-style)."""
    written, read_first = set(), set()
    for st in sdfg.state_order() or sdfg.states:
        for node in st.topological_nodes():
            if not isinstance(node, AccessNode):
                continue
            desc = sdfg.arrays[node.data]
            if desc.transient:
                continue
            # a node that both writes and reads (in-out) produces before
            # consuming: count the write first
            if st.in_degree(node) > 0:
                written.add(node.data)
            if st.out_degree(node) > 0 and node.data not in written:
                read_first.add(node.data)
    inputs = [n for n in sdfg.argument_names() if n in read_first]
    outputs = sorted(written)
    return inputs, outputs


def to_tensor(v, device: torch.device) -> torch.Tensor:
    """numpy arrays, Python/numpy scalars and tensors -> a tensor on
    ``device`` (no copy when it already lies there)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def build_callable(sdfg: SDFG, device: torch.device, lowering=None):
    """Build fn(**arrays) -> dict of written non-transient containers, as
    tensors on ``device``; inputs (numpy arrays or tensors) move there.
    ``lowering`` selects the per-backend :class:`StateLowering` strategy."""
    inputs, written = classify_arguments(sdfg)
    shard_spec = sdfg.metadata.get("shard_map")
    if shard_spec and int(shard_spec.get("n_shards", 1)) > 1:
        raise NotImplementedError(
            "sharded programs (ShardMapPass, n_shards > 1) are not ported "
            "to the torch package yet")

    states: Dict = {}   # each state's graph queries, kept across calls

    def fn(**kwargs):
        env: Dict[str, object] = {}
        for name in inputs:
            if name not in kwargs:
                raise TypeError(f"missing SDFG argument {name!r}")
        for name, v in kwargs.items():
            env[name] = to_tensor(v, device)
        for name, v in sdfg.constants.items():
            env[name] = to_tensor(v, device)
        symenv = dict(sdfg.symbol_values)
        lower_sdfg_body(sdfg, env, symenv, lowering=lowering, device=device,
                        states=states)
        return {k: env[k] for k in sorted(written)}

    fn.__name__ = f"sdfg_{sdfg.name}"
    return fn
