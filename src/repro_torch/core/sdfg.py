"""Stateful DataFlow multiGraph (SDFG) IR, adapted for Hopper code generation.

Faithful to the paper's Fig.-2 glossary:

  * ``SDFG``        -- control-flow graph of states (+ containers, symbols)
  * ``State``       -- pure-dataflow multigraph
  * ``AccessNode``  -- data container access (Array solid / Stream dashed)
  * ``Tasklet``     -- fine-grained computation; may only touch data that is
                       explicitly passed via dataflow edges
  * ``MapEntry/MapExit`` -- parametric parallelism scope (pipelined/unrolled)
  * ``LibraryNode`` -- abstract behavior ("what"), expanded into parametric
                       subgraphs ("how") at multiple levels (paper §3)
  * ``NestedSDFG``  -- control flow embedded in dataflow
  * edges carry ``Memlet`` annotations capturing *all* data movement

Weakly connected components of a state are independently-schedulable
*processing elements* (paper §2.4); on the GPU these become fused-kernel
stages run by one grid of programs.

The IR also implements the paper's headline analysis: **off-chip data
volume**, computed by summing memlet volumes incident to HBM containers.
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import networkx as nx
import numpy as np

from .dtypes import DType, ScheduleType, StorageType
from .memlet import Memlet, Range, Subset
from .symbolic import Expr, ExprLike, prod

# ---------------------------------------------------------------------------
# Data descriptors
# ---------------------------------------------------------------------------


@dataclass
class Data:
    dtype: DType
    storage: StorageType = StorageType.DEFAULT
    transient: bool = False

    @property
    def is_stream(self) -> bool:
        return isinstance(self, Stream)


@dataclass
class Array(Data):
    shape: Tuple[Expr, ...] = ()
    vector_width: int = 1  # set by the Vectorization transformation

    @property
    def num_elements(self) -> Expr:
        return prod(self.shape) if self.shape else Expr.const(1)

    def bytes(self, env: Dict[str, int]) -> int:
        return self.num_elements.evaluate(env) * self.dtype.bytes


@dataclass
class Scalar(Data):
    @property
    def shape(self):
        return ()

    @property
    def num_elements(self) -> Expr:
        return Expr.const(1)


@dataclass
class Stream(Data):
    """Bounded FIFO (paper §2.5): single-producer, single-consumer on FPGA;
    on the GPU, a block held in registers or shared memory between fused
    pipeline stages.
    ``shape`` models arrays-of-streams (e.g. systolic pipes A_pipe[P+1])."""
    buffer_size: int = 1
    shape: Tuple[Expr, ...] = ()          # array-of-streams dims
    element_shape: Tuple[Expr, ...] = ()  # logical stream payload per push
    total_volume: Optional[Expr] = None   # total elements pushed (for codegen)

    @property
    def num_elements(self) -> Expr:
        return prod(self.shape) if self.shape else Expr.const(1)


# ---------------------------------------------------------------------------
# Graph nodes
# ---------------------------------------------------------------------------

_node_counter = itertools.count()


class Node:
    def __init__(self, label: str = ""):
        self.uid = next(_node_counter)
        self.label = label or f"{type(self).__name__.lower()}_{self.uid}"

    def __repr__(self):
        return f"{type(self).__name__}({self.label})"

    def __hash__(self):
        return self.uid

    def __eq__(self, other):
        return self is other


class AccessNode(Node):
    def __init__(self, data: str):
        super().__init__(data)
        self.data = data


class Tasklet(Node):
    """Computation node. ``fn`` is a callable over torch tensors or
    grid-tracer values (``codegen.vocab``) mapping the input-connector
    values (kwargs) to a dict/tuple of output-connector values — the
    analogue of the paper's C++ tasklet body. Bodies written with Python
    arithmetic and the ``codegen.vocab`` functions run unchanged in the
    torch interpreter and trace into generated Triton grid kernels."""

    def __init__(self, name: str, inputs: Sequence[str], outputs: Sequence[str],
                 fn: Callable, side_effect_free: bool = True):
        super().__init__(name)
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.fn = fn
        self.side_effect_free = side_effect_free


@dataclass
class Map:
    params: List[str]
    ranges: List[Range]
    schedule: ScheduleType = ScheduleType.PIPELINED
    label: str = "map"
    # Unroll/vector hints set by Vectorization / expansions:
    vector_width: int = 1
    #: pass-to-codegen metadata (MapTiling tile structure, derived grid
    #: grid specs, storage hints). Content-hash relevant.
    annotations: Dict[str, Any] = field(default_factory=dict)


class MapEntry(Node):
    def __init__(self, map_: Map):
        super().__init__(map_.label + "_entry")
        self.map = map_


class MapExit(Node):
    def __init__(self, map_: Map, entry: MapEntry):
        super().__init__(map_.label + "_exit")
        self.map = map_
        self.entry = entry


class NestedSDFG(Node):
    def __init__(self, label: str, sdfg: "SDFG", inputs: Sequence[str],
                 outputs: Sequence[str], symbol_mapping: Dict[str, ExprLike] = None):
        super().__init__(label)
        self.sdfg = sdfg
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.symbol_mapping = {k: Expr.wrap(v) for k, v in (symbol_mapping or {}).items()}


class LibraryNode(Node):
    """Abstract-behavior node (paper §3). Subclasses register named
    expansions at decreasing abstraction levels; ``expand`` rewrites the
    node in-place into the chosen implementation subgraph."""

    #: name -> callable(node, sdfg, state) -> None (mutates graph)
    expansions: Dict[str, Callable] = {}
    default_expansion: str = "xla"

    def __init__(self, name: str, inputs: Sequence[str], outputs: Sequence[str]):
        super().__init__(name)
        self.inputs = list(inputs)
        self.outputs = list(outputs)

    # -- context inspection helpers (paper: "Library Nodes can inspect
    #    their context using the surrounding memlets and nodes") ----------
    def in_edges(self, state: "State"):
        return state.in_edges(self)

    def out_edges(self, state: "State"):
        return state.out_edges(self)

    def input_desc(self, state: "State", conn: str) -> Data:
        for e in state.in_edges(self):
            if e.dst_conn == conn:
                return state.sdfg.arrays[e.memlet.data]
        raise KeyError(conn)

    def output_desc(self, state: "State", conn: str) -> Data:
        for e in state.out_edges(self):
            if e.src_conn == conn:
                return state.sdfg.arrays[e.memlet.data]
        raise KeyError(conn)

    def expand(self, sdfg: "SDFG", state: "State", level: Optional[str] = None) -> str:
        level = level or self.pick_expansion(sdfg, state)
        impl = self.expansions[level]
        impl(self, sdfg, state)
        return level

    def pick_expansion(self, sdfg: "SDFG", state: "State") -> str:
        pref = sdfg.expansion_preference
        for name in pref:
            if name in self.expansions:
                return name
        return self.default_expansion


# ---------------------------------------------------------------------------
# Edges
# ---------------------------------------------------------------------------


@dataclass
class DataflowEdge:
    src: Node
    src_conn: Optional[str]
    dst: Node
    dst_conn: Optional[str]
    memlet: Memlet
    key: int = 0  # multigraph key


@dataclass
class InterstateEdge:
    condition: Optional[Callable[[Dict[str, int]], bool]] = None
    assignments: Dict[str, Callable[[Dict[str, int]], int]] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# State: pure dataflow multigraph
# ---------------------------------------------------------------------------


class State:
    def __init__(self, label: str, sdfg: "SDFG"):
        self.label = label
        self.sdfg = sdfg
        self.graph = nx.MultiDiGraph()

    # -- construction ---------------------------------------------------
    def add_node(self, node: Node) -> Node:
        self.graph.add_node(node)
        return node

    def add_access(self, data: str) -> AccessNode:
        return self.add_node(AccessNode(data))

    def add_tasklet(self, name: str, inputs: Sequence[str], outputs: Sequence[str],
                    fn: Callable) -> Tasklet:
        return self.add_node(Tasklet(name, inputs, outputs, fn))

    def add_map(self, label: str, params: Dict[str, Tuple[ExprLike, ExprLike]],
                schedule: ScheduleType = ScheduleType.PIPELINED) -> Tuple[MapEntry, MapExit]:
        m = Map(
            params=list(params.keys()),
            ranges=[Range.make(lo, hi) for lo, hi in params.values()],
            schedule=schedule, label=label,
        )
        entry = MapEntry(m)
        exit_ = MapExit(m, entry)
        self.add_node(entry)
        self.add_node(exit_)
        return entry, exit_

    def add_edge(self, src: Node, src_conn: Optional[str], dst: Node,
                 dst_conn: Optional[str], memlet: Memlet) -> DataflowEdge:
        key = self.graph.add_edge(src, dst)
        e = DataflowEdge(src, src_conn, dst, dst_conn, memlet, key)
        self.graph.edges[src, dst, key]["edge"] = e
        return e

    def add_nested_sdfg(self, sdfg: "SDFG", inputs, outputs, symbol_mapping=None,
                        label: str = "nested") -> NestedSDFG:
        n = NestedSDFG(label, sdfg, inputs, outputs, symbol_mapping)
        sdfg.parent = self.sdfg
        return self.add_node(n)

    def add_mapped_tasklet(self, name: str, params: Dict[str, Tuple[ExprLike, ExprLike]],
                           inputs: Dict[str, Memlet], outputs: Dict[str, Memlet],
                           fn: Callable,
                           schedule: ScheduleType = ScheduleType.PIPELINED,
                           input_nodes: Dict[str, AccessNode] = None,
                           output_nodes: Dict[str, AccessNode] = None):
        """Convenience: access -> map entry -> tasklet -> map exit -> access."""
        entry, exit_ = self.add_map(name, params, schedule)
        t = self.add_tasklet(name, list(inputs.keys()), list(outputs.keys()), fn)
        input_nodes = input_nodes or {}
        output_nodes = output_nodes or {}
        if not inputs:
            self.add_edge(entry, None, t, None, Memlet(data=None))
        for conn, memlet in inputs.items():
            an = input_nodes.get(memlet.data) or self.add_access(memlet.data)
            self.add_edge(an, None, entry, f"IN_{memlet.data}",
                          Memlet.simple(memlet.data))
            self.add_edge(entry, f"OUT_{memlet.data}", t, conn, memlet)
        for conn, memlet in outputs.items():
            an = output_nodes.get(memlet.data) or self.add_access(memlet.data)
            self.add_edge(t, conn, exit_, f"IN_{memlet.data}", memlet)
            self.add_edge(exit_, f"OUT_{memlet.data}", an, None,
                          Memlet.simple(memlet.data, wcr=memlet.wcr))
        return t, entry, exit_

    def remove_node(self, node: Node):
        self.graph.remove_node(node)

    def remove_edge(self, e: DataflowEdge):
        self.graph.remove_edge(e.src, e.dst, e.key)

    # -- queries ----------------------------------------------------------
    @property
    def nodes(self) -> List[Node]:
        return list(self.graph.nodes)

    @property
    def edges(self) -> List[DataflowEdge]:
        return [d["edge"] for _, _, d in self.graph.edges(data=True)]

    def in_edges(self, node: Node) -> List[DataflowEdge]:
        return [d["edge"] for _, _, d in self.graph.in_edges(node, data=True)]

    def out_edges(self, node: Node) -> List[DataflowEdge]:
        return [d["edge"] for _, _, d in self.graph.out_edges(node, data=True)]

    def in_degree(self, node: Node) -> int:
        return self.graph.in_degree(node)

    def out_degree(self, node: Node) -> int:
        return self.graph.out_degree(node)

    def topological_nodes(self) -> List[Node]:
        return list(nx.topological_sort(self.graph))

    def data_nodes(self) -> List[AccessNode]:
        return [n for n in self.graph.nodes if isinstance(n, AccessNode)]

    def library_nodes(self) -> List[LibraryNode]:
        out = [n for n in self.graph.nodes if isinstance(n, LibraryNode)]
        for n in self.graph.nodes:
            if isinstance(n, NestedSDFG):
                for st in n.sdfg.states:
                    out.extend(st.library_nodes())
        return out

    # -- scopes -------------------------------------------------------------
    def scope_children(self) -> Dict[Optional[MapEntry], List[Node]]:
        """Map from scope (None = top level) to directly-contained nodes."""
        result: Dict[Optional[MapEntry], List[Node]] = {None: []}
        scope_of: Dict[Node, Optional[MapEntry]] = {}
        for node in self.topological_nodes():
            preds = [e.src for e in self.in_edges(node)]
            entry_preds = [p for p in preds if isinstance(p, MapEntry)]
            if not preds:
                scope = None
            elif entry_preds:
                scope = entry_preds[0]
            else:
                p = preds[0]
                if isinstance(p, MapExit):
                    scope = scope_of.get(p.entry, None)
                else:
                    scope = scope_of.get(p, None)
            # MapExit closes its own scope:
            if isinstance(node, MapExit):
                scope = scope_of.get(node.entry, None)
            scope_of[node] = scope
            result.setdefault(scope, []).append(node)
            if isinstance(node, MapEntry):
                result.setdefault(node, [])
        return result

    # -- processing elements (paper §2.4) ------------------------------------
    def processing_elements(self) -> List[List[Node]]:
        """Weakly connected components = independently scheduled PEs.
        Components that only synchronize through a shared stream container
        still count as separate PEs (paper: they synchronize by push/pop)."""
        comps = list(nx.weakly_connected_components(self.graph))
        return [list(c) for c in comps]

    # -- the paper's headline metric ------------------------------------------
    def off_chip_volume(self, env: Optional[Dict[str, int]] = None,
                        symbolic: bool = False):
        """Total bytes moved to/from HBM in this state, from memlet
        annotations (paper Tables 1-3 'Off-Chip Volume' column)."""
        env = env or {}
        total = Expr.const(0)
        for e in self.edges:
            for node in (e.src, e.dst):
                if isinstance(node, AccessNode):
                    if node.data in self.sdfg.constants:
                        continue  # InputToConstant: folded into the program
                    desc = self.sdfg.arrays[node.data]
                    if desc.storage.off_chip and not isinstance(desc, Stream):
                        vol = e.memlet.volume_or_subset()
                        if vol is None:
                            vol = desc.num_elements
                        total = total + vol * desc.dtype.bytes
                        break  # count each edge once even if both ends are HBM
        if symbolic:
            return total
        full_env = dict(self.sdfg.symbol_values)
        full_env.update(env)
        return total.evaluate(full_env)

    def __repr__(self):
        return f"State({self.label}, {len(self.nodes)} nodes)"


# ---------------------------------------------------------------------------
# SDFG
# ---------------------------------------------------------------------------


class SDFG:
    def __init__(self, name: str):
        self.name = name
        self.arrays: Dict[str, Data] = {}
        self.symbols: Dict[str, DType] = {}
        self.symbol_values: Dict[str, int] = {}   # defaults / specialization
        self.constants: Dict[str, np.ndarray] = {}  # InputToConstant results
        self.states: List[State] = []
        self.cfg = nx.DiGraph()
        self.start_state: Optional[State] = None
        self.parent: Optional[SDFG] = None
        #: ordered expansion preference used by LibraryNode.pick_expansion,
        #: e.g. ("cuda", "torch", "generic") for the grid backend.
        self.expansion_preference: Tuple[str, ...] = ("torch", "generic")
        #: free-form annotations (transformation history, vector width, ...)
        self.metadata: Dict[str, Any] = {"transformation_history": []}

    # -- containers -----------------------------------------------------
    def _add(self, name: str, desc: Data, allow_exists=False) -> str:
        if name in self.arrays and not allow_exists:
            raise ValueError(f"container {name!r} already exists")
        self.arrays[name] = desc
        return name

    def add_array(self, name: str, shape: Sequence[ExprLike], dtype,
                  storage: StorageType = StorageType.DEFAULT,
                  transient: bool = False) -> str:
        shp = tuple(Expr.wrap(s) for s in shape)
        for s in shp:
            for sname in s.free_symbols:
                self.symbols.setdefault(sname, DType("int64"))
        return self._add(name, Array(dtype=DType(dtype), storage=storage,
                                     transient=transient, shape=shp))

    def add_transient(self, name: str, shape, dtype,
                      storage: StorageType = StorageType.DEFAULT) -> str:
        return self.add_array(name, shape, dtype, storage, transient=True)

    def add_scalar(self, name: str, dtype, storage=StorageType.DEFAULT,
                   transient=False) -> str:
        return self._add(name, Scalar(dtype=DType(dtype), storage=storage,
                                      transient=transient))

    def add_stream(self, name: str, dtype, buffer_size: int = 4,
                   shape: Sequence[ExprLike] = (),
                   element_shape: Sequence[ExprLike] = (),
                   total_volume: ExprLike = None,
                   storage: StorageType = StorageType.VMEM) -> str:
        return self._add(name, Stream(
            dtype=DType(dtype), storage=storage, transient=True,
            buffer_size=buffer_size,
            shape=tuple(Expr.wrap(s) for s in shape),
            element_shape=tuple(Expr.wrap(s) for s in element_shape),
            total_volume=Expr.wrap(total_volume) if total_volume is not None else None))

    # -- states ----------------------------------------------------------
    def add_state(self, label: str, is_start: bool = False) -> State:
        st = State(label, self)
        self.states.append(st)
        self.cfg.add_node(st)
        if is_start or self.start_state is None:
            self.start_state = st
        return st

    def add_state_after(self, prev: State, label: str) -> State:
        st = self.add_state(label)
        self.add_interstate_edge(prev, st)
        return st

    def add_state_before(self, nxt: State, label: str) -> State:
        st = self.add_state(label)
        # redirect incoming edges of nxt
        for pred in list(self.cfg.predecessors(nxt)):
            data = self.cfg.edges[pred, nxt]["edge"]
            self.cfg.remove_edge(pred, nxt)
            self.cfg.add_edge(pred, st, edge=data)
        self.add_interstate_edge(st, nxt)
        if self.start_state is nxt:
            self.start_state = st
        return st

    def add_interstate_edge(self, src: State, dst: State,
                            edge: InterstateEdge = None):
        self.cfg.add_edge(src, dst, edge=edge or InterstateEdge())

    def state_order(self) -> List[State]:
        if not self.states:
            return []
        return list(nx.topological_sort(self.cfg))

    # -- whole-graph queries ------------------------------------------------
    def all_library_nodes(self) -> List[Tuple[State, LibraryNode]]:
        out = []
        for st in self.states:
            for n in st.library_nodes():
                # find owning state (could be nested)
                out.append((st, n))
        return out

    def off_chip_volume(self, env=None, symbolic=False):
        if symbolic:
            total = Expr.const(0)
            for st in self.states:
                total = total + st.off_chip_volume(env, symbolic=True)
            return total
        return sum(st.off_chip_volume(env) for st in self.states)

    def free_symbols(self) -> set:
        out = set()
        for desc in self.arrays.values():
            shape = getattr(desc, "shape", ())
            for s in shape:
                out |= s.free_symbols
        return out

    # -- content hash (pipeline cache key) ----------------------------------
    def content_hash(self) -> str:
        """Structural hash over topology, descriptors, and symbols.

        Two SDFGs built identically (same frontend calls, same transforms)
        hash equal, so the compilation cache can serve repeated
        ``compile()`` calls — including across separately-built but
        identical programs. Mutating the graph, a descriptor, a symbol
        binding, a constant, or compile-relevant metadata changes the hash.
        """
        h = hashlib.sha256()

        def put(*parts):
            for p in parts:
                h.update(repr(p).encode())
                h.update(b"\x00")

        put("sdfg", self.name, self.expansion_preference)
        for name, dt in sorted(self.symbols.items()):
            put("sym", name, dt.name)
        for name, v in sorted(self.symbol_values.items()):
            put("symval", name, v)
        for name, arr in sorted(self.constants.items()):
            a = np.ascontiguousarray(arr)
            put("const", name, a.dtype.str, a.shape,
                hashlib.sha1(a.tobytes()).hexdigest())
        for key in sorted(self.metadata):
            if key == "transformation_history":
                continue  # provenance, not content
            put("meta", key, _stable_repr(self.metadata[key]))
        for name, desc in sorted(self.arrays.items()):
            put("container", name, _descriptor_signature(desc))

        states = {st: i for i, st in enumerate(self.states)}
        for st in self.states:
            put("state", st.label)
            index = {}
            for i, node in enumerate(st.graph.nodes):
                index[node] = i
                put("node", i, _node_signature(node))
            for u, v, k, d in st.graph.edges(keys=True, data=True):
                e = d["edge"]
                put("edge", index[e.src], e.src_conn, index[e.dst],
                    e.dst_conn, k, e.memlet)
        for src, dst, d in self.cfg.edges(data=True):
            e = d.get("edge")
            put("cfedge", states[src], states[dst],
                _callable_fingerprint(getattr(e, "condition", None)),
                sorted((k, _callable_fingerprint(v)) for k, v in
                       (getattr(e, "assignments", None) or {}).items()))
        put("start", states.get(self.start_state))
        return h.hexdigest()

    # -- library-node expansion (paper §3: multi-level lowering) -----------
    def expand_library_nodes(self, level: Optional[str] = None,
                             recursive: bool = True) -> List[str]:
        """Expand until no library nodes remain; returns expansion log."""
        log = []
        progress = True
        while progress:
            progress = False
            for st in list(self.states):
                for node in list(st.graph.nodes):
                    if isinstance(node, LibraryNode):
                        used = node.expand(self, st, level)
                        log.append(f"{node.label}->{used}")
                        progress = True
                    elif isinstance(node, NestedSDFG) and recursive:
                        log.extend(node.sdfg.expand_library_nodes(level))
        return log

    # -- transformations ----------------------------------------------------
    def apply(self, transformation, **kwargs) -> int:
        """Apply a transformation class/instance everywhere it matches.
        Returns number of applications (paper §3.2)."""
        from ..transforms.base import Transformation
        t = transformation() if isinstance(transformation, type) else transformation
        n = t.apply_everywhere(self, **kwargs)
        self.metadata["transformation_history"].append(
            (type(t).__name__, n, kwargs))
        return n

    # -- validation / compilation -------------------------------------------
    def validate(self):
        from .validation import validate_sdfg
        validate_sdfg(self)

    def specialize(self, **symbol_values: int):
        self.symbol_values.update(symbol_values)
        return self

    def compile(self, backend: str = "torch", **kwargs):
        """Legacy one-shot compile; delegates to the staged pipeline
        (pipeline.Lowered) with in-place lowering. Prefer
        ``pipeline.lower(sdfg).compile(...)`` in new code."""
        from ..codegen.compiler import compile_sdfg
        return compile_sdfg(self, backend=backend, **kwargs)

    def argument_names(self) -> List[str]:
        """Non-transient containers = program arguments, in insertion order."""
        return [k for k, v in self.arrays.items()
                if not v.transient and k not in self.constants]

    def __repr__(self):
        return (f"SDFG({self.name}: {len(self.states)} states, "
                f"{len(self.arrays)} containers)")


# ---------------------------------------------------------------------------
# Content-hash helpers
# ---------------------------------------------------------------------------


def _stable_repr(value) -> str:
    if isinstance(value, np.ndarray):
        a = np.ascontiguousarray(value)
        return f"ndarray({a.dtype},{a.shape}," \
               f"{hashlib.sha1(a.tobytes()).hexdigest()})"
    if isinstance(value, dict):
        return "{" + ",".join(f"{k}:{_stable_repr(v)}"
                              for k, v in sorted(value.items())) + "}"
    if isinstance(value, (set, frozenset)):
        return "{" + ",".join(sorted(_stable_repr(v) for v in value)) + "}"
    if isinstance(value, (list, tuple)):
        return "(" + ",".join(_stable_repr(v) for v in value) + ")"
    return repr(value)


def _callable_fingerprint(fn) -> str:
    """Stable-enough identity for a tasklet body / interstate condition:
    qualname + bytecode digest + primitive constants and closure values.
    Distinct-but-equal callables may fingerprint apart (a cache miss, never
    a false hit within one build style)."""
    if fn is None:
        return "none"
    parts = [getattr(fn, "__qualname__", None) or repr(type(fn))]
    code = getattr(fn, "__code__", None)
    if code is not None:
        parts.append(hashlib.sha1(code.co_code).hexdigest())
        # co_names: bytecode only stores name *indices*, so two bodies
        # calling different globals (sin vs cos) share co_code
        parts.append(_stable_repr(code.co_names))
        parts.append(_stable_repr(tuple(
            c for c in code.co_consts
            if isinstance(c, (int, float, str, bytes, bool, type(None))))))
    for d in (getattr(fn, "__defaults__", None) or ()):
        parts.append(_callable_fingerprint(d) if callable(d)
                     else _stable_repr(d))
    for cell in (getattr(fn, "__closure__", None) or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        parts.append(_closure_value_fingerprint(v))
    return "|".join(parts)


def _closure_value_fingerprint(v) -> str:
    if isinstance(v, (int, float, str, bytes, bool, tuple, list, dict, set,
                      frozenset, type(None), np.ndarray)):
        return _stable_repr(v)
    if callable(v):
        return _callable_fingerprint(v)
    if type(v).__module__ == "torch" and hasattr(v, "detach"):
        # tensors: repr would truncate
        return _stable_repr(v.detach().cpu().numpy())
    if hasattr(v, "__array__"):
        return _stable_repr(np.asarray(v))
    # arbitrary object: repr may embed an address — at worst a cache
    # miss across rebuilds, never a false hit
    return f"{type(v).__name__}:{v!r}"


def _descriptor_signature(desc: Data) -> tuple:
    sig = (type(desc).__name__, desc.dtype.name, desc.storage.value,
           desc.transient)
    if isinstance(desc, Stream):
        sig += (desc.buffer_size, desc.shape, desc.element_shape,
                desc.total_volume)
    elif isinstance(desc, Array):
        sig += (desc.shape, desc.vector_width)
    return sig


def _map_signature(m: Map) -> tuple:
    return (m.label, tuple(m.params), tuple(m.ranges), m.schedule.value,
            m.vector_width, _stable_repr(m.annotations))


def _node_signature(node: Node) -> tuple:
    if isinstance(node, AccessNode):
        return ("access", node.data)
    if isinstance(node, Tasklet):
        return ("tasklet", node.label, tuple(node.inputs),
                tuple(node.outputs), _callable_fingerprint(node.fn))
    if isinstance(node, MapEntry):
        return ("map_entry", _map_signature(node.map))
    if isinstance(node, MapExit):
        return ("map_exit", node.map.label)
    if isinstance(node, NestedSDFG):
        return ("nested", node.label, tuple(node.inputs),
                tuple(node.outputs),
                tuple(sorted((k, repr(v))
                             for k, v in node.symbol_mapping.items())),
                node.sdfg.content_hash())
    if isinstance(node, LibraryNode):
        # every instance attribute is potentially computation-defining
        # (Ger.alpha, Gemv.trans, Conv2d.activation, Stencil.offsets, ...)
        attrs = tuple(sorted(
            (k, _callable_fingerprint(v) if callable(v) else _stable_repr(v))
            for k, v in vars(node).items() if k != "uid"))
        return ("library", type(node).__name__, attrs)
    return (type(node).__name__, node.label)
