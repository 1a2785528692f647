"""Python frontend (paper §3.1): build SDFGs from numpy-like programs.

The paper's frontend parses Python/NumPy with BLAS extensions; here we
provide the equivalent builder API plus a ``@dc_program`` decorator:

    @dc_program
    def axpydot(p, n=dc_symbol("n")):
        x = p.input("x", (n,), "float32")
        y = p.input("y", (n,), "float32")
        w = p.input("w", (n,), "float32")
        a = p.scalar_input("a", "float32")
        z = blas.axpy(a, x, y)
        r = blas.dot(z, w)
        p.output("result", r)

    axpydot.lower(n=1024).optimize([...]).compile(backend="cuda")

``@dc_program`` returns a ``pipeline.Wrapped`` stage: calling it builds
the raw SDFG; ``.lower()`` enters the staged Wrapped -> Lowered ->
Compiled flow (ARCHITECTURE.md). Handles track access nodes; each op
appends Library Nodes to the current state, exchanging data through
(initially off-chip) transient arrays — the 'unoptimized SDFG' the
mid-level transformations then rewrite.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, Union

from ..core.dtypes import StorageType
from ..core.memlet import Memlet
from ..core.sdfg import AccessNode, LibraryNode, SDFG, State
from ..core.symbolic import Expr, ExprLike, sym


class TensorHandle:
    def __init__(self, program: "Program", name: str, shape: Tuple[Expr, ...],
                 dtype: str, node: Optional[AccessNode] = None):
        self.program = program
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self._node = node

    @property
    def node(self) -> AccessNode:
        if self._node is None:
            self._node = self.program.state.add_access(self.name)
        return self._node

    def read_node(self) -> AccessNode:
        return self.node

    def fresh_write_node(self) -> AccessNode:
        self._node = self.program.state.add_access(self.name)
        return self._node

    def __repr__(self):
        return f"TensorHandle({self.name}{list(self.shape)}:{self.dtype})"


class Program:
    """SDFG builder with a single (extendable) dataflow state."""

    def __init__(self, name: str):
        self.sdfg = SDFG(name)
        self.state = self.sdfg.add_state("main", is_start=True)
        self._tmp = itertools.count()
        self._label_counts: dict = {}

    def fresh_label(self, base: str) -> str:
        """Program-local deterministic labels (``axpy0``, ``axpy1``, ...):
        two identical builds produce identical labels, so their SDFGs
        content-hash equal and share one compilation-cache entry."""
        k = self._label_counts.get(base, 0)
        self._label_counts[base] = k + 1
        return f"{base}{k}"

    # -- containers ------------------------------------------------------
    def input(self, name: str, shape: Sequence[ExprLike], dtype="float32"
              ) -> TensorHandle:
        self.sdfg.add_array(name, shape, dtype)
        return TensorHandle(self, name,
                            tuple(Expr.wrap(s) for s in shape), dtype)

    def scalar_input(self, name: str, dtype="float32") -> TensorHandle:
        self.sdfg.add_scalar(name, dtype)
        return TensorHandle(self, name, (), dtype)

    def temp(self, shape: Sequence[ExprLike], dtype="float32",
             name: str = None) -> TensorHandle:
        name = name or f"tmp{next(self._tmp)}"
        self.sdfg.add_transient(name, shape, dtype)
        return TensorHandle(self, name,
                            tuple(Expr.wrap(s) for s in shape), dtype)

    def output(self, name: str, value: TensorHandle) -> TensorHandle:
        """Promote a temp to a named program output."""
        if value.name in self.sdfg.arrays and value.name == name:
            self.sdfg.arrays[name].transient = False
            return value
        desc = self.sdfg.arrays[value.name]
        desc.transient = False
        # rename container to the requested name
        if name != value.name:
            if name in self.sdfg.arrays:
                raise ValueError(
                    f"cannot rename {value.name!r} to output {name!r}: a "
                    f"container named {name!r} already exists in the "
                    "program; pick a fresh output name or write into the "
                    "existing container explicitly")
            self.sdfg.arrays[name] = self.sdfg.arrays.pop(value.name)
            for st in self.sdfg.states:
                for n in st.data_nodes():
                    if n.data == value.name:
                        n.data = name
                        n.label = name
                for e in st.edges:
                    if e.memlet.data == value.name:
                        e.memlet.data = name
            value.name = name
        return value

    # -- op plumbing -------------------------------------------------------
    def add_op(self, node: LibraryNode,
               inputs: dict, out_shapes: dict, out_dtypes: dict = None
               ) -> Union[TensorHandle, Tuple[TensorHandle, ...]]:
        """Wire a library node: inputs are TensorHandles keyed by connector;
        outputs become fresh transients."""
        st = self.state
        st.add_node(node)
        for conn, h in inputs.items():
            st.add_edge(h.read_node(), None, node, conn,
                        Memlet.simple(h.name))
        outs = []
        for conn in node.outputs:
            shape = out_shapes[conn]
            dtype = (out_dtypes or {}).get(conn) or \
                next(iter(inputs.values())).dtype
            h = self.temp(shape, dtype, name=f"{node.label}_{conn}")
            st.add_edge(node, conn, h.fresh_write_node(), None,
                        Memlet.simple(h.name))
            outs.append(h)
        return outs[0] if len(outs) == 1 else tuple(outs)

    # -- finalize ---------------------------------------------------------
    def finalize(self) -> SDFG:
        self.sdfg.validate()
        return self.sdfg


def dc_program(fn):
    """Decorator: fn(program, ...) builds; returns a traceable
    ``pipeline.Wrapped`` stage. Calling the result traces the builder and
    returns the raw SDFG; ``.lower(**symbol_bindings)`` returns a
    ``Lowered`` stage for ``.optimize(...)`` / ``.compile(backend=...)``."""
    from ..pipeline.stages import Wrapped

    def factory(*args, **kwargs) -> SDFG:
        p = Program(fn.__name__)
        fn(p, *args, **kwargs)
        return p.finalize()
    factory.__name__ = fn.__name__
    # symbol-binding split inspects the builder's own signature, not the
    # factory wrapper's (*args/**kwargs would swallow everything)
    factory.__signature__ = _builder_signature(fn)
    return Wrapped(factory, name=fn.__name__)


def _builder_signature(fn):
    """Signature of ``fn`` minus its leading Program parameter."""
    import inspect
    sig = inspect.signature(fn)
    params = list(sig.parameters.values())[1:]
    return sig.replace(parameters=params)
