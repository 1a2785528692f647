"""The programs of the compile spine's first slice, built with the port's
frontend: the paper's Table-1 AXPYDOT and Table-2 GEMVER (with its
composition variants), the fused-DAG rungs of both ladders, and the
wcr-producer -> consumer scope of the two-phase grid kernel.

They mirror the reference package's builders (``benchmarks/axpydot.py``,
``benchmarks/gemver.py`` and the row-sum program of
``tests/test_map_fusion.py``) and the pipelines those benchmarks compile
them with, so the two packages can be held against each other.
"""
from __future__ import annotations

from .core.memlet import Memlet, Subset
from .core.sdfg import SDFG
from .core.symbolic import sym
from .frontends import blas
from .frontends.api import Program, TensorHandle
from .pipeline import (ExpandLibraryNodesPass, GridConversionPass,
                       MapFusionPass, MapTilingPass, PassManager,
                       SetExpansionPreferencePass)
from .transforms import DeviceOffload, StreamingComposition

#: the paper's sizes: 800 MiB per AXPYDOT vector, a 1 GiB GEMVER matrix
AXPYDOT_N = 209_715_200
GEMVER_N = 16_384


def axpydot(n) -> SDFG:
    """result = (a*x + y) . w"""
    p = Program("axpydot")
    a = p.scalar_input("a", "float32")
    x, y, w = (p.input(nm, (n,)) for nm in ("x", "y", "w"))
    p.output("result", blas.dot(blas.axpy(a, x, y), w))
    return p.finalize()


def axpydot_two_producer(n) -> SDFG:
    """result = (a*x + y) . (b*u + v): both dot operands are produced, so
    MapFusion folds both axpys into the dot's scope (one grid kernel)."""
    p = Program("axpydot2")
    a = p.scalar_input("a", "float32")
    b = p.scalar_input("b", "float32")
    x, y, u, v = (p.input(nm, (n,)) for nm in ("x", "y", "u", "v"))
    p.output("result", blas.dot(blas.axpy(a, x, y), blas.axpy(b, u, v)))
    return p.finalize()


def axpydot_grid_pipeline(fused: bool, tiled: bool = True) -> PassManager:
    """The Table-1 grid ladder: ``accumulate`` expansions, MapFusion when
    ``fused``, 128-wide tiles, grid conversion."""
    passes = [SetExpansionPreferencePass(("accumulate", "generic")),
              ExpandLibraryNodesPass()]
    if fused:
        passes.append(MapFusionPass())
    if tiled:
        passes.append(MapTilingPass(tile_size=128))
    passes.append(GridConversionPass())
    return PassManager(passes, name=f"grid_f{int(fused)}_t{int(tiled)}")


def gemver(n, manual_replication=False, replica_in_hbm=True) -> SDFG:
    """B = A + u1 v1^T + u2 v2^T ; x = 0.9 B^T y + z ; w = 1.1 B x.
    ``manual_replication`` forks the second GER's output (paper §4.2);
    ``replica_in_hbm`` pins that replica off-chip as the paper does."""
    p = Program("gemver")
    A = p.input("A", (n, n))
    u1, v1 = p.input("u1", (n,)), p.input("v1", (n,))
    u2, v2 = p.input("u2", (n,)), p.input("v2", (n,))
    yv, zv = p.input("y", (n,)), p.input("z", (n,))
    B1 = blas.ger(A, u1, v1)
    B2 = blas.ger(B1, u2, v2)
    x = blas.gemv(B2, yv, y0=zv, trans=True, alpha=0.9, beta=1.0)
    if manual_replication:
        st = p.state
        rep = p.temp(B2.shape, B2.dtype, name="B2_rep")
        producer_edge = st.in_edges(B2.node)[0]
        rep_node = st.add_access(rep.name)
        st.add_edge(producer_edge.src, producer_edge.src_conn, rep_node,
                    None, Memlet.simple(rep.name))
        B2b = TensorHandle(p, rep.name, B2.shape, B2.dtype, node=rep_node)
        w = blas.gemv(B2b, x, alpha=1.1)
        if replica_in_hbm:
            p.sdfg.metadata["pin_hbm"] = {rep.name}
    else:
        w = blas.gemv(B2, x, alpha=1.1)
    p.output("x_out", x)
    p.output("w_out", w)
    return p.finalize()


def gemver_variants(n):
    """The four composition variants of Table 2, offloaded and streamed:
    naive, streaming, manual replication, both replicas streamed."""
    out = {}
    s = gemver(n)
    s.apply(DeviceOffload)
    out["naive"] = s
    for name, kw in (("streaming", {}),
                     ("manual", {"manual_replication": True}),
                     ("both_streamed", {"manual_replication": True,
                                        "replica_in_hbm": False})):
        s = gemver(n, **kw)
        s.apply(DeviceOffload)
        s.apply(StreamingComposition)
        out[name] = s
    return out


def gemver_chain(n) -> SDFG:
    """B = A + u1 v1^T + u2 v2^T ; w = 1.1 B x — one grid kernel under the
    ``accumulate`` gemv expansion."""
    p = Program("gemver_chain")
    A = p.input("A", (n, n))
    u1, v1 = p.input("u1", (n,)), p.input("v1", (n,))
    u2, v2 = p.input("u2", (n,)), p.input("v2", (n,))
    xv = p.input("xw", (n,))
    B1 = blas.ger(A, u1, v1)
    B2 = blas.ger(B1, u2, v2)
    p.output("w_out", blas.gemv(B2, xv, alpha=1.1))
    return p.finalize()


def gemver_chain_pipeline(preference=("accumulate", "generic"),
                          tiles=None) -> PassManager:
    """Expansion at ``preference``, MapFusion, MapTiling (``tiles``:
    optional ``{"minor", "second"}`` widths), grid conversion."""
    tiles = tiles or {}
    return PassManager([
        SetExpansionPreferencePass(tuple(preference)),
        ExpandLibraryNodesPass(),
        MapFusionPass(),
        MapTilingPass(tile_size=tiles.get("minor"),
                      second_size=tiles.get("second")),
        GridConversionPass(),
    ], name=f"chain_{'_'.join(preference)}")


def rowsum_shift(n, m) -> SDFG:
    """out = 2 * rowsum(A) + y through the transient t: a wcr-producing
    scope feeding an elementwise consumer. After MapFusion the fused scope
    carries an in-kernel wcr edge (the two-phase grid kernel)."""
    s = SDFG("wcr_chain")
    s.add_array("A", (n, m), "float32")
    s.add_array("y", (n,), "float32")
    s.add_array("out", (n,), "float32")
    s.add_transient("t", (n,), "float32")
    st = s.add_state("main", is_start=True)
    i, j, k = sym("i"), sym("j"), sym("k")
    _, _, ex = st.add_mapped_tasklet(
        "rowsum", {"i": (0, n), "j": (0, m)},
        inputs={"a": Memlet.simple("A", Subset.indices([i, j]))},
        outputs={"o": Memlet.simple("t", Subset.indices([i]), wcr="add")},
        fn=lambda a: a * 2.0)
    t_node = next(e.dst for e in st.out_edges(ex) if e.memlet.data == "t")
    st.add_mapped_tasklet(
        "shift", {"k": (0, n)},
        inputs={"v": Memlet.simple("t", Subset.indices([k])),
                "z": Memlet.simple("y", Subset.indices([k]))},
        outputs={"o": Memlet.simple("out", Subset.indices([k]))},
        fn=lambda v, z: v + z, input_nodes={"t": t_node})
    return s
