"""The hand-built programs of the port, built with its frontend and IR:
the paper's Table-1 AXPYDOT and Table-2 GEMVER (with its composition
variants), the fused-DAG rungs of both ladders, the wcr-producer ->
consumer scope of the two-phase grid kernel; and, for the LeNet and
StencilFlow slice, LeNet's conv+relu+pool block, a 4-stage jacobi chain,
a 5-point star and the paper's two-iteration diffusion program; and, for
the serving slice, one batched decode-attention step and the geometry of
the serving benchmark.

They mirror the reference package's builders (``benchmarks/axpydot.py``,
``benchmarks/gemver.py``, ``benchmarks/lenet.py``,
``benchmarks/jacobi_chain.py``, ``examples/stencil_pipeline.py``, the
row-sum program of ``tests/test_map_fusion.py`` and the star of
``tests/test_pallas_grid.py``) and the pipelines those benchmarks compile
them with, so the two packages can be held against each other.
"""
from __future__ import annotations

from .codegen import vocab
from .core.memlet import Memlet, Range, Subset
from .core.sdfg import SDFG
from .core.symbolic import sym
from .frontends import blas
from .frontends.api import Program, TensorHandle, dc_program
from .pipeline import (ExpandLibraryNodesPass, GridConversionPass,
                       MapFusionPass, MapTilingPass, PassManager,
                       PipelineFusionPass, SetExpansionPreferencePass,
                       VectorizationPass)
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


# ---------------------------------------------------------------------------
# The LeNet (§5) and StencilFlow (§6) slice
# ---------------------------------------------------------------------------

#: the paper's LeNet batch (``benchmarks/lenet.py``), the 2-D StencilFlow
#: domain (2^17 x 4096 fp32, 2 GiB a field; ``benchmarks/stencil_bench.py``),
#: a 4-stage jacobi chain whose interior is 2^26 points, and a star5 grid of
#: 16,384^2 interior points
LENET_BATCH = 1000
STENCIL_DOMAIN = (131_072, 4_096)
JACOBI_N = 2 ** 26 + 512
JACOBI_STAGES = 4
JACOBI_MARGIN = 64
STAR_N = 16_386

#: the square Gemm of the ``gemm`` program on the card
GEMM_N = 4_096


@dc_program
def gemm(p, n, dtype="float32"):
    """C = A @ B for (n, n) operands: one Gemm Library Node, which the
    ``cuda`` level expands to the tiled matmul kernel."""
    A = p.input("A", (n, n), dtype)
    B = p.input("B", (n, n), dtype)
    p.output("C", blas.gemm(A, B))


#: the convblock of ``benchmarks/lenet.py``: channels, kernel, input side
CONV_K, CONV_R, CONV_IH = 8, 5, 28
CONV_OH = CONV_IH - CONV_R + 1
CONV_PH = CONV_OH // 2


def convblock(batch) -> SDFG:
    """conv(5x5, K ch) + relu + 2x2 maxpool over a (batch,1,28,28) input
    as two mapped tasklets sharing the feature-map access node; MapFusion
    replicates the conv producer once per pooled offset (one grid
    kernel)."""
    K, R, OH, PH = CONV_K, CONV_R, CONV_OH, CONV_PH
    s = SDFG("convblock")
    s.add_array("x", (batch, 1, CONV_IH, CONV_IH), "float32")
    s.add_array("W", (K, 1, R, R), "float32")
    s.add_array("bias", (K,), "float32")
    s.add_transient("t", (batch, K, OH, OH), "float32")
    s.add_array("y", (batch, K, PH, PH), "float32")
    st = s.add_state("main", is_start=True)
    n, k, oh, ow = sym("n"), sym("k"), sym("oh"), sym("ow")
    _, _, ex = st.add_mapped_tasklet(
        "conv", {"n": (0, batch), "k": (0, K), "oh": (0, OH), "ow": (0, OH)},
        inputs={"xs": Memlet.simple("x", Subset([
                    Range.index(n), Range.index(0),
                    Range.make(oh, oh + R), Range.make(ow, ow + R)])),
                "w": Memlet.simple("W", Subset([
                    Range.index(k), Range.index(0),
                    Range.make(0, R), Range.make(0, R)])),
                "bb": Memlet.simple("bias", Subset.indices([k]))},
        outputs={"o": Memlet.simple("t", Subset.indices([n, k, oh, ow]))},
        fn=lambda xs, w, bb: vocab.maximum(vocab.sum(xs * w) + bb, 0.0))
    t_node = next(e.dst for e in st.out_edges(ex) if e.memlet.data == "t")
    ph, pw = sym("ph"), sym("pw")
    st.add_mapped_tasklet(
        "pool", {"n": (0, batch), "k": (0, K), "ph": (0, PH), "pw": (0, PH)},
        inputs={f"p{u}{v}": Memlet.simple("t", Subset.indices(
                    [n, k, 2 * ph + u, 2 * pw + v]))
                for u in (0, 1) for v in (0, 1)},
        outputs={"o": Memlet.simple("y", Subset.indices([n, k, ph, pw]))},
        fn=lambda p00, p01, p10, p11: vocab.maximum(vocab.maximum(p00, p01),
                                                    vocab.maximum(p10, p11)),
        input_nodes={"t": t_node})
    return s


def perstage_pipeline(name="perstage") -> PassManager:
    """The cuda default pipeline minus MapFusionPass: every stage stays its
    own scope and converts to its own grid kernel."""
    tiles = GridConversionPass.default_tiles("cuda")
    return PassManager([
        SetExpansionPreferencePass(("cuda", "torch", "generic")),
        PipelineFusionPass(),
        ExpandLibraryNodesPass(),
        VectorizationPass(),
        MapTilingPass(tile_size=tiles.get("minor"),
                      second_size=tiles.get("second")),
        GridConversionPass(),
    ], name=name)


def jacobi_chain(n, stages=JACOBI_STAGES) -> SDFG:
    """A 1-D jacobi chain: stage k computes [64(k+1), n - 64(k+1)) from its
    predecessor at i-1, i, i+1; MapFusion replicates producers per offset
    (1 + 3 + 5 + 7 = 16 tasklets for 4 stages) into one grid kernel."""
    s = SDFG("jacobi_chain")
    s.add_array("a", (n,), "float32")
    s.add_array("b", (n,), "float32")
    names = ["a"]
    for k in range(1, stages):
        s.add_transient(f"t{k}", (n,), "float32")
        names.append(f"t{k}")
    names.append("b")
    st = s.add_state("main", is_start=True)
    i = sym("i")
    node_of = {}
    for k in range(stages):
        src, dst = names[k], names[k + 1]
        lo, hi = JACOBI_MARGIN * (k + 1), n - JACOBI_MARGIN * (k + 1)
        _, _, ex = st.add_mapped_tasklet(
            f"jacobi{k}", {"i": (lo, hi)},
            inputs={"w": Memlet.simple(src, Subset.indices([i - 1])),
                    "c": Memlet.simple(src, Subset.indices([i])),
                    "e": Memlet.simple(src, Subset.indices([i + 1]))},
            outputs={"o": Memlet.simple(dst, Subset.indices([i]))},
            fn=lambda w, c, e: 0.25 * w + 0.5 * c + 0.25 * e,
            input_nodes={src: node_of[src]} if src in node_of else None)
        node_of[dst] = next(e.dst for e in st.out_edges(ex)
                            if e.memlet.data == dst)
    return s


def star5(n, m) -> SDFG:
    """5-point star over the interior points of an (n, m) field through
    per-offset index memlets: one partial-coverage grid kernel (the
    boundary of ``b`` is left untouched)."""
    s = SDFG("star5")
    s.add_array("a", (n, m), "float32")
    s.add_array("b", (n, m), "float32")
    st = s.add_state("main", is_start=True)
    i, j = sym("i"), sym("j")
    offs = {"c": (0, 0), "nn": (-1, 0), "ss": (1, 0),
            "ww": (0, -1), "ee": (0, 1)}
    st.add_mapped_tasklet(
        "star", {"i": (1, n - 1), "j": (1, m - 1)},
        inputs={kk: Memlet.simple("a", Subset.indices([i + di, j + dj]))
                for kk, (di, dj) in offs.items()},
        outputs={"o": Memlet.simple("b", Subset.indices([i, j]))},
        fn=lambda c, nn, ss, ww, ee: 0.5 * c + 0.125 * (nn + ss + ww + ee))
    return s


#: the five taps of the paper's Fig.-17 diffusion operator
DIFFUSION_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def diffusion_spec(dimensions=STENCIL_DOMAIN) -> dict:
    """The two-iteration diffusion program of the paper's Fig. 17 (as
    ``examples/stencil_pipeline.py`` writes it) over ``dimensions``."""
    return {
        "name": "diffusion_2it",
        "dimensions": list(dimensions),
        "outputs": ["d"],
        "inputs": {"a": {"data_type": "float32", "input_dims": ["j", "k"]}},
        "program": {
            "b": {"computation": "b = c0*a[j,k] + c1*a[j-1,k] + c2*a[j+1,k] "
                                 "+ c3*a[j,k-1] + c4*a[j,k+1]"},
            "d": {"computation": "d = c0*b[j,k] + c1*b[j-1,k] + c2*b[j+1,k] "
                                 "+ c3*b[j,k-1] + c4*b[j,k+1]"},
        },
    }


# ---------------------------------------------------------------------------
# The serving slice
# ---------------------------------------------------------------------------

#: ``benchmarks/serve_bench.py``'s geometry at its asserted batch: 64
#: requests of a 16-token prompt and 24 new tokens, 16-token pages, a
#: 512-token model length, 64 slots
SERVE_REQUESTS = 64
SERVE_PROMPT = 16
SERVE_NEW_TOKENS = 24
SERVE_PAGE_SIZE = 16
SERVE_MAX_MODEL_LEN = 512
SERVE_MAX_SLOTS = 64


def decode_attention_program(B, C, H, Dh, window=None, dtype="float32"
                             ) -> SDFG:
    """out = PagedAttnDecode(q, k, v, pos): one decode step's attention
    over a gathered (B, C, H, Dh) context, as the serving step holds it."""
    from .library import PagedAttnDecode
    p = Program("decode_attention")
    q = p.input("q", (B, H, Dh), dtype)
    k = p.input("k", (B, C, H, Dh), dtype)
    v = p.input("v", (B, C, H, Dh), dtype)
    pos = p.input("pos", (B,), "int32")
    out = p.add_op(PagedAttnDecode("attn0", window=window),
                   {"q": q, "k": k, "v": v, "pos": pos},
                   out_shapes={"out": (B, H, Dh)}, out_dtypes={"out": dtype})
    p.output("out", out)
    return p.finalize()
