"""BLAS Library Nodes with multi-level expansions (paper §3.1, §3.3, §4).

Levels per node (selected via ``sdfg.expansion_preference`` or explicitly):

  * ``generic``       -- pure-dataflow subgraph (maps + tasklets), the level
                         mid-level transformations operate on;
  * ``torch``         -- delegate to a torch composite (the MKL/cuBLAS
                         analogue);
  * ``cuda``          -- platform-specialized hand-written Hopper kernel;
  * Dot additionally exposes the paper's two §3.3.1 accumulation strategies:
      ``partial_sums`` (Xilinx analogue: interleaved partial-sum buffer that
      breaks the loop-carried add dependency) and ``accumulate`` (Intel
      analogue: native single fp32 accumulator).
  * Gemm additionally exposes ``systolic`` — the paper's Fig.-6
    one-dimensional systolic array as an UNROLLED map over P processing
    elements chained by pipe streams.
"""
from __future__ import annotations

import torch

from ..codegen import vocab
from ..core.dtypes import ScheduleType
from ..core.memlet import Memlet, Range, Subset
from ..core.sdfg import LibraryNode, SDFG, State
from ..core.symbolic import Expr, sym
from .util import in_edge, operand_nodes, out_edge, replace_with_tasklet, unique_name

# Partial-sum interleaving factor (paper: "buffer of a size larger than the
# latency of the addition"; the reference package's value, kept so the
# generic graphs and their memlet volumes are the same).
PARTIAL_SUM_LANES = 16


# ---------------------------------------------------------------------------
# AXPY: z = a*x + y
# ---------------------------------------------------------------------------
class Axpy(LibraryNode):
    default_expansion = "torch"

    def __init__(self, name="axpy"):
        super().__init__(name, inputs=["a", "x", "y"], outputs=["z"])


def _axpy_torch(node: Axpy, sdfg: SDFG, state: State):
    replace_with_tasklet(node, sdfg, state,
                         lambda a, x, y: a * x + y, "torch")


def _axpy_generic(node: Axpy, sdfg: SDFG, state: State):
    ops = operand_nodes(state, node)
    x_desc = sdfg.arrays[ops["x"].data]
    n = x_desc.shape[0]
    xe, ye, ae = (in_edge(state, node, c) for c in ("x", "y", "a"))
    ze = out_edge(state, node, "z")
    state.remove_node(node)
    state.add_mapped_tasklet(
        f"{node.label}_map", {"i": (0, n)},
        inputs={
            "a": Memlet.simple(ae.memlet.data),
            "x": Memlet.simple(xe.memlet.data, Subset.indices([sym("i")])),
            "y": Memlet.simple(ye.memlet.data, Subset.indices([sym("i")])),
        },
        outputs={"z": Memlet.simple(ze.memlet.data,
                                    Subset.indices([sym("i")]))},
        fn=lambda a, x, y: a * x + y,
        input_nodes={ae.memlet.data: ae.src, xe.memlet.data: xe.src,
                     ye.memlet.data: ye.src},
        output_nodes={ze.memlet.data: ze.dst},
    )


Axpy.expansions = {"torch": _axpy_torch, "generic": _axpy_generic}


# ---------------------------------------------------------------------------
# DOT: result = x . w
# ---------------------------------------------------------------------------
class Dot(LibraryNode):
    default_expansion = "torch"

    def __init__(self, name="dot"):
        super().__init__(name, inputs=["x", "w"], outputs=["result"])


def _dot_torch(node: Dot, sdfg: SDFG, state: State):
    replace_with_tasklet(
        node, sdfg, state,
        lambda x, w: torch.dot(x.to(torch.float32), w.to(torch.float32)),
        "torch")


def _dot_accumulate(node: Dot, sdfg: SDFG, state: State):
    """Intel analogue (§3.3.1): stream into a single native accumulator.
    The fp32 accumulate is native on the GPU, so the subgraph is a mapped
    tasklet with a scalar wcr-add target."""
    ops = operand_nodes(state, node)
    n = sdfg.arrays[ops["x"].data].shape[0]
    xe, we = in_edge(state, node, "x"), in_edge(state, node, "w")
    re = out_edge(state, node, "result")
    state.remove_node(node)
    state.add_mapped_tasklet(
        f"{node.label}_acc", {"i": (0, n)},
        inputs={
            "x": Memlet.simple(xe.memlet.data, Subset.indices([sym("i")])),
            "w": Memlet.simple(we.memlet.data, Subset.indices([sym("i")])),
        },
        outputs={"r": Memlet.simple(re.memlet.data, wcr="add")},
        fn=lambda x, w: x * w,
        input_nodes={xe.memlet.data: xe.src, we.memlet.data: we.src},
        output_nodes={re.memlet.data: re.dst},
    )


def _dot_partial_sums(node: Dot, sdfg: SDFG, state: State):
    """Xilinx analogue (§3.3.1): partial-sum interleaving. The streaming
    phase accumulates into K=PARTIAL_SUM_LANES interleaved partial sums
    (breaking the loop-carried dependency), and an unrolled 'reduce' phase
    collapses them — exactly the paper's two-map structure."""
    K = PARTIAL_SUM_LANES
    ops = operand_nodes(state, node)
    n = sdfg.arrays[ops["x"].data].shape[0]
    dtype = sdfg.arrays[ops["x"].data].dtype
    xe, we = in_edge(state, node, "x"), in_edge(state, node, "w")
    re = out_edge(state, node, "result")
    acc_name = unique_name(sdfg, f"{node.label}_partial")
    from ..core.dtypes import StorageType
    sdfg.add_transient(acc_name, (K,), dtype, storage=StorageType.REG)
    state.remove_node(node)
    # streaming phase: acc[l] += x[c*K+l] * w[c*K+l]
    _, _, ex1 = state.add_mapped_tasklet(
        f"{node.label}_stream", {"c": (0, n / K), "l": (0, K)},
        inputs={
            "x": Memlet.simple(xe.memlet.data,
                               Subset.indices([sym("c") * K + sym("l")])),
            "w": Memlet.simple(we.memlet.data,
                               Subset.indices([sym("c") * K + sym("l")])),
        },
        outputs={"p": Memlet.simple(acc_name, Subset.indices([sym("l")]),
                                    wcr="add")},
        fn=lambda x, w: x * w,
        input_nodes={xe.memlet.data: xe.src, we.memlet.data: we.src},
    )
    acc_node = out_edge(state, ex1, f"OUT_{acc_name}").dst
    # reduce phase: unrolled over the K partials (W-1 adders in the paper)
    state.add_mapped_tasklet(
        f"{node.label}_reduce", {"l": (0, K)},
        inputs={"p": Memlet.simple(acc_name, Subset.indices([sym("l")]))},
        outputs={"r": Memlet.simple(re.memlet.data, wcr="add")},
        fn=lambda p: p,
        schedule=ScheduleType.UNROLLED,
        input_nodes={acc_name: acc_node},
        output_nodes={re.memlet.data: re.dst},
    )


def _dot_cuda(node: Dot, sdfg: SDFG, state: State):
    from ..kernels.dot import ops as dot_ops
    replace_with_tasklet(node, sdfg, state, dot_ops.dot_tasklet, "cuda")


Dot.expansions = {
    "torch": _dot_torch,
    "generic": _dot_partial_sums,   # generic == the portable partial-sum graph
    "partial_sums": _dot_partial_sums,
    "accumulate": _dot_accumulate,
    "cuda": _dot_cuda,
}


# ---------------------------------------------------------------------------
# GEMV: y = alpha * op(A) x (+ beta*y0)
# ---------------------------------------------------------------------------
class Gemv(LibraryNode):
    default_expansion = "torch"

    def __init__(self, name="gemv", trans: bool = False, alpha: float = 1.0,
                 beta: float = 0.0):
        ins = ["A", "x"] + (["y0"] if beta != 0.0 else [])
        super().__init__(name, inputs=ins, outputs=["y"])
        self.trans = trans
        self.alpha = alpha
        self.beta = beta


def _gemv_torch(node: Gemv, sdfg: SDFG, state: State):
    trans, alpha, beta = node.trans, node.alpha, node.beta

    def fn(A, x, y0=None):
        Au = A.T if trans else A
        y = alpha * (Au @ x)
        if beta != 0.0 and y0 is not None:
            y = y + beta * y0
        return y

    replace_with_tasklet(node, sdfg, state, fn, "torch")


def _gemv_generic(node: Gemv, sdfg: SDFG, state: State):
    """Row-streaming generic expansion: map over output rows, each a Dot-like
    reduction (tiles-by-rows scheme; for trans, tiles-by-columns — paper §4.2
    access-pattern matching)."""
    ops = operand_nodes(state, node)
    A_desc = sdfg.arrays[ops["A"].data]
    n, m = A_desc.shape
    rows = m if node.trans else n
    trans, alpha, beta = node.trans, node.alpha, node.beta
    Ae, xe = in_edge(state, node, "A"), in_edge(state, node, "x")
    ye = out_edge(state, node, "y")
    y0e = in_edge(state, node, "y0") if beta != 0.0 else None
    state.remove_node(node)
    if trans:
        a_sub = Subset([Range.make(0, n), Range.index(sym("i"))])
    else:
        a_sub = Subset([Range.index(sym("i")), Range.make(0, m)])
    inputs = {
        "Arow": Memlet.simple(Ae.memlet.data, a_sub),
        "x": Memlet.simple(xe.memlet.data),
    }
    input_nodes = {Ae.memlet.data: Ae.src, xe.memlet.data: xe.src}
    if y0e is not None:
        inputs["y0"] = Memlet.simple(y0e.memlet.data,
                                     Subset.indices([sym("i")]))
        input_nodes[y0e.memlet.data] = y0e.src

    def fn(Arow, x, y0=None):
        v = alpha * vocab.dot(vocab.to_f32(vocab.ravel(Arow)),
                              vocab.to_f32(x))
        if y0 is not None:
            v = v + beta * y0
        return v

    state.add_mapped_tasklet(
        f"{node.label}_rows", {"i": (0, rows)},
        inputs=inputs,
        outputs={"y": Memlet.simple(ye.memlet.data,
                                    Subset.indices([sym("i")]))},
        fn=fn, input_nodes=input_nodes,
        output_nodes={ye.memlet.data: ye.dst},
    )


def _gemv_accumulate(node: Gemv, sdfg: SDFG, state: State):
    """Elementwise-exact accumulate expansion: one (i, j) map whose
    tasklet contributes ``alpha * A[i, j] * x[j]`` to ``y[i]`` under
    wcr-add (``y[j] += A[i, j] * x[i]`` for trans). Unlike the
    row-streaming expansion, every A read is a single element over the
    full (i, j) space — exactly the shape MapFusion fuses with an
    upstream producer of A over the same space (ger -> gemv chains become
    ONE grid kernel with the updated matrix held in-kernel).

    ``beta * y0`` seeds through a separate elementwise wcr-add map:
    addition commutes, so the seed and the accumulation maps need no
    ordering edge between their writes."""
    ops = operand_nodes(state, node)
    n, m = sdfg.arrays[ops["A"].data].shape
    trans, alpha, beta = node.trans, node.alpha, node.beta
    Ae, xe = in_edge(state, node, "A"), in_edge(state, node, "x")
    ye = out_edge(state, node, "y")
    y0e = in_edge(state, node, "y0") if beta != 0.0 else None
    state.remove_node(node)
    i, j = sym("i"), sym("j")
    out_idx, x_idx = (j, i) if trans else (i, j)
    state.add_mapped_tasklet(
        f"{node.label}_acc", {"i": (0, n), "j": (0, m)},
        inputs={
            "A": Memlet.simple(Ae.memlet.data, Subset.indices([i, j])),
            "x": Memlet.simple(xe.memlet.data, Subset.indices([x_idx])),
        },
        outputs={"y": Memlet.simple(ye.memlet.data,
                                    Subset.indices([out_idx]), wcr="add")},
        fn=lambda A, x: alpha * A * x,
        input_nodes={Ae.memlet.data: Ae.src, xe.memlet.data: xe.src},
        output_nodes={ye.memlet.data: ye.dst},
    )
    if y0e is not None:
        rows = m if trans else n
        k = sym("k")
        state.add_mapped_tasklet(
            f"{node.label}_seed", {"k": (0, rows)},
            inputs={"y0": Memlet.simple(y0e.memlet.data,
                                        Subset.indices([k]))},
            outputs={"y": Memlet.simple(ye.memlet.data,
                                        Subset.indices([k]), wcr="add")},
            fn=lambda y0: beta * y0,
            input_nodes={y0e.memlet.data: y0e.src},
            output_nodes={ye.memlet.data: ye.dst},
        )


Gemv.expansions = {"torch": _gemv_torch, "generic": _gemv_generic,
                   "accumulate": _gemv_accumulate}


# ---------------------------------------------------------------------------
# GER: A' = A + alpha * outer(x, y)
# ---------------------------------------------------------------------------
class Ger(LibraryNode):
    default_expansion = "torch"

    def __init__(self, name="ger", alpha: float = 1.0):
        super().__init__(name, inputs=["A", "x", "y"], outputs=["Aout"])
        self.alpha = alpha


def _ger_torch(node: Ger, sdfg: SDFG, state: State):
    alpha = node.alpha
    replace_with_tasklet(node, sdfg, state,
                         lambda A, x, y: A + alpha * torch.outer(x, y),
                         "torch")


def _ger_generic(node: Ger, sdfg: SDFG, state: State):
    ops = operand_nodes(state, node)
    n, m = sdfg.arrays[ops["A"].data].shape
    alpha = node.alpha
    Ae, xe, ye = (in_edge(state, node, c) for c in ("A", "x", "y"))
    oe = out_edge(state, node, "Aout")
    state.remove_node(node)
    state.add_mapped_tasklet(
        f"{node.label}_map", {"i": (0, n), "j": (0, m)},
        inputs={
            "A": Memlet.simple(Ae.memlet.data,
                               Subset.indices([sym("i"), sym("j")])),
            "x": Memlet.simple(xe.memlet.data, Subset.indices([sym("i")])),
            "y": Memlet.simple(ye.memlet.data, Subset.indices([sym("j")])),
        },
        outputs={"out": Memlet.simple(oe.memlet.data,
                                      Subset.indices([sym("i"), sym("j")]))},
        fn=lambda A, x, y: A + alpha * x * y,
        input_nodes={Ae.memlet.data: Ae.src, xe.memlet.data: xe.src,
                     ye.memlet.data: ye.src},
        output_nodes={oe.memlet.data: oe.dst},
    )


Ger.expansions = {"torch": _ger_torch, "generic": _ger_generic}


# ---------------------------------------------------------------------------
# GEMM: C = A @ B
# ---------------------------------------------------------------------------
class Gemm(LibraryNode):
    default_expansion = "torch"

    def __init__(self, name="gemm"):
        super().__init__(name, inputs=["A", "B"], outputs=["C"])


def _gemm_torch(node: Gemm, sdfg: SDFG, state: State):
    replace_with_tasklet(
        node, sdfg, state,
        lambda A, B: torch.matmul(A.to(torch.float32), B.to(torch.float32)
                                  ).to(A.dtype), "torch")


def _gemm_systolic(node: Gemm, sdfg: SDFG, state: State):
    """Paper Fig. 6: one-dimensional systolic array as an UNROLLED map over
    P processing elements connected by pipe streams. PE p computes a block
    of C rows while forwarding the streamed B matrix down the chain
    (B enters the head of the chain once per row-tile: volume K*M*N/(P*Tn),
    matching the Fig.-7 annotation with tile height P*Tn)."""
    P = int(sdfg.metadata.get("systolic_pes", 4))
    ops = operand_nodes(state, node)
    N, K = sdfg.arrays[ops["A"].data].shape
    K2, M = sdfg.arrays[ops["B"].data].shape
    dtype = sdfg.arrays[ops["A"].data].dtype
    Ae, Be = in_edge(state, node, "A"), in_edge(state, node, "B")
    Ce = out_edge(state, node, "C")
    A_name, B_name, C_name = Ae.memlet.data, Be.memlet.data, Ce.memlet.data
    state.remove_node(node)

    b_pipe = unique_name(sdfg, f"{node.label}_B_pipe")
    sdfg.add_stream(b_pipe, dtype, buffer_size=1, shape=(P + 1,),
                    element_shape=(K, M), total_volume=K * M)
    a_pipe = unique_name(sdfg, f"{node.label}_A_pipe")
    sdfg.add_stream(a_pipe, dtype, buffer_size=1, shape=(P + 1,),
                    element_shape=(N, K), total_volume=N * K)

    pipe_in = state.add_access(b_pipe)
    apipe_in = state.add_access(a_pipe)
    # read_B: memory reader PE (paper red box) pushes B into the pipe head
    read_b = state.add_tasklet(f"{node.label}_read_B", ["mem"], ["pipe"],
                               lambda mem: mem)
    state.add_edge(Be.src, None, read_b, "mem",
                   Memlet.simple(B_name, volume=Expr.wrap(K * M)))
    state.add_edge(read_b, "pipe", pipe_in, None,
                   Memlet.simple(b_pipe,
                                 Subset([Range.index(0), Range.make(0, K),
                                         Range.make(0, M)]),
                                 volume=Expr.wrap(K * M)))
    read_a = state.add_tasklet(f"{node.label}_read_A", ["mem"], ["pipe"],
                               lambda mem: mem)
    state.add_edge(Ae.src, None, read_a, "mem",
                   Memlet.simple(A_name, volume=Expr.wrap(N * K)))
    state.add_edge(read_a, "pipe", apipe_in, None,
                   Memlet.simple(a_pipe,
                                 Subset([Range.index(0), Range.make(0, N),
                                         Range.make(0, K)]),
                                 volume=Expr.wrap(N * K)))

    # the systolic chain: unrolled map over P PEs (paper: each instance is a
    # weakly-connected component => an independently scheduled PE)
    entry, exit_ = state.add_map(f"{node.label}_pes", {"p": (0, P)},
                                 schedule=ScheduleType.UNROLLED)
    rows = N // P

    def pe_fn(a_in, a_mine, b_in):
        # PE p: forward the A and B streams down the chain unchanged, keep
        # my row block, contribute my C tile (paper Fig. 6 buffering scheme).
        c_blk = torch.matmul(a_mine.to(torch.float32),
                             b_in.to(torch.float32)).to(a_mine.dtype)
        return {"a_out": a_in, "b_out": b_in, "c_blk": c_blk}

    pe = state.add_tasklet(f"{node.label}_pe", ["a_in", "a_mine", "b_in"],
                           ["a_out", "b_out", "c_blk"], pe_fn)

    p = sym("p")
    state.add_edge(apipe_in, None, entry, f"IN_{a_pipe}",
                   Memlet.simple(a_pipe))
    state.add_edge(pipe_in, None, entry, f"IN_{b_pipe}", Memlet.simple(b_pipe))
    state.add_edge(entry, f"OUT_{a_pipe}", pe, "a_in",
                   Memlet.simple(a_pipe,
                                 Subset([Range.index(p), Range.make(0, N),
                                         Range.make(0, K)]),
                                 volume=Expr.wrap(N * K)))
    state.add_edge(entry, f"OUT_{a_pipe}", pe, "a_mine",
                   Memlet.simple(a_pipe,
                                 Subset([Range.index(p),
                                         Range.make(p * rows, (p + 1) * rows),
                                         Range.make(0, K)]),
                                 volume=Expr.wrap(N * K) / P))
    state.add_edge(entry, f"OUT_{b_pipe}", pe, "b_in",
                   Memlet.simple(b_pipe,
                                 Subset([Range.index(p), Range.make(0, K),
                                         Range.make(0, M)]),
                                 volume=Expr.wrap(K * M) * P))
    # forward to next pipe slot
    state.add_edge(pe, "a_out", exit_, f"IN_{a_pipe}",
                   Memlet.simple(a_pipe,
                                 Subset([Range.index(p + 1), Range.make(0, N),
                                         Range.make(0, K)]),
                                 volume=Expr.wrap(N * K)))
    state.add_edge(pe, "b_out", exit_, f"IN_{b_pipe}",
                   Memlet.simple(b_pipe,
                                 Subset([Range.index(p + 1), Range.make(0, K),
                                         Range.make(0, M)]),
                                 volume=Expr.wrap(K * M) * P))
    state.add_edge(pe, "c_blk", exit_, f"IN_{C_name}",
                   Memlet.simple(C_name,
                                 Subset([Range.make(p * rows, (p + 1) * rows),
                                         Range.make(0, M)]),
                                 volume=Expr.wrap(N * M)))
    apipe_out = state.add_access(a_pipe)
    bpipe_out = state.add_access(b_pipe)
    state.add_edge(exit_, f"OUT_{a_pipe}", apipe_out, None,
                   Memlet.simple(a_pipe, volume=Expr.wrap(N * K)))
    state.add_edge(exit_, f"OUT_{b_pipe}", bpipe_out, None,
                   Memlet.simple(b_pipe, volume=Expr.wrap(K * M) * P))
    state.add_edge(exit_, f"OUT_{C_name}", Ce.dst, None,
                   Memlet.simple(C_name, volume=Expr.wrap(N * M)))


def _gemm_cuda(node: Gemm, sdfg: SDFG, state: State):
    """The hand-written tiled matmul kernel (``kernels/gemm``)."""
    from ..kernels.gemm import matmul
    replace_with_tasklet(node, sdfg, state, lambda A, B: matmul(A, B),
                         "cuda")


Gemm.expansions = {
    "torch": _gemm_torch,
    "systolic": _gemm_systolic,
    "generic": _gemm_torch,
    "cuda": _gemm_cuda,
}
