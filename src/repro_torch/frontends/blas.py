"""BLAS frontend ops (paper §3.1): emit BLAS Library Nodes.

Mirrors the paper's Fig.-9 usage: ``blas.axpy(a,x,y)``, ``blas.dot(z,w)``,
plus the GEMVER constituents (Ger, Gemv) and Gemm."""
from __future__ import annotations

from ..library.blas import Axpy, Dot, Gemm, Gemv, Ger
from .api import Program, TensorHandle


def axpy(a: TensorHandle, x: TensorHandle, y: TensorHandle) -> TensorHandle:
    p = x.program
    return p.add_op(Axpy(p.fresh_label("axpy")), {"a": a, "x": x, "y": y},
                    {"z": x.shape})


def dot(x: TensorHandle, w: TensorHandle) -> TensorHandle:
    p = x.program
    return p.add_op(Dot(p.fresh_label("dot")), {"x": x, "w": w},
                    {"result": (1,)})


def ger(A: TensorHandle, x: TensorHandle, y: TensorHandle,
        alpha: float = 1.0) -> TensorHandle:
    p = A.program
    return p.add_op(Ger(p.fresh_label("ger"), alpha=alpha),
                    {"A": A, "x": x, "y": y}, {"Aout": A.shape})


def gemv(A: TensorHandle, x: TensorHandle, y0: TensorHandle = None,
         trans: bool = False, alpha: float = 1.0, beta: float = 0.0
         ) -> TensorHandle:
    p = A.program
    n, m = A.shape
    out_shape = (m,) if trans else (n,)
    ins = {"A": A, "x": x}
    if beta != 0.0 and y0 is not None:
        ins["y0"] = y0
    return p.add_op(Gemv(p.fresh_label("gemv"), trans=trans, alpha=alpha,
                         beta=beta), ins, {"y": out_shape})


def gemm(A: TensorHandle, B: TensorHandle) -> TensorHandle:
    p = A.program
    n, k = A.shape
    k2, m = B.shape
    return p.add_op(Gemm(p.fresh_label("gemm")), {"A": A, "B": B},
                    {"C": (n, m)})
