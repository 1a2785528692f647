"""Library Nodes: abstract behavior, multi-level expansions (paper §3)."""
from .blas import Axpy, Dot, Gemm, Gemv, Ger

__all__ = ["Axpy", "Dot", "Gemm", "Gemv", "Ger"]
