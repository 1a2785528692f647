from . import ops  # noqa: F401
from .ops import matmul, matmul_ref

__all__ = ["matmul", "matmul_ref", "ops"]
