from . import ops  # noqa: F401
from .ops import dot, dot_ref

__all__ = ["dot", "dot_ref", "ops"]
