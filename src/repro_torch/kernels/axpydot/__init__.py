from . import ops  # noqa: F401  (registers the Axpy+Dot fusion)
from .ops import axpydot, axpydot_ref

__all__ = ["axpydot", "axpydot_ref", "ops"]
