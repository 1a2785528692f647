"""Hand-written Hopper kernels for compute hot-spots.

Each kernel package ships kernel.py (the wrapper that launches the CUDA
kernel of ``csrc/``), ops.py (fusion/library registration) and ref.py (the
plain PyTorch version). A wrapper takes the plain version only for tensors
that lie on the CPU; on CUDA tensors it launches its kernel or raises.
Importing this package registers all pipeline-fusion patterns.
"""
from . import axpydot  # noqa: F401
from . import dot  # noqa: F401

__all__ = ["axpydot", "dot"]
