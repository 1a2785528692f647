"""Hand-written Hopper kernels for compute hot-spots.

Each kernel package ships kernel.py (the wrapper that launches the CUDA
kernel of ``csrc/``), ops.py (fusion/library registration) and ref.py (the
plain PyTorch version). A wrapper takes the plain version only for tensors
that lie on the CPU; on CUDA tensors it launches its kernel or raises.
Importing this package registers all pipeline-fusion patterns: Axpy+Dot
here, Conv2d+MaxPool2d and the Stencil chains in the library modules that
hold their nodes.
"""
from . import attention  # noqa: F401
from . import axpydot  # noqa: F401
from . import dot  # noqa: F401
from . import gemm  # noqa: F401
from . import rwkv  # noqa: F401
from . import stencil  # noqa: F401
from ..library import nn as _nn  # noqa: F401  (Conv2d+MaxPool2d fusion)
from ..library import stencil as _stencil  # noqa: F401  (Stencil chains)

__all__ = ["attention", "axpydot", "dot", "gemm", "rwkv", "stencil"]
