"""Wrapper + plain version of the tiled GEMM kernel."""
from __future__ import annotations

from . import kernel as _kernel
from . import ref as _ref

matmul = _kernel.matmul
matmul_ref = _ref.matmul
