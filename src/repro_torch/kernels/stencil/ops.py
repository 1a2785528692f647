"""Wrappers + plain versions of the stencil kernels. Only ``stencil2d`` and
``stencil2d_chain`` have a CUDA kernel yet; the other three plain versions
are the oracles of the kernels still to be ported."""
from __future__ import annotations

from . import kernel as _kernel
from . import ref as _ref

stencil2d = _kernel.stencil2d
stencil2d_chain = _kernel.stencil2d_chain
stencil2d_ref = _ref.stencil2d
stencil2d_chain_ref = _ref.stencil2d_chain
diffusion2d_ref = _ref.diffusion2d
jacobi3d_ref = _ref.jacobi3d
diffusion3d_ref = _ref.diffusion3d
