"""Wrappers + plain versions of the stencil kernels: ``stencil2d`` and
``stencil2d_chain`` (``csrc/stencil.cu``), and the Fig.-19 stars
``diffusion2d``, ``jacobi3d`` and ``diffusion3d`` (``csrc/stencil_star.cu``);
the ``*_ref`` names are the plain versions."""
from __future__ import annotations

from . import kernel as _kernel
from . import ref as _ref
from . import star as _star

stencil2d = _kernel.stencil2d
stencil2d_chain = _kernel.stencil2d_chain
diffusion2d = _star.diffusion2d
jacobi3d = _star.jacobi3d
diffusion3d = _star.diffusion3d
stencil2d_ref = _ref.stencil2d
stencil2d_chain_ref = _ref.stencil2d_chain
diffusion2d_ref = _ref.diffusion2d
jacobi3d_ref = _ref.jacobi3d
diffusion3d_ref = _ref.diffusion3d
