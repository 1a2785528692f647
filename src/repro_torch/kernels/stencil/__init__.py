from . import ops  # noqa: F401
from .kernel import StencilLimitError
from .ops import (diffusion2d, diffusion2d_ref, diffusion3d, diffusion3d_ref,
                  jacobi3d, jacobi3d_ref, stencil2d, stencil2d_chain,
                  stencil2d_chain_ref, stencil2d_ref)

__all__ = ["StencilLimitError", "diffusion2d", "diffusion2d_ref",
           "diffusion3d", "diffusion3d_ref", "jacobi3d", "jacobi3d_ref",
           "stencil2d", "stencil2d_chain", "stencil2d_chain_ref",
           "stencil2d_ref", "ops"]
