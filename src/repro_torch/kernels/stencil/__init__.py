from . import ops  # noqa: F401
from .ops import (diffusion2d_ref, diffusion3d_ref, jacobi3d_ref, stencil2d,
                  stencil2d_chain, stencil2d_chain_ref, stencil2d_ref)

__all__ = ["diffusion2d_ref", "diffusion3d_ref", "jacobi3d_ref", "stencil2d",
           "stencil2d_chain", "stencil2d_chain_ref", "stencil2d_ref", "ops"]
