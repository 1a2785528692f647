"""Stencil Library Node (paper §6, StencilFlow).

One abstract node per stencil operator; expansions:

  * ``torch``  -- the padded-shift PyTorch composite (``generic`` is the
                  same composite, as in the reference package),
  * ``cuda``   -- the hand-written tiled kernel (``kernels/stencil``): a
                  halo'd 2-D tile in shared memory (the 'Xilinx explicit
                  buffers' analogue, §6.2).

Chains of Stencil nodes composed through streams fuse into a single
multi-stage kernel (registered below) — StencilFlow's fully pipelined
multi-stencil architecture with delay buffers as shrinking shared-memory
halos.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from ..codegen.pipeline_fusion import FUSION_REGISTRY
from ..core.sdfg import LibraryNode, SDFG, State
from .util import replace_with_tasklet


class Stencil(LibraryNode):
    """2D stencil with static offsets and runtime scalar coefficients."""
    default_expansion = "torch"

    def __init__(self, name: str, offsets: Sequence[Tuple[int, int]],
                 coeff_names: Sequence[str]):
        super().__init__(name, inputs=["a", "c"], outputs=["b"])
        self.offsets = tuple(tuple(o) for o in offsets)
        self.coeff_names = list(coeff_names)

    @property
    def radius(self) -> int:
        return max(max(abs(di), abs(dj)) for di, dj in self.offsets)


def _stencil_torch(node: Stencil, sdfg: SDFG, state: State):
    offsets = node.offsets

    def fn(a, c):
        from ..kernels.stencil import stencil2d_ref
        return stencil2d_ref(a, c, offsets)

    replace_with_tasklet(node, sdfg, state, fn, "torch")


def _stencil_cuda(node: Stencil, sdfg: SDFG, state: State):
    offsets = node.offsets

    def fn(a, c):
        from ..kernels.stencil import stencil2d
        return stencil2d(a, c, offsets)

    replace_with_tasklet(node, sdfg, state, fn, "cuda")


Stencil.expansions = {"torch": _stencil_torch, "generic": _stencil_torch,
                      "cuda": _stencil_cuda}


def _fuse_stencil_chain(chain, sdfg, state, in_map, out_map):
    """N consecutive stencils -> one fused multi-stage kernel."""
    offsets_per_stage = tuple(n.offsets for n in chain)
    a_c = in_map[(chain[0].label, "a")]
    c_cs = [in_map[(n.label, "c")] for n in chain]
    out_c = out_map[(chain[-1].label, "b")]

    def fn(**kw):
        from ..kernels.stencil import stencil2d_chain
        coeffs = [kw[c] for c in c_cs]
        return {out_c: stencil2d_chain(kw[a_c], coeffs, offsets_per_stage)}

    return fn


# register chains of length 2..6
for _k in range(2, 7):
    FUSION_REGISTRY[tuple(["Stencil"] * _k)] = _fuse_stencil_chain
