"""Legacy one-shot compile entry point, a shim over the staged pipeline
(repro_torch.pipeline): ``compile_sdfg(s, ...)`` is exactly
``pipeline.lower(s).compile(..., in_place=True)``.

The backend split (paper §2.1) lives in ``pipeline.passes
.default_pipeline``: ``torch`` prefers (torch, generic) expansions and
lets PyTorch's kernels do the work (the Intel-OpenCL analogue); ``cuda``
runs pipeline-fusion first and prefers (cuda, torch, generic) (the
Vivado-HLS analogue). Both produce the same function semantics; tests
cross-validate them.

``in_place=True`` preserves the contract that the caller's SDFG is
expanded by compilation (callers inspect the lowered graph); staged
callers get a pristine ``Lowered`` plus a private compiled copy. In-place
compiles bypass ``pipeline.COMPILATION_CACHE`` — the produced callable
would alias the caller's live graph and a hit would skip the in-place
expansion — so only the staged path (``Lowered.compile``) is cached.
"""
from __future__ import annotations

from typing import Optional

from ..core.sdfg import SDFG
from ..pipeline.stages import BACKENDS, Compiled, Lowered

#: compat alias: the executable stage used to be defined here.
CompiledSDFG = Compiled


def compile_sdfg(sdfg: SDFG, backend: str = "torch",
                 expansion_level: Optional[str] = None,
                 device=None) -> Compiled:
    return Lowered(sdfg).compile(
        backend=backend, expansion_level=expansion_level, device=device,
        in_place=True)
