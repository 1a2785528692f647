"""Staged compilation: ``Wrapped -> Lowered -> Compiled``.

Entry points:

  * ``@dc_program`` (frontends.api) returns a :class:`Wrapped`;
  * :func:`lower` wraps a hand-built SDFG into a :class:`Lowered`;
  * ``Lowered.optimize(pipeline)`` runs mid-level passes;
  * ``Lowered.compile(backend=..., device=...)`` runs the backend pipeline
    and caches the result in :data:`COMPILATION_CACHE`.
"""
from .cache import COMPILATION_CACHE, CompilationCache
from .passes import (PASS_REGISTRY, DeviceOffloadPass, ExpandLibraryNodesPass,
                     GridConversionPass, InputToConstantPass, MapFusionPass,
                     MapTilingPass, Pass, PassManager,
                     PipelineFusionPass, SetExpansionPreferencePass,
                     StreamingCompositionPass, StreamingMemoryPass,
                     TransformationPass, VectorizationPass, default_pipeline,
                     register_pass)
from .stages import (BACKENDS, Compiled, Lowered, Stage, Wrapped,
                     resolve_device, lower)

__all__ = [
    "BACKENDS", "COMPILATION_CACHE", "CompilationCache", "Compiled",
    "DeviceOffloadPass", "ExpandLibraryNodesPass", "GridConversionPass",
    "InputToConstantPass",
    "Lowered", "MapFusionPass", "MapTilingPass",
    "PASS_REGISTRY", "Pass", "PassManager",
    "PipelineFusionPass", "SetExpansionPreferencePass", "Stage",
    "StreamingCompositionPass", "StreamingMemoryPass", "TransformationPass",
    "VectorizationPass", "Wrapped", "default_pipeline", "lower",
    "register_pass", "resolve_device",
]
