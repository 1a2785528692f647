"""Explicit compilation stages: ``Wrapped -> Lowered -> Compiled``.

Mirrors the jax.stages / JaCe idiom on top of the SDFG IR:

  * ``Wrapped``  -- a traceable program builder (what ``@dc_program``
    returns). Calling it builds the raw frontend SDFG; ``.lower()`` builds,
    binds symbols, validates, and enters the IR world.
  * ``Lowered``  -- owns a validated SDFG. ``.optimize(pipeline)`` runs a
    ``PassManager`` of mid-level rewrites in place; ``.compile(backend=..)``
    runs the backend's lowering pipeline on a private copy and emits an
    executable for one device, so one ``Lowered`` can compile to several
    backends and its content hash stays stable for caching.
  * ``Compiled`` -- callable result carrying the expansion/fusion report,
    the pass timings, its device and its cache key.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. A
missing GPU without an explicit CPU device raises: nothing falls back to
the CPU. numpy inputs move to the compiled device and outputs are tensors
there. PyTorch runs eagerly, so there is no ``jit`` stage.

``Lowered.compile`` consults the process-wide ``COMPILATION_CACHE`` keyed
by ``(sdfg.content_hash(), backend, pipeline signature, device)``: a
second compile of an identical program is served without expansion.
"""
from __future__ import annotations

import copy
import inspect
import os
from typing import Iterable, Optional

import torch

from ..core.sdfg import SDFG
from .cache import COMPILATION_CACHE, CompilationCache
from .passes import PassManager, PassLike, default_pipeline

#: backend names, for introspection; the authoritative name->module
#: registry (and the single "unknown backend" error path) is
#: ``codegen.get_backend``, which ``Lowered.compile`` consults.
BACKENDS = ("torch", "cuda")


def _env_verify() -> Optional[str]:
    """Verify mode requested by the environment: ``REPRO_TORCH_VERIFY=1``
    (or ``full``) records per-pass verifier results,
    ``REPRO_TORCH_VERIFY=strict`` raises on the first pass that introduces
    a violation."""
    v = os.environ.get("REPRO_TORCH_VERIFY", "").strip().lower()
    if v in ("", "0", "false", "off"):
        return None
    return "strict" if v == "strict" else "full"


def resolve_device(device=None) -> torch.device:
    """The device a program compiles for: ``cuda`` unless the caller names
    another. Asking for a GPU where none is present raises — there is no
    silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to compile and "
            "run on the CPU")
    return dev


class Stage:
    """Common base so users can isinstance-check any pipeline stage."""


class Wrapped(Stage):
    """A traceable SDFG factory (returned by ``@dc_program``).

    Calling the object builds and returns the raw frontend SDFG (the
    'unoptimized SDFG' of the paper); ``lower`` additionally binds symbol
    values, validates, and returns a :class:`Lowered` stage. Keyword
    arguments not accepted by the builder are treated as symbol bindings,
    e.g. ``wrapped.lower(n=1024)`` for a program over symbolic ``n``.
    """

    def __init__(self, builder, name: str = None):
        self._builder = builder
        self.__name__ = name or getattr(builder, "__name__", "program")
        self.__wrapped__ = builder

    def _split_kwargs(self, kwargs):
        """Builder kwargs vs. leftover symbol bindings."""
        try:
            params = inspect.signature(self._builder).parameters
        except (TypeError, ValueError):
            return kwargs, {}
        if any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
            return kwargs, {}
        accepted = {k: v for k, v in kwargs.items() if k in params}
        leftover = {k: v for k, v in kwargs.items() if k not in params}
        return accepted, leftover

    def __call__(self, *args, **kwargs) -> SDFG:
        build_kwargs, symbols = self._split_kwargs(kwargs)
        sdfg = self._builder(*args, **build_kwargs)
        if not isinstance(sdfg, SDFG):
            raise TypeError(
                f"builder {self.__name__!r} returned {type(sdfg).__name__}, "
                "expected an SDFG")
        if symbols:
            known = set(sdfg.symbols) | sdfg.free_symbols()
            unknown = sorted(set(symbols) - known)
            if unknown:
                raise TypeError(
                    f"{self.__name__}() got unknown keyword(s) {unknown}: "
                    "neither builder parameters nor symbols of the program "
                    f"(symbols: {sorted(known)})")
            sdfg.specialize(**{k: int(v) for k, v in symbols.items()})
        return sdfg

    def lower(self, *args, **kwargs) -> "Lowered":
        sdfg = self(*args, **kwargs)
        sdfg.validate()
        return Lowered(sdfg)

    def __repr__(self):
        return f"Wrapped({self.__name__})"


class Lowered(Stage):
    """A validated SDFG between tracing and codegen.

    ``optimize`` mutates the owned SDFG (mid-level rewrites are meant to
    be observable: off-chip volume, PE counts); ``compile`` never does —
    backend lowering runs on a deep copy unless ``in_place=True`` (the
    legacy ``compile_sdfg`` contract).
    """

    def __init__(self, sdfg: SDFG):
        self._sdfg = sdfg
        self.reports: list = []

    @property
    def sdfg(self) -> SDFG:
        return self._sdfg

    def compiler_ir(self) -> SDFG:
        return self._sdfg

    def specialize(self, **symbol_values: int) -> "Lowered":
        self._sdfg.specialize(**symbol_values)
        return self

    def optimize(self, pipeline: Optional[Iterable[PassLike]] = None,
                 skip: Iterable[str] = ()) -> "Lowered":
        """Run a PassManager (or any iterable of passes / Transformation
        classes) over the owned SDFG, in place. Returns ``self``."""
        if pipeline is None:
            return self
        pm = pipeline if isinstance(pipeline, PassManager) \
            else PassManager(pipeline)
        report = {"pipeline": pm.name}
        pm.run(self._sdfg, report=report, skip=skip)
        self.reports.append(report)
        return self

    def compile(self, backend: str = "torch",
                expansion_level: Optional[str] = None,
                pipeline: Optional[PassManager] = None,
                cache: Optional[CompilationCache] = COMPILATION_CACHE,
                in_place: bool = False,
                device=None,
                verify: Optional[str] = None) -> "Compiled":
        """Lower to an executable with the backend's pass pipeline.

        ``device`` is ``cuda`` unless given (``"cpu"`` runs the plain
        version of every kernel; the tests use it). ``pipeline``
        overrides the backend default (it must then include expansion).
        ``cache=None`` disables caching. ``in_place=True`` expands the
        owned SDFG itself instead of a private copy — that mode never
        touches the cache: the produced callable aliases the caller's live
        (mutable) graph, and a hit would skip the in-place expansion
        legacy callers rely on.

        ``verify`` (``"full"`` / ``"strict"``, default from the
        ``REPRO_TORCH_VERIFY`` environment variable) arms the per-pass
        verification harness — see
        :class:`~repro_torch.pipeline.passes.PassManager`. Results land in
        ``Compiled.report["verify"]``. A verifying compile keys the cache
        separately so a cached unverified artifact is never served where a
        verification record was requested.
        """
        from ..codegen import get_backend
        backend_mod = get_backend(backend)  # validates the name early
        dev = resolve_device(device)
        pm = pipeline if pipeline is not None else default_pipeline(
            backend, expansion_level=expansion_level)
        if verify is None:
            verify = pm.verify if pm.verify is not None else _env_verify()
        if in_place:
            cache = None
        key = None
        if cache is not None:  # content_hash walks the whole graph
            key = (self._sdfg.content_hash(), backend, pm.signature(),
                   str(dev)) + ((verify,) if verify else ())
            hit = cache.lookup(key)
            if hit is not None:
                return hit

        work = self._sdfg if in_place else copy.deepcopy(self._sdfg)
        work.validate()
        report = {"backend": backend, "fused_regions": [], "expansions": [],
                  "passes": [], "grid_kernels": [], "grid_converted": [],
                  "grid_skipped": [], "grid_fallbacks": [],
                  "pipeline": pm.name}
        pm.run(work, report=report, verify=verify)
        work.validate()

        fn = backend_mod.build_callable(work, dev)
        compiled = Compiled(work, fn, backend, report, dev, cache_key=key)
        if cache is not None:
            cache.store(key, compiled)
        return compiled

    def __repr__(self):
        return f"Lowered({self._sdfg})"


class Compiled(Stage):
    """Executable stage: call with keyword arrays (numpy or tensors), get
    a dict of output tensors on ``device``.

    ``report`` carries the structured pipeline record: backend, per-pass
    timings (``report['passes']``), expansion log, fused regions and grid
    kernels.
    """

    def __init__(self, sdfg: SDFG, fn, backend: str, report: dict,
                 device: torch.device, cache_key=None):
        self.sdfg = sdfg
        self.fn = fn
        self.backend = backend
        self.report = report
        self.device = device
        self.cache_key = cache_key

    def __call__(self, **kwargs):
        return self.fn(**kwargs)

    def argument_names(self):
        return self.sdfg.argument_names()

    def __repr__(self):
        return (f"Compiled({self.sdfg.name}, backend={self.backend}, "
                f"device={self.device})")


def lower(sdfg: SDFG, validate: bool = True) -> Lowered:
    """Enter the staged pipeline from a hand-built SDFG."""
    if validate:
        sdfg.validate()
    return Lowered(sdfg)
