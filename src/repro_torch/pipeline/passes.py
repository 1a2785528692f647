"""Composable pass infrastructure over SDFGs.

The paper's multi-level flow (frontend SDFG -> domain passes -> platform
passes -> codegen) is expressed as a ``PassManager``: an ordered, named,
skippable list of ``Pass`` objects with per-pass timing and a structured
report. FLOWER structures its HLS flow the same way; JaCe's
``lower()/compile()`` stages drive an equivalent pipeline.

Three kinds of passes exist:

  * ``TransformationPass`` -- adapts any ``transforms.Transformation``
    (the five mid-level rewrites ship pre-wrapped below);
  * graph-lowering passes -- ``ExpandLibraryNodesPass`` (paper §3 multi-
    level expansion) and ``PipelineFusionPass`` (stream-chain fusion for
    the cuda backend);
  * configuration passes -- ``SetExpansionPreferencePass`` records the
    vendor-specific expansion order on the SDFG.

Every pass has a stable ``signature()`` so a pipeline's configuration can
key the compilation cache. Custom passes register with ``register_pass``
and can then be named in pipelines by string.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from ..core.sdfg import SDFG, _stable_repr
from ..transforms import (DeviceOffload, InputToConstant, MapFusion,
                          MapTiling, StreamingComposition, StreamingMemory,
                          Transformation, Vectorization)

#: name -> Pass subclass, for string lookup in pipelines / custom passes.
PASS_REGISTRY: Dict[str, type] = {}


def register_pass(cls=None, *, name: str = None):
    """Class decorator: make a Pass constructible by name in pipelines."""
    def deco(c):
        PASS_REGISTRY[name or c.__name__] = c
        return c
    return deco(cls) if cls is not None else deco


# canonical, hashable string for pass-option values — the same
# canonicalizer the SDFG content hash uses, so pipeline signatures and
# graph hashes can never drift apart.
_canon = _stable_repr


class Pass:
    """One named rewrite step. Subclasses override ``apply`` (mutates the
    SDFG, returns a summary value recorded in the report) and optionally
    ``should_skip``."""

    #: display/skip name; defaults to the class name.
    name: str = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.__dict__.get("name") is None:
            cls.name = cls.__name__

    def apply(self, sdfg: SDFG, report: dict) -> Any:
        raise NotImplementedError

    def should_skip(self, sdfg: SDFG) -> bool:
        return False

    def options(self) -> Dict[str, Any]:
        """Configuration that affects the pass's behavior (cache key)."""
        return {}

    def signature(self) -> Tuple:
        return (self.name,
                tuple((k, _canon(v)) for k, v in sorted(
                    self.options().items())))

    def __repr__(self):
        opts = ", ".join(f"{k}={v!r}" for k, v in self.options().items())
        return f"{self.name}({opts})"


class TransformationPass(Pass):
    """Adapter: run a ``transforms.Transformation`` everywhere it matches.

    Subclasses set ``transformation``; kwargs are forwarded to
    ``SDFG.apply`` (i.e. to ``find_matches``). The summary is the number
    of applications.
    """

    transformation: type = None

    def __init__(self, transformation: type = None, **kwargs):
        t = transformation or type(self).transformation
        if t is None:
            raise TypeError("TransformationPass needs a transformation")
        if not (isinstance(t, type) and issubclass(t, Transformation)):
            raise TypeError(f"{t!r} is not a Transformation subclass")
        self._transformation = t
        self.kwargs = kwargs
        if type(self).transformation is None:
            self.name = t.__name__

    def apply(self, sdfg: SDFG, report: dict) -> int:
        return sdfg.apply(self._transformation(), **self.kwargs)

    def options(self) -> Dict[str, Any]:
        return {"transformation": self._transformation.__name__,
                **self.kwargs}


# The five mid-level rewrites (paper §3.2), pre-wrapped as passes --------

@register_pass
class DeviceOffloadPass(TransformationPass):
    transformation = DeviceOffload
    name = "DeviceOffload"


@register_pass
class InputToConstantPass(TransformationPass):
    transformation = InputToConstant
    name = "InputToConstant"


@register_pass
class MapFusionPass(TransformationPass):
    """Fuse producer->consumer map scopes (transforms/map_fusion.py): the
    intermediate becomes a per-iteration tasklet->tasklet value (exact
    mode), an in-kernel accumulator (wcr mode), or replicated shifted
    producers (halo mode) instead of an HBM round-trip. Runs after
    expansion (generic subgraphs expose the map pairs) and before
    MapTiling (fused single-parameter maps then tile as one; halo/wcr
    legality needs the untiled iteration boxes).

    Producer scopes left fully dead by multi-consumer halo fusion are
    pruned afterwards, and every refused fusion records its typed reason
    in ``report["grid_skipped"]`` / ``grid_decisions`` so a pipeline
    report explains *why* a pair stayed two kernels."""
    transformation = MapFusion
    name = "MapFusion"

    def apply(self, sdfg: SDFG, report: dict) -> int:
        from ..transforms.map_fusion import prune_dead_scopes
        t = self._transformation()
        count = sdfg.apply(t, **self.kwargs)
        pruned = prune_dead_scopes(sdfg)
        if pruned:
            report.setdefault("pruned_scopes", []).extend(pruned)
        from ..analysis.diagnostics import refusal_code, refusal_diagnostic
        for label, reason in t.explain(sdfg):
            report.setdefault("grid_skipped", []).append(
                (label, f"fusion refused: {reason}"))
            report.setdefault("grid_decisions", []).append(
                {"map": label, "decision": "unfused", "reason": reason,
                 "code": refusal_code("fusion", reason)})
            report.setdefault("refusals", []).append(
                refusal_diagnostic("fusion", label, reason).to_dict())
        return count


@register_pass
class MapTilingPass(TransformationPass):
    transformation = MapTiling
    name = "MapTiling"


@register_pass
class StreamingCompositionPass(TransformationPass):
    transformation = StreamingComposition
    name = "StreamingComposition"


@register_pass
class StreamingMemoryPass(TransformationPass):
    transformation = StreamingMemory
    name = "StreamingMemory"


@register_pass
class VectorizationPass(TransformationPass):
    transformation = Vectorization
    name = "Vectorization"


@register_pass
class SetExpansionPreferencePass(Pass):
    """Record the vendor expansion order consulted by
    ``LibraryNode.pick_expansion`` (paper: Intel vs Xilinx codegen)."""

    name = "SetExpansionPreference"

    def __init__(self, preference: Sequence[str]):
        self.preference = tuple(preference)

    def apply(self, sdfg: SDFG, report: dict):
        sdfg.expansion_preference = self.preference
        return self.preference

    def options(self):
        return {"preference": self.preference}


@register_pass
class PipelineFusionPass(Pass):
    """Fuse stream-connected Library-Node chains into single hand-written
    kernels (codegen/pipeline_fusion.py); cuda backend only."""

    name = "PipelineFusion"

    def apply(self, sdfg: SDFG, report: dict) -> List[str]:
        from ..codegen.pipeline_fusion import fuse_stream_pipelines
        fused = fuse_stream_pipelines(sdfg)
        report.setdefault("fused_regions", []).extend(fused)
        return fused


@register_pass
class GridConversionPass(Pass):
    """Annotate eligible DEVICE/PIPELINED map scopes with derived grid
    specs (``codegen.cuda_backend.analyze_map_scope``): grid from map
    ranges, blocks factored from affine memlet subsets, wcr add/max/min
    as in-program accumulation. The scope's tasklet chain is traced into
    the kernel description the Triton emitter prints
    (``cuda_backend.describe_kernel``). Non-affine / dynamic / misaligned
    scopes, and chains whose bodies leave the traceable vocabulary, are
    left un-annotated and fall back to the structural interpreter — the
    paper's generic-expansion fallback — with the typed reason in
    ``report["grid_fallbacks"]``.

    Conversion is gated by a cost model of one program's on-chip working
    set: a scope only becomes a grid kernel when the block one program
    holds (its operands with windows streamed in chunks, its outputs, its
    accumulators and in-program intermediates) fits
    ``vmem_budget_bytes``, its grid has at least ``min_grid_steps``
    steps, and its fused chain stays under ``max_fused_tasklets``. Scopes
    the model rejects are recorded as ``grid_skipped(reason)`` and stay on
    the vmap path; converted scopes are recorded in ``grid_converted`` with
    their cost estimates. Runs after MapTilingPass so tile annotations
    shape the blocks; cuda backend only."""

    name = "GridConversion"

    #: ``VMEM`` names the on-chip memory of one program: on Hopper a block
    #: may use 227 KB of shared memory (232,448 bytes) and registers. The
    #: budget bounds the working set one generated program holds there.
    DEFAULT_VMEM_BUDGET = 232_448

    #: measured tile crossovers per backend. None has been measured on the
    #: card yet, so the Hopper tile table (``core.dtypes``) applies.
    CALIBRATED_TILES: Dict[str, Dict[str, int]] = {}

    @classmethod
    def default_tiles(cls, backend: str) -> Dict:
        """Per-backend preferred (minor, second) tile widths: the
        calibrated table when a measured entry exists, else empty — the
        caller falls back to the Hopper tile table."""
        return dict(cls.CALIBRATED_TILES.get(backend, {}))

    def __init__(self, vmem_budget_bytes: int = DEFAULT_VMEM_BUDGET,
                 min_grid_steps: int = 2, max_fused_tasklets: int = 16):
        self.vmem_budget_bytes = int(vmem_budget_bytes)
        self.min_grid_steps = int(min_grid_steps)
        self.max_fused_tasklets = int(max_fused_tasklets)

    def options(self) -> Dict[str, Any]:
        return {"vmem_budget_bytes": self.vmem_budget_bytes,
                "min_grid_steps": self.min_grid_steps,
                "max_fused_tasklets": self.max_fused_tasklets}

    # -- cost model -----------------------------------------------------
    def estimate(self, spec, sdfg: SDFG, kernel=None) -> Dict[str, int]:
        """Static cost estimate for a derived grid spec: total grid steps,
        on-chip bytes one program holds (deduplicated in/out blocks with
        windows cut to the streamed chunk, double-buffered as a two-stage
        software pipeline would, plus accumulators), bytes moved per step,
        the real block shape, and chain length. A row kernel (``kernel``'s
        description, one program per map iteration) holds one iteration's
        chunks (``cuda_backend.row_program_bytes``)."""
        from ..codegen.cuda_backend import (program_block, row_program_bytes,
                                            unique_operands)
        steps = 1
        for _, n in spec.grid:
            steps *= n

        def block_bytes(es, held=True):
            desc = sdfg.arrays.get(es.data)
            block = desc.dtype.bytes if desc is not None else 4
            for b in (program_block(spec, es) if held
                      else es.fact.block_shape):
                block *= b
            return block

        vmem = bytes_per_step = 0
        for es in unique_operands(spec):
            vmem += 2 * block_bytes(es)   # two pipeline stages
            bytes_per_step += block_bytes(es, held=False)
        for es in spec.outputs:
            vmem += 2 * block_bytes(es)
            bytes_per_step += block_bytes(es, held=False)
            if es.wcr and es.reduction:
                vmem += block_bytes(es)   # accumulator
        # fused-DAG in-program intermediates: each tasklet->tasklet edge
        # holds one tile-shaped value live in registers (sized with the
        # first output's element width). Halo-fused scopes are charged
        # through the same term — every replicated producer's value is one
        # more tile.
        in_kernel = int(getattr(spec, "internal_edges", 0))
        if in_kernel:
            tile_elems = 1
            for _, b in spec.block_params:
                tile_elems *= b
            desc = sdfg.arrays.get(spec.outputs[0].data) \
                if spec.outputs else None
            elem = desc.dtype.bytes if desc is not None else 4
            vmem += in_kernel * tile_elems * elem
        # two-phase accumulators: one kept-lattice block per in-program
        # wcr value, live across the whole reduction loop
        import numpy as _np
        bp = dict(spec.block_params)
        for w in getattr(spec, "internal_wcr", ()):
            elems = 1
            for q in w.kept_intra:
                elems *= bp.get(q, 1)
            vmem += elems * _np.dtype(w.dtype).itemsize
        if kernel is not None and kernel.desc.row:
            vmem = row_program_bytes(kernel.desc)
        block_shape = (list(spec.outputs[0].fact.effective_shape())
                       if spec.outputs else [])
        return {"grid_steps": steps, "vmem_bytes": vmem,
                "bytes_per_step": bytes_per_step,
                "block_shape": block_shape,
                "in_kernel_values": in_kernel,
                "tasklets": max(1, len(spec.tasklet_labels))}

    def skip_reason(self, est: Dict[str, int]) -> Optional[str]:
        if est["vmem_bytes"] > self.vmem_budget_bytes:
            return (f"blocks pin {est['vmem_bytes']} B of VMEM (shared "
                    f"memory and registers) > budget "
                    f"{self.vmem_budget_bytes} B")
        if est["grid_steps"] < self.min_grid_steps:
            return (f"grid of {est['grid_steps']} step(s) below "
                    f"min_grid_steps={self.min_grid_steps}; vmap path wins")
        if est["tasklets"] > self.max_fused_tasklets:
            return (f"{est['tasklets']} fused tasklets exceed "
                    f"max_fused_tasklets={self.max_fused_tasklets}")
        return None

    def apply(self, sdfg: SDFG, report: dict) -> List[str]:
        from ..analysis.diagnostics import refusal_code, refusal_diagnostic
        from ..codegen.cuda_backend import (GRID_ANNOTATION,
                                            KERNEL_ANNOTATION,
                                            analyze_map_scope, grid_kernel)
        from ..core.memlet import BlockFactorError
        from ..core.sdfg import MapEntry

        # symbols mutated by interstate assignments are not compile-time
        # constants; subsets referencing them must fall back.
        mutated = set()
        for _, _, d in sdfg.cfg.edges(data=True):
            e = d.get("edge")
            if e is not None and e.assignments:
                mutated |= set(e.assignments)
        env = {k: v for k, v in sdfg.symbol_values.items()
               if k not in mutated}

        converted, skipped, fallbacks, decisions = [], [], [], []
        for st in sdfg.states:
            scopes = st.scope_children()
            for node in st.nodes:
                if not isinstance(node, MapEntry):
                    continue
                try:
                    spec = analyze_map_scope(sdfg, st, node, scopes, env)
                    # the chain traced into the generated kernel: a body
                    # the tracer cannot express is a typed refusal here
                    kernel = grid_kernel(sdfg, st, spec, env)
                except BlockFactorError as exc:
                    # drop any annotation from an earlier run: a stale
                    # spec would emit a kernel with outdated blocks
                    node.map.annotations.pop(GRID_ANNOTATION, None)
                    node.map.annotations.pop(KERNEL_ANNOTATION, None)
                    fallbacks.append((node.map.label, str(exc)))
                    report.setdefault("refusals", []).append(
                        refusal_diagnostic("grid_fallback", node.map.label,
                                           str(exc)).to_dict())
                    continue
                est = self.estimate(spec, sdfg, kernel)
                reason = self.skip_reason(est)
                if reason is not None:
                    node.map.annotations.pop(GRID_ANNOTATION, None)
                    node.map.annotations.pop(KERNEL_ANNOTATION, None)
                    skipped.append((node.map.label, reason))
                    decisions.append({"map": node.map.label,
                                      "decision": "vmap", "reason": reason,
                                      "code": refusal_code("grid", reason),
                                      **est})
                    report.setdefault("refusals", []).append(
                        refusal_diagnostic("grid", node.map.label,
                                           reason).to_dict())
                    continue
                node.map.annotations[GRID_ANNOTATION] = spec
                node.map.annotations[KERNEL_ANNOTATION] = kernel
                converted.append({"map": spec.kernel_name, **est})
                decisions.append({"map": spec.kernel_name,
                                  "decision": "grid", "reason": None, **est})
        report.setdefault("grid_kernels", []).extend(
            c["map"] for c in converted)
        report.setdefault("grid_converted", []).extend(converted)
        report.setdefault("grid_skipped", []).extend(skipped)
        report.setdefault("grid_fallbacks", []).extend(fallbacks)
        report.setdefault("grid_decisions", []).extend(decisions)
        return [c["map"] for c in converted]


@register_pass
class ExpandLibraryNodesPass(Pass):
    """Multi-level Library-Node expansion (paper §3): lower every abstract
    node to its implementation subgraph, honoring the SDFG's expansion
    preference (or a forced ``level``)."""

    name = "ExpandLibraryNodes"

    def __init__(self, level: Optional[str] = None):
        self.level = level

    def apply(self, sdfg: SDFG, report: dict) -> List[str]:
        log = sdfg.expand_library_nodes(level=self.level)
        report.setdefault("expansions", []).extend(log)
        return log

    def should_skip(self, sdfg: SDFG) -> bool:
        return not sdfg.all_library_nodes()

    def options(self):
        return {"level": self.level}


# ---------------------------------------------------------------------------
# PassManager
# ---------------------------------------------------------------------------

PassLike = Union[Pass, Transformation, type, str]


def _as_pass(p: PassLike) -> Pass:
    if isinstance(p, Pass):
        return p
    if isinstance(p, str):
        try:
            return PASS_REGISTRY[p]()
        except KeyError:
            raise KeyError(
                f"unknown pass {p!r}; registered: {sorted(PASS_REGISTRY)}")
    if isinstance(p, type) and issubclass(p, Pass):
        return p()
    if isinstance(p, type) and issubclass(p, Transformation):
        return TransformationPass(p)
    if isinstance(p, Transformation):
        wrapped = TransformationPass(type(p))
        wrapped._transformation_instance = p
        # instance may carry constructor state (e.g. tile_size); apply it
        wrapped.apply = lambda sdfg, report, _t=p: sdfg.apply(_t)
        wrapped.options = lambda _t=p: {
            "transformation": type(_t).__name__,
            **{k: v for k, v in vars(_t).items()}}
        return wrapped
    raise TypeError(f"cannot interpret {p!r} as a Pass")


class PassManager:
    """Ordered, named, skippable pass list with per-pass timing.

    ``run`` executes the passes in order against one SDFG, appending one
    entry per pass to ``report['passes']``:

        {"name", "skipped", "seconds", "summary"}

    Passes named in ``skip`` (constructor or ``run`` argument) are recorded
    but not executed. ``signature()`` canonicalizes the full configuration
    for the compilation-cache key.

    ``verify`` names the reference package's static verification harness
    (``"full"`` / ``"strict"``); the verifier is not ported yet, so asking
    for it raises ``NotImplementedError`` instead of silently skipping it.
    """

    def __init__(self, passes: Iterable[PassLike] = (), name: str = "custom",
                 skip: Iterable[str] = (), verify: Optional[str] = None):
        self.name = name
        self.passes: List[Pass] = [_as_pass(p) for p in passes]
        self.skip = set(skip)
        _check_verify(verify)
        self.verify = verify

    def append(self, p: PassLike) -> "PassManager":
        self.passes.append(_as_pass(p))
        return self

    def extend(self, ps: Iterable[PassLike]) -> "PassManager":
        for p in ps:
            self.append(p)
        return self

    def run(self, sdfg: SDFG, report: Optional[dict] = None,
            skip: Iterable[str] = (), verify: Optional[str] = None) -> dict:
        report = report if report is not None else {}
        entries = report.setdefault("passes", [])
        skip_names = self.skip | set(skip)
        _check_verify(verify if verify is not None else self.verify)
        for p in self.passes:
            entry = {"name": p.name, "skipped": False, "seconds": 0.0,
                     "summary": None}
            entries.append(entry)
            if p.name in skip_names or p.should_skip(sdfg):
                entry["skipped"] = True
                continue
            t0 = time.perf_counter()
            entry["summary"] = _summarize(p.apply(sdfg, report))
            entry["seconds"] = time.perf_counter() - t0
        return report

    def signature(self) -> Tuple:
        return (tuple(p.signature() for p in self.passes),
                tuple(sorted(self.skip)))

    def __iter__(self):
        return iter(self.passes)

    def __len__(self):
        return len(self.passes)

    def __repr__(self):
        return (f"PassManager({self.name}: "
                f"{[p.name for p in self.passes]})")


def _check_verify(verify: Optional[str]):
    if verify not in (None, "full", "strict"):
        raise ValueError(f"verify must be None, 'full' or 'strict', "
                         f"got {verify!r}")
    if verify is not None:
        raise NotImplementedError(
            "the static verifier (PassManager(verify=...)) is not ported to "
            "the torch package yet")


def _summarize(result) -> Any:
    """Keep report entries small and printable."""
    if isinstance(result, (list, tuple)) and len(result) > 16:
        return f"{len(result)} items"
    return result


def default_pipeline(backend: str,
                     expansion_level: Optional[str] = None,
                     n_shards: int = 1) -> PassManager:
    """Backend-specific default lowering pipeline (paper §2.1 vendor split).

    ``torch``   -- the interpreter: prefer (torch, generic) expansions;
                   PyTorch's library kernels do the work.
    ``cuda``    -- explicit: fuse stream-connected chains into hand-written
                   kernels first, then prefer (cuda, torch, generic);
                   expanded map pairs fuse (MapFusion) before tiling so
                   producer->consumer chains become single grid kernels.
                   Vectorization records the vector width that MapTiling's
                   alignment-aware multi-dimensional defaults consume
                   (minor dim -> 128, next dim -> dtype-aware rows, the
                   Hopper tile table); a measured crossover table
                   (``GridConversionPass.default_tiles``) would override
                   both preferred widths.

    The pass order is the reference package's. ``n_shards > 1`` (its
    ShardMapPass) is not ported yet and raises.
    """
    if n_shards > 1:
        raise NotImplementedError(
            "ShardMapPass (n_shards > 1) is not ported to the torch "
            "package yet")
    if backend == "cuda":
        tiles = GridConversionPass.default_tiles("cuda")
        return PassManager([
            SetExpansionPreferencePass(("cuda", "torch", "generic")),
            PipelineFusionPass(),
            ExpandLibraryNodesPass(level=expansion_level),
            MapFusionPass(),
            VectorizationPass(),
            MapTilingPass(tile_size=tiles.get("minor"),
                          second_size=tiles.get("second")),
            GridConversionPass(),
        ], name="cuda_default")
    return PassManager([
        SetExpansionPreferencePass(("torch", "generic")),
        ExpandLibraryNodesPass(level=expansion_level),
    ], name="torch_default")
