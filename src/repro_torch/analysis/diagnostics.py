"""Typed diagnostic taxonomy for static SDFG analysis.

Every finding the verifier (``analysis.verify``) or a pass refusal can
produce is a :class:`Diagnostic` carrying a stable code from one
vocabulary, so ``report["grid_decisions"]`` refusals and verifier
violations speak the same language and CI can gate on codes instead of
string-matching prose.

Code families
-------------

``STRUCT``  structural validity (name collisions, connector shadowing)
``RACE``    map-scope and inter-state data races
``BND``     memlet bounds / volume consistency
``ANN``     pass-to-codegen annotation consistency (tiling, grid specs)
``SHD``     shard-map classification consistency
``DON``     buffer-donation aliasing lints
``FUS``     MapFusion refusal reasons (info severity)
``GRD``     GridConversion refusal reasons (info severity)
``SHR``     ShardMap refusal reasons (info severity)
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

#: code -> one-line meaning (the ARCHITECTURE.md table is generated from
#: this registry; keep the descriptions self-contained).
CODES: Dict[str, str] = {
    # structural
    "STRUCT000": "core structural validation failed (core.validation)",
    "STRUCT001": "container name collides with a symbol name",
    "STRUCT002": "tasklet connector shadowing (duplicate connector name)",
    # races
    "RACE001": "write-write race: map iterations write overlapping "
               "elements without wcr",
    "RACE002": "read-write conflict: a map scope reads elements another "
               "iteration writes",
    "RACE003": "inter-state ordering hazard: unordered states access a "
               "container and at least one writes",
    # bounds / volume
    "BND001": "memlet subset provably outside its container under the "
              "map ranges",
    "BND002": "transient consumed outside its produced region",
    "BND003": "memlet volume smaller than its subset",
    # annotation consistency
    "ANN001": "tiling annotation out of sync with the map ranges",
    "ANN002": "derived grid spec out of sync with the map scope",
    # shard classification
    "SHD001": "shard spec names an unknown container or dimension",
    "SHD002": "psum-classified container has no wcr('add') write",
    "SHD003": "replicated-classified container is written per shard",
    # donation lints
    "DON001": "donated buffer is never written (output aliasing hazard)",
    "DON002": "donated name is not a program argument",
    # pass-refusal families (info severity; reasons stay verbatim)
    "FUS001": "fusion refused: access reorder hazard",
    "FUS002": "fusion refused: intermediate not fusible",
    "FUS003": "fusion refused: iteration ranges not static/untiled",
    "FUS004": "fusion refused: replication or tasklet budget exceeded",
    "FUS005": "fusion refused: read pattern unsupported (shift/window/"
              "non-affine)",
    "FUS006": "fusion refused: wcr mode unsupported",
    "FUS007": "fusion refused: fusing would create a cycle",
    "FUS000": "fusion refused: other",
    "GRD001": "grid conversion skipped: VMEM budget exceeded",
    "GRD002": "grid conversion skipped: grid too small",
    "GRD003": "grid conversion skipped: fused chain too long",
    "GRD004": "grid fallback: subset not factorable into BlockSpecs",
    "GRD000": "grid conversion skipped: other",
    "SHR001": "shard refused: nothing to partition",
    "SHR002": "shard refused: read crosses the shard boundary",
    "SHR003": "shard refused: extent not divisible / partial iteration",
    "SHR004": "shard refused: declared classification conflict",
    "SHR000": "shard refused: other",
}


@dataclass(frozen=True)
class Diagnostic:
    """One typed finding. ``pass_name`` is attribution filled in by the
    verification harness (the pass after which the finding first
    appeared); it is excluded from :meth:`key` so the same violation is
    one finding regardless of when it was noticed."""

    code: str
    message: str
    state: Optional[str] = None
    scope: Optional[str] = None         # map label
    container: Optional[str] = None
    severity: str = "error"             # "error" | "info"
    pass_name: Optional[str] = None

    def key(self) -> Tuple:
        return (self.code, self.state, self.scope, self.container,
                self.message)

    def attributed(self, pass_name: str) -> "Diagnostic":
        return replace(self, pass_name=pass_name)

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message,
                "state": self.state, "scope": self.scope,
                "container": self.container, "severity": self.severity,
                "pass": self.pass_name}

    def __str__(self):
        where = "/".join(x for x in (self.state, self.scope,
                                     self.container) if x)
        at = f" [{where}]" if where else ""
        via = f" (introduced by {self.pass_name})" if self.pass_name else ""
        return f"{self.code}{at}: {self.message}{via}"


class VerificationError(Exception):
    """Raised in strict verify mode when a pass introduces violations."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        lines = "\n  ".join(str(d) for d in self.diagnostics)
        super().__init__(f"{len(self.diagnostics)} verifier violation(s):"
                         f"\n  {lines}")


# ---------------------------------------------------------------------------
# Refusal-reason classification (PR-7/PR-9 typed reasons -> codes)
# ---------------------------------------------------------------------------

#: ordered (substring, code) rules per refusal source; first match wins.
#: The verbatim reason strings stay in the report — the code is *added*.
_REFUSAL_RULES = {
    "fusion": (
        ("reorder accesses", "FUS001"),
        ("pinned to HBM", "FUS002"),
        ("not a fusible transient", "FUS002"),
        ("more than one node", "FUS002"),
        ("no unique static write", "FUS002"),
        ("mixes wcr and plain writes", "FUS002"),
        ("untiled scopes", "FUS003"),
        ("static unit-step", "FUS003"),
        ("exceed", "FUS004"),
        ("replication cost threshold", "FUS004"),
        ("cannot be replicated", "FUS004"),
        ("cannot replicate", "FUS004"),
        ("windowed slice", "FUS005"),
        ("shifted", "FUS005"),
        ("outside the producer", "FUS005"),
        ("element-exact", "FUS005"),
        ("rank mismatch", "FUS005"),
        ("affine", "FUS005"),
        ("not bound by the reduction", "FUS005"),
        ("differs from the reduction", "FUS005"),
        ("parameter pairing", "FUS005"),
        ("captures a", "FUS005"),
        ("wcr", "FUS006"),
        ("cycle", "FUS007"),
        ("another path", "FUS007"),
    ),
    "grid": (
        ("VMEM", "GRD001"),
        ("min_grid_steps", "GRD002"),
        ("max_fused_tasklets", "GRD003"),
    ),
    "shard": (
        ("nothing to partition", "SHR001"),
        ("crosses the shard boundary", "SHR002"),
        ("halo", "SHR002"),
        ("offset", "SHR002"),
        ("divisible", "SHR003"),
        ("partial iteration", "SHR003"),
        ("different extents", "SHR003"),
        ("symbolic range", "SHR003"),
        ("declared", "SHR004"),
        ("conflict", "SHR004"),
    ),
}

_REFUSAL_FALLBACK = {"fusion": "FUS000", "grid": "GRD000",
                     "shard": "SHR000", "grid_fallback": "GRD004"}


def refusal_code(source: str, reason: Optional[str]) -> str:
    """Classify a pass-refusal reason string onto the shared taxonomy.

    ``source`` is one of ``fusion`` (MapFusion), ``grid``
    (GridConversion cost model), ``grid_fallback`` (BlockFactorError
    fallbacks), ``shard`` (ShardMapPass). The verbatim reason is never
    rewritten — callers attach the code alongside it."""
    if source == "grid_fallback":
        return "GRD004"
    rules = _REFUSAL_RULES.get(source, ())
    text = reason or ""
    for needle, code in rules:
        if needle in text:
            return code
    return _REFUSAL_FALLBACK.get(source, "GRD000")


def refusal_diagnostic(source: str, scope: Optional[str],
                       reason: Optional[str]) -> Diagnostic:
    """A refusal as an info-severity Diagnostic (shared vocabulary)."""
    return Diagnostic(code=refusal_code(source, reason),
                      message=reason or "", scope=scope, severity="info")
