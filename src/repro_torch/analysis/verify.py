"""The verifier: one entry point over all static checks, plus the
snapshot/diff helpers the :class:`~repro_torch.pipeline.passes.PassManager`
harness uses to attribute new violations to the pass that introduced
them.

``verify_sdfg`` is pure — it never mutates the SDFG and never raises
on a finding (strictness is the harness's job via
:class:`~repro_torch.analysis.diagnostics.VerificationError`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..core.sdfg import MapEntry, NestedSDFG, SDFG
from ..core.validation import ValidationError, validate_sdfg
from .annotations import check_annotations
from .bounds import check_bounds
from .diagnostics import Diagnostic
from .race import check_races


def check_structure(sdfg: SDFG) -> List[Diagnostic]:
    """Run the raising core validator and fold failures into the
    diagnostic stream (STRUCT000; the named STRUCT001/STRUCT002 checks
    live in ``core.validation`` itself and surface through here)."""
    try:
        validate_sdfg(sdfg)
    except ValidationError as exc:
        code = getattr(exc, "code", None) or "STRUCT000"
        return [Diagnostic(code=code, message=str(exc))]
    return []


def verify_sdfg(sdfg: SDFG) -> List[Diagnostic]:
    """All error-severity findings for an SDFG, deterministic order."""
    diags: List[Diagnostic] = []
    diags.extend(check_structure(sdfg))
    diags.extend(check_races(sdfg))
    diags.extend(check_bounds(sdfg))
    diags.extend(check_annotations(sdfg))
    return diags


# ---------------------------------------------------------------------------
# Structural snapshots (the harness's per-pass state diff)
# ---------------------------------------------------------------------------


def snapshot(sdfg: SDFG) -> Dict:
    """Cheap structural fingerprint of the SDFG: containers, per-state
    node/edge counts, map annotations, metadata keys. The harness diffs
    consecutive snapshots so a report reader can see *what* a pass
    changed next to any violation it introduced."""
    containers = {}
    for name, desc in sdfg.arrays.items():
        containers[name] = (
            type(desc).__name__,
            tuple(repr(s) for s in (getattr(desc, "shape", ()) or ())),
            bool(getattr(desc, "transient", False)),
            getattr(getattr(desc, "storage", None), "value", None),
        )
    states = {}
    annotations = {}
    for st in sdfg.states:
        states[st.label] = (len(st.nodes), len(st.edges))
        for n in st.nodes:
            if isinstance(n, MapEntry):
                annotations[f"{st.label}/{n.map.label}"] = tuple(
                    sorted(n.map.annotations))
            elif isinstance(n, NestedSDFG):
                inner = snapshot(n.sdfg)
                for k, v in inner["annotations"].items():
                    annotations[f"{st.label}/{n.label}/{k}"] = v
    return {
        "containers": containers,
        "states": states,
        "annotations": annotations,
        "metadata": tuple(sorted(k for k in sdfg.metadata
                                 if k != "transformation_history")),
    }


def diff_snapshots(before: Dict, after: Dict) -> Dict:
    """{section: {added: [...], removed: [...], changed: [...]}} with
    empty sections omitted — ``{}`` means the pass was structurally a
    no-op at this granularity."""
    out: Dict = {}
    for section in ("containers", "states", "annotations"):
        b, a = before.get(section, {}), after.get(section, {})
        added = sorted(set(a) - set(b))
        removed = sorted(set(b) - set(a))
        changed = sorted(k for k in set(a) & set(b) if a[k] != b[k])
        if added or removed or changed:
            out[section] = {"added": added, "removed": removed,
                            "changed": changed}
    bm, am = set(before.get("metadata", ())), set(after.get("metadata", ()))
    if bm != am:
        out["metadata"] = {"added": sorted(am - bm),
                           "removed": sorted(bm - am), "changed": []}
    return out
