"""Compile-and-verify lint over the port's programs and served steps.

``python -m repro_torch.analysis.lint`` compiles every program the
reference's lint covers (``repro_torch.programs``, at the reference
lint's sizes) and, with ``--arch``, the serving decode step of a reduced
model-zoo config, through **both** backend pipelines with the
verification harness armed, and emits one machine-readable JSON report:
per target/backend the error-severity diagnostics (verifier findings,
attributed to the introducing pass where known) and the info-severity
refusal stream. Exit status is non-zero iff any error-severity diagnostic
(or a compile crash) was found.

``--device`` is ``cuda`` unless given and raises without a card, as every
entry point of the port does; ``--device cpu`` compiles for the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

BACKENDS = ("torch", "cuda")


def program_targets() -> Dict[str, Callable]:
    """Name -> SDFG builder: the reference lint's seven benchmark programs
    at its sizes, built by ``repro_torch.programs``."""
    from .. import programs
    return {
        "axpydot": lambda: programs.axpydot(256),
        "axpydot_two_producer": lambda: programs.axpydot_two_producer(256),
        "gemver": lambda: programs.gemver(64),
        "gemver_chain": lambda: programs.gemver_chain(64),
        "star_stencil": lambda: programs.star5(64, 64),
        "jacobi_chain": lambda: programs.jacobi_chain(128),
        "lenet_convblock": lambda: programs.convblock(2),
    }


def model_lowered(arch: str, device):
    """Lowered serving decode step for a reduced model-zoo config —
    exercises the donation metadata and (for the cuda pipeline) the
    grid/tiling annotation checks on a real multi-layer program."""
    import dataclasses

    import torch

    from ..configs import get_config
    from ..models.transformer import TransformerLM
    from ..serving.compile import DecodeStepCompiler

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    compiler = DecodeStepCompiler(model, params, page_size=8, n_pages=16,
                                  device=device)
    return compiler._lowered(B=2, ctx=16), compiler


def _lint_one(name: str, make_lowered: Callable, backend: str, device,
              pipeline=None) -> dict:
    from ..pipeline.stages import Lowered

    entry = {"target": name, "backend": backend, "ok": True,
             "diagnostics": [], "refusals": [], "error": None}
    try:
        low = make_lowered()
        if not isinstance(low, Lowered):
            from ..pipeline import lower
            low = lower(low)
        cp = low.compile(backend=backend, cache=None, verify="full",
                         pipeline=pipeline, device=device)
        vrec = cp.report.get("verify") or {}
        diags = list(vrec.get("baseline", ()))
        for p in vrec.get("passes", ()):
            diags.extend(p.get("violations", ()))
        errors = [d for d in diags if d.get("severity", "error") == "error"]
        entry["diagnostics"] = errors
        entry["refusals"] = list(cp.report.get("refusals", ()))
        entry["passes"] = [p["name"] for p in vrec.get("passes", ())]
        entry["ok"] = not errors
    except Exception as exc:
        entry["ok"] = False
        entry["error"] = f"{type(exc).__name__}: {exc}"
        entry["traceback"] = traceback.format_exc(limit=8)
    return entry


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="compile every program (and selected model-zoo "
                    "configs' served steps) through both backend pipelines "
                    "with the static verifier armed")
    ap.add_argument("--target", action="append", default=None,
                    help="restrict to named target(s)")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="restrict to one backend (default: both)")
    ap.add_argument("--arch", action="append", default=None,
                    help="also lint the serving decode step of this "
                         "model-zoo arch (reduced config); repeatable")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here instead of stdout")
    args = ap.parse_args(argv)

    from ..pipeline.stages import resolve_device
    device = resolve_device(args.device)
    backends = (args.backend,) if args.backend else BACKENDS
    targets: List[Tuple[str, Callable]] = list(program_targets().items())
    for arch in (args.arch or ()):
        def make(arch=arch):
            low, _ = model_lowered(arch, device)
            return low
        targets.append((f"decode_step[{arch}]", make))
    if args.target:
        keep = set(args.target)
        targets = [t for t in targets if t[0] in keep]
    if not targets:
        print("lint: no targets found", file=sys.stderr)
        return 2

    results = []
    for name, make in targets:
        for backend in backends:
            pl = None
            if name.startswith("decode_step[") and backend == "cuda":
                # the decode step's cuda path uses the serving pipeline
                from ..serving.compile import decode_pipeline
                pl = decode_pipeline(True)
            r = _lint_one(name, make, backend, device, pipeline=pl)
            results.append(r)
            status = "ok" if r["ok"] else "FAIL"
            detail = r["error"] or "; ".join(
                d["code"] for d in r["diagnostics"]) or ""
            print(f"lint: {name}/{backend}: {status} {detail}".rstrip(),
                  file=sys.stderr)

    report = {
        "targets": len(targets), "backends": list(backends),
        "device": str(device),
        "failures": sum(not r["ok"] for r in results),
        "results": results,
    }
    print(f"lint: failures: {report['failures']} ({len(targets)} targets "
          f"x {len(backends)} backends on {device})", file=sys.stderr)
    text = json.dumps(report, indent=2, default=str)
    if args.out:
        Path(args.out).write_text(text + "\n")
    else:
        print(text)
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
