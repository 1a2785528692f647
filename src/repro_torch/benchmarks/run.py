"""Benchmark harness of the port: one module per paper table or figure,
the counterpart of ``benchmarks/run.py``.

Usage: PYTHONPATH=src python -m repro_torch.benchmarks.run
           [--only stencil,serve] [--small] [--json OUT] [--calibrate]
           [--device cpu]

Prints ``name,value,derived`` CSV lines, each followed by a ``# name
{extras}`` line where the row has extras (latencies, counts); exits
non-zero on any failure.
``--small`` takes each module's small sizes; ``--json OUT`` also writes one
``BENCH_<name>.json`` a module into the directory OUT (entries: name,
value, derived, backend, small, and the module's extras), never a partial
record of a failed module; ``--calibrate`` also runs each module's tile
sweep (``calibrate(report, small, device)``) where it has one;
``--device`` is ``cuda`` (the default) or ``cpu`` (the plain versions).
The modules are the ones the port has: ``stencil`` (the paper's Fig. 19)
and ``serve`` (serving throughput).
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--small", action="store_true",
                    help="reduced problem sizes")
    ap.add_argument("--json", dest="json_out", default=None, metavar="OUT",
                    help="directory to write BENCH_<name>.json records")
    ap.add_argument("--calibrate", action="store_true",
                    help="sweep tile sizes per module and record the "
                         "measured crossover")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    from . import serve_bench, stencil_bench
    modules = {
        "stencil": stencil_bench,      # paper Fig. 19
        "serve": serve_bench,          # serving throughput
    }
    only = set(args.only.split(",")) if args.only else set(modules)
    unknown = only - set(modules)
    if unknown:
        ap.error(f"unknown modules {sorted(unknown)}; the port has "
                 f"{sorted(modules)}")

    if args.json_out:
        os.makedirs(args.json_out, exist_ok=True)

    failed = []
    print("name,value,derived")
    for name, mod in modules.items():
        if name not in only:
            continue
        entries = []

        def report(bname, value, derived="", backend="cuda", **extra):
            print(f"{bname},{value:.6g},{derived}", flush=True)
            if extra:
                print(f"# {bname} {json.dumps(extra)}", flush=True)
            entries.append({"name": bname, "value": float(value),
                            "derived": derived, "backend": backend,
                            "small": bool(args.small), **extra})

        kw = {"small": args.small, "device": args.device}
        try:
            params = inspect.signature(mod.run).parameters
            mod.run(report, **{k: v for k, v in kw.items() if k in params})
            if args.calibrate and hasattr(mod, "calibrate"):
                mod.calibrate(report, small=args.small, device=args.device)
        except Exception as e:  # noqa: BLE001
            failed.append(name)
            traceback.print_exc()
            print(f"{name},ERROR,{type(e).__name__}: {e}")
        if args.json_out and name not in failed:
            # never write partial records for a failed module: a truncated
            # file would read as a complete (fast!) run to perf tracking
            path = os.path.join(args.json_out, f"BENCH_{name}.json")
            with open(path, "w") as f:
                json.dump(entries, f, indent=1)
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
