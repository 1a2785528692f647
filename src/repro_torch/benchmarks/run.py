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
``--device`` is ``cuda`` (the default) or ``cpu`` (the plain versions,
run on :data:`CPU_THREADS` intra-op threads).
The modules are the ones the port has: ``axpydot`` (Table 1), ``gemver``
(Table 2), ``lenet`` (Table 3), ``stencil`` (the paper's Fig. 19),
``jacobi_chain`` (the halo-fused stencil chain) and ``serve`` (serving
throughput), in the reference's order.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import sys
import traceback
from typing import Optional

import torch

#: intra-op threads of a ``--device cpu`` run, set once for the run. A
#: host-tuning choice: the plain versions are thousands of small operations
#: each, and on a host whose cores other processes share a thread pool's
#: fork and join at each one stalls for milliseconds (a reduced
#: starcoder2-3b decode step at batch 8 took 50-600 ms at 8 threads against
#: 17-27 ms at one on a shared 8-core host, PERF.md §6)
CPU_THREADS = 1


@contextlib.contextmanager
def host_threads(n: Optional[int]):
    """Run the body with ``n`` intra-op threads, then restore the count
    (``None``: leave it)."""
    if n is None:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_modules(modules, only, args) -> list:
    """Run the selected modules in order; the names of those that failed."""
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
    return failed


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

    from . import (axpydot, gemver, jacobi_chain, lenet, serve_bench,
                   stencil_bench)
    modules = {
        "axpydot": axpydot,            # paper Table 1
        "gemver": gemver,              # paper Table 2
        "lenet": lenet,                # paper Table 3
        "stencil": stencil_bench,      # paper Fig. 19
        "jacobi_chain": jacobi_chain,  # deep halo-fused stencil chain
        "serve": serve_bench,          # serving throughput
    }
    only = set(args.only.split(",")) if args.only else set(modules)
    unknown = only - set(modules)
    if unknown:
        ap.error(f"unknown modules {sorted(unknown)}; the port has "
                 f"{sorted(modules)}")

    if args.json_out:
        os.makedirs(args.json_out, exist_ok=True)

    on_cpu = args.device is not None and \
        torch.device(args.device).type == "cpu"
    with host_threads(CPU_THREADS if on_cpu else None):
        failed = run_modules(modules, only, args)
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
