"""Quickstart on the port: the paper's §3 multi-level flow on AXPYDOT
(Figs. 9-13), through the staged pipeline, as ``examples/quickstart.py``
walks it:

    Wrapped --lower()--> Lowered --optimize(passes)--> Lowered
            --compile(backend)--> Compiled

Build through the Python/BLAS frontend -> offload to the device -> stream
the memory accesses -> compose the pipelines -> compile with both backends
(``torch``, the structural interpreter; ``cuda``, where the Axpy->Dot
stream fuses into the hand-written ``axpydot`` kernel, ``csrc/axpydot.cu``)
and compare; a second compile of the same program is served from the
compilation cache.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import kernels  # noqa: F401  (registers the Axpy+Dot fusion)
from ..frontends import blas
from ..frontends.api import dc_program
from ..pipeline import (COMPILATION_CACHE, DeviceOffloadPass, PassManager,
                        StreamingCompositionPass, StreamingMemoryPass,
                        VectorizationPass)
from ..pipeline.stages import resolve_device


@dc_program
def axpydot(p, n):
    a = p.scalar_input("a", "float32")
    x, y, w = (p.input(nm, (n,)) for nm in ("x", "y", "w"))
    p.output("result", blas.dot(blas.axpy(a, x, y), w))


def main(argv=None) -> dict:
    """Run the flow; returns the volumes, each backend's result and fused
    regions, and the cache's counts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = 1 << 20
    rng = np.random.default_rng(0)
    a = np.float32(0.7)
    x, y, w = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    expected = float(np.dot((a * x + y).astype(np.float32), w))
    out = {"expected": expected}

    print("== 1. trace: Wrapped -> Lowered (generic SDFG, paper Fig. 10)")
    lowered = axpydot.lower(n)
    print("  ", lowered)

    print("== 2. DeviceOffload pass (paper Fig. 11, FPGATransformSDFG)")
    lowered.optimize([DeviceOffloadPass()])
    naive_vol = lowered.sdfg.off_chip_volume()
    print(f"   off-chip volume: {naive_vol/2**20:.1f} MiB")

    print("== 3. Vectorization + StreamingComposition + StreamingMemory "
          "(paper Fig. 12)")
    mid = PassManager([VectorizationPass(width=128),
                       StreamingCompositionPass(),
                       StreamingMemoryPass()], name="streaming_ladder")
    lowered.optimize(mid)
    stream_vol = lowered.sdfg.off_chip_volume()
    main_state = [s for s in lowered.sdfg.states if s.label == "main"][0]
    for entry in lowered.reports[-1]["passes"]:
        print(f"   pass {entry['name']:22s} applied={entry['summary']} "
              f"({entry['seconds']*1e3:.1f} ms)")
    print(f"   off-chip volume: {stream_vol/2**20:.1f} MiB "
          f"({naive_vol/stream_vol:.2f}x less; z never leaves the chip)")
    pes = len(main_state.processing_elements())
    print(f"   processing elements in kernel state: {pes}")
    out.update(volumes=(naive_vol, stream_vol), pes=pes)

    print(f"== 4. compile with both backends (default pipelines) on {dev}")
    for backend in ("torch", "cuda"):
        staged = axpydot.lower(n).optimize(
            [DeviceOffloadPass(), StreamingCompositionPass()])
        c = staged.compile(backend, device=dev)
        got = float(c(a=a, x=x, y=y, w=w)["result"].reshape(-1)[0])
        assert abs(got - expected) < 1e-3 * abs(expected), (got, expected)
        fused = c.report["fused_regions"]
        print(f"   backend={backend:7s} result={got:+.4f} "
              f"(expected {expected:+.4f}) fused={fused}")
        out[backend] = {"result": got, "fused_regions": fused}

    print("== 5. recompile: served from the compilation cache")
    before = COMPILATION_CACHE.stats
    axpydot.lower(n).optimize(
        [DeviceOffloadPass(), StreamingCompositionPass()]).compile(
            "cuda", device=dev)
    after = COMPILATION_CACHE.stats
    assert after["hits"] == before["hits"] + 1, (before, after)
    print(f"   cache: {after}")
    out["cache"] = (before, after)
    print("OK")
    return out


if __name__ == "__main__":
    main()
