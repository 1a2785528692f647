"""A deep stencil pipeline on the port: a 4-stage 1-D jacobi chain through
halo-aware MapFusion, compiled to ONE generated grid kernel. It reports
what ``benchmarks/jacobi_chain.py`` reports, under the same names and in
the same order, and keeps every assertion of it on every device.

Each stage reads its predecessor at ``i-1, i, i+1``; MapFusion replicates
producers per offset (1 + 3 + 5 + 7 = 16 tasklets) so the three
intermediates never leave registers (``programs.jacobi_chain``). The
per-stage baseline is the same pipeline minus MapFusionPass
(``programs.perstage_pipeline``): four kernels with the intermediates in
device memory; the structural interpreter cross-checks both, and the
fused chain must beat the per-stage one.

On the card the chain runs over ``programs.JACOBI_N`` = 2^26 + 512
points; ``small=True`` takes the reference's small size and its numpy
input (``default_rng(7)``). Outputs are held to float64 at the reference's
tolerances. Times: ``clock.Clock``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only jacobi_chain \
        [--small] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from .. import programs
from ..pipeline import lower
from ..pipeline.stages import resolve_device
from .clock import Clock, tensors

#: the reference's small size: the interior after 4 stages is 576 points
N_SMALL = 1088
STAGES = programs.JACOBI_STAGES
MARGIN = programs.JACOBI_MARGIN


def reference(a: torch.Tensor, stages: int = STAGES) -> torch.Tensor:
    """The chain in float64; stage k writes [64 (k+1), n - 64 (k+1))."""
    n = a.shape[0]
    cur = a.double()
    for k in range(stages):
        lo, hi = MARGIN * (k + 1), n - MARGIN * (k + 1)
        nxt = torch.zeros_like(cur)
        nxt[lo:hi] = (0.25 * cur[lo - 1:hi - 1] + 0.5 * cur[lo:hi]
                      + 0.25 * cur[lo + 1:hi + 1])
        cur = nxt
    return cur


def run(report, small: bool = False, device=None, clock=None) -> dict:
    """Report the rows; returns the grid kernels of both pipelines."""
    dev = resolve_device(device)
    clock = clock or Clock(dev)
    n = N_SMALL if small else programs.JACOBI_N
    rng = np.random.default_rng(7)
    a = tensors({"a": rng.standard_normal((n,)).astype(np.float32)},
                dev)["a"]

    cf = lower(programs.jacobi_chain(n)).compile("cuda", device=dev)
    assert len(cf.report["grid_kernels"]) == 1, \
        f"fused chain must be ONE grid kernel, got {cf.report['grid_kernels']}"
    blocks = cf.report["grid_converted"][0]["block_shape"]
    tasklets = cf.report["grid_converted"][0].get("tasklets")
    cp = lower(programs.jacobi_chain(n)).compile(
        "cuda", device=dev, pipeline=programs.perstage_pipeline(
            "jacobi_perstage"))
    assert len(cp.report["grid_kernels"]) == STAGES, \
        f"per-stage baseline must be {STAGES} kernels, " \
        f"got {cp.report['grid_kernels']}"
    cj = lower(programs.jacobi_chain(n)).compile("torch", device=dev)

    tf = clock.ms(lambda: cf(a=a))
    tp = clock.ms(lambda: cp(a=a))
    tj = clock.ms(lambda: cj(a=a))
    ref = reference(a)
    for c in (cf, cp, cj):
        torch.testing.assert_close(c(a=a)["b"].double(), ref, rtol=1e-4,
                                   atol=1e-5)

    report("jacobi_chain_fused_ms", tf,
           f"n={n}; {STAGES} stages as ONE grid kernel "
           f"({tasklets} tasklets after halo replication, blocks={blocks}); "
           f"{tp/tf:.2f}x vs per-stage; on {clock.where}",
           backend="cuda", grid_kernels=1, block_shape=blocks)
    report("jacobi_chain_perstage_ms", tp,
           f"n={n}; one grid kernel per stage, intermediates materialized; "
           f"on {clock.where}", backend="cuda", grid_kernels=STAGES)
    report("jacobi_chain_jnp_ms", tj,
           f"n={n}; structural vmap lowering on {clock.where}",
           backend="torch")
    clock.check_race(tf, tp, "fused chain must beat the per-stage baseline")
    return {"fused": cf.report["grid_kernels"],
            "perstage": cp.report["grid_kernels"], "tasklets": tasklets}


if __name__ == "__main__":
    import sys

    from .run import main
    raise SystemExit(main(["--only", "jacobi_chain"] + sys.argv[1:]))
