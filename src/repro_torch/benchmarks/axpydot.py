"""Paper Table 1 on the port: AXPYDOT naive against the streaming
transformations. It reports what ``benchmarks/axpydot.py`` reports, under
the same names and in the same order, and keeps every assertion of it on
every device.

(a) Off-chip volume, from the memlets at the paper's size (209,715,200
elements, 800 MiB a vector); (b) the naive and the streamed program on
the structural interpreter (``torch``, the reference's ``jnp``) and the
fused program on the ``cuda`` backend (the Axpy->Dot pipeline fusion: the
``axpydot`` kernel, ``csrc/axpydot.cu``); (c) processing elements of the
streamed program; (d) the generated grid path, unfused (an axpy kernel and
a dot kernel, z through device memory) against MapFusion (one kernel, z in
registers), tiled against 1-element blocks, and the two-producer DAG.

On the card the interpreter rows run at the reference's 2,000,000
elements and the grid rows at the paper's N, where the kernels' work, not
their launch, decides the tiled-against-untiled race. ``small=True`` takes
the reference's small sizes and its numpy inputs (``default_rng(0)``,
drawn in its order). Times: ``clock.Clock``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only axpydot \
        [--small] [--device cpu]
"""
from __future__ import annotations

import numpy as np

from .. import kernels  # noqa: F401  (registers the Axpy+Dot fusion)
from .. import programs
from ..pipeline import (DeviceOffloadPass, StreamingCompositionPass,
                        StreamingMemoryPass, lower)
from ..pipeline.stages import resolve_device
from ..transforms import DeviceOffload, StreamingComposition, StreamingMemory
from .clock import Clock, tensors

PAPER_N = programs.AXPYDOT_N
#: the interpreter rows' size (the reference's ``BENCH_N``)
BENCH_N = 2_000_000


def _result(c, d) -> float:
    return float(c(**d)["result"].reshape(-1)[0])


def _close(got, want, what):
    assert abs(got - want) < 1e-3 * abs(want), \
        f"{what}: {got} against {want}"


def run(report, small: bool = False, device=None, clock=None) -> dict:
    """Report the rows; returns the volumes, the streamed program's
    processing elements and each grid variant's kernels."""
    dev = resolve_device(device)
    clock = clock or Clock(dev)
    bench_n = 65_536 if small else BENCH_N
    rng = np.random.default_rng(0)
    a = np.float32(0.7)
    x, y, w = (rng.standard_normal(bench_n).astype(np.float32)
               for _ in range(3))
    exp = np.dot((a * x + y).astype(np.float32), w)
    d = tensors(dict(a=a, x=x, y=y, w=w), dev)

    # volumes at the paper's N (from the memlets, exact)
    naive = programs.axpydot(PAPER_N)
    naive.apply(DeviceOffload)
    v_naive = naive.off_chip_volume()
    streamed = programs.axpydot(PAPER_N)
    streamed.apply(DeviceOffload)
    streamed.apply(StreamingComposition)
    streamed.apply(StreamingMemory)
    v_stream = streamed.off_chip_volume()
    pes = len([s for s in streamed.states if s.label == "main"][0]
              .processing_elements())

    c1 = lower(programs.axpydot(bench_n)).optimize(
        [DeviceOffloadPass()]).compile("torch", device=dev)
    t_naive = clock.ms(lambda: c1(**d))
    _close(_result(c1, d), exp, "naive")
    c2 = lower(programs.axpydot(bench_n)).optimize(
        [DeviceOffloadPass(), StreamingCompositionPass(),
         StreamingMemoryPass()]).compile("torch", device=dev)
    t_stream = clock.ms(lambda: c2(**d))
    c3 = lower(programs.axpydot(bench_n)).optimize(
        [DeviceOffloadPass(), StreamingCompositionPass()]).compile(
            "cuda", device=dev)
    t_fused = clock.ms(lambda: c3(**d))

    report("axpydot_naive_volume_GiB", v_naive / 2**30,
           f"paper table1; n={PAPER_N}")
    report("axpydot_stream_volume_GiB", v_stream / 2**30,
           f"volume ratio {v_naive/v_stream:.3f} (z round-trip removed)")
    report("axpydot_stream_PEs", pes, "paper: 5 modules (we count writer+dot)")
    report("axpydot_naive_ms", t_naive,
           f"n={bench_n}, structural interpreter on {clock.where}",
           backend="torch")
    report("axpydot_stream_ms", t_stream,
           f"speedup {t_naive/t_stream:.2f}x (paper: 2.6x on U250); "
           f"on {clock.where}", backend="torch")
    report("axpydot_fused_pallas_ms", t_fused,
           f"fused regions {c3.report['fused_regions']}; on {clock.where}",
           backend="cuda")

    # (d) the generated grid path: the unfused kernel pair against the
    # MapFusion'd single kernel
    gn = 65_536 if small else PAPER_N
    gx, gy, gw = (rng.standard_normal(gn).astype(np.float32)
                  for _ in range(3))
    g_exp = np.dot((a * gx + gy).astype(np.float32), gw)
    gd = tensors(dict(a=a, x=gx, y=gy, w=gw), dev)

    def grid(build, n, fused, tiled=True):
        return lower(build(n)).compile(
            "cuda", device=dev,
            pipeline=programs.axpydot_grid_pipeline(fused, tiled))

    cu = grid(programs.axpydot, gn, False)
    t_grid_unfused = clock.ms(lambda: cu(**gd))
    assert len(cu.report["grid_kernels"]) == 2
    cf = grid(programs.axpydot, gn, True)
    t_grid_fused = clock.ms(lambda: cf(**gd))
    assert len(cf.report["grid_kernels"]) == 1
    # 1-element blocks at a thirty-second of the size, against the tiled
    # kernel at that size
    un = max(1024, gn // 32)
    ud = {k: (v[:un] if v.dim() else v) for k, v in gd.items()}
    cnt = grid(programs.axpydot, un, True, tiled=False)
    t_grid_untiled = clock.ms(lambda: cnt(**ud))
    ct = grid(programs.axpydot, un, True)
    t_tiled_small = clock.ms(lambda: ct(**ud))
    for c in (cu, cf):
        _close(_result(c, gd), g_exp, "grid")
    ux, uy, uw = gx[:un], gy[:un], gw[:un]
    u_exp = np.dot((a * ux + uy).astype(np.float32), uw)
    for c in (cnt, ct):
        _close(_result(c, ud), u_exp, "grid at 1-element blocks")

    report("axpydot_grid_unfused_ms", t_grid_unfused,
           f"n={gn}; kernels={cu.report['grid_kernels']}; on {clock.where}",
           backend="cuda")
    report("axpydot_grid_fused_ms", t_grid_fused,
           f"n={gn}; 1 kernel, z in-kernel; speedup "
           f"{t_grid_unfused/t_grid_fused:.2f}x vs unfused grid; on "
           f"{clock.where}", backend="cuda")
    report("axpydot_grid_untiled_ms", t_grid_untiled,
           f"n={un}; fused but 1-element blocks; tiled speedup "
           f"{t_grid_untiled/t_tiled_small:.2f}x at same n; on "
           f"{clock.where}", backend="cuda")
    clock.check_race(t_tiled_small, t_grid_untiled,
                     "tiled grid variant must beat the 1-element-block grid "
                     "variant")

    # two-producer DAG: the dot over two generated operands as one kernel
    gb = np.float32(-0.3)
    gu, gv = (rng.standard_normal(gn).astype(np.float32) for _ in range(2))
    d_exp = np.dot((a * gx + gy).astype(np.float32),
                   (gb * gu + gv).astype(np.float32))
    dd = tensors(dict(a=a, b=gb, x=gx, y=gy, u=gu, v=gv), dev)
    c2u = grid(programs.axpydot_two_producer, gn, False)
    t_dag_unfused = clock.ms(lambda: c2u(**dd))
    assert len(c2u.report["grid_kernels"]) == 3
    c2f = grid(programs.axpydot_two_producer, gn, True)
    t_dag_fused = clock.ms(lambda: c2f(**dd))
    assert len(c2f.report["grid_kernels"]) == 1, \
        f"two-producer DAG must fuse to ONE kernel, got " \
        f"{c2f.report['grid_kernels']}"
    for c in (c2u, c2f):
        _close(_result(c, dd), d_exp, "two-producer DAG")
    report("axpydot_dag_unfused_ms", t_dag_unfused,
           f"n={gn}; kernels={c2u.report['grid_kernels']}; on "
           f"{clock.where}", backend="cuda",
           grid_kernels=len(c2u.report["grid_kernels"]))
    report("axpydot_dag_fused_ms", t_dag_fused,
           f"n={gn}; two-producer dot as ONE kernel, both axpys in-kernel; "
           f"speedup {t_dag_unfused/t_dag_fused:.2f}x vs unfused; on "
           f"{clock.where}", backend="cuda",
           grid_kernels=len(c2f.report["grid_kernels"]))
    return {"volumes": {"naive": v_naive, "stream": v_stream}, "pes": pes,
            "fused_regions": c3.report["fused_regions"],
            "grid_kernels": {name: c.report["grid_kernels"] for name, c in (
                ("unfused", cu), ("fused", cf), ("untiled", cnt),
                ("tiled_small", ct), ("dag_unfused", c2u),
                ("dag_fused", c2f))}}


if __name__ == "__main__":
    import sys

    from .run import main
    raise SystemExit(main(["--only", "axpydot"] + sys.argv[1:]))
