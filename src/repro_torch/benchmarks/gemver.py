"""Paper Table 2 on the port: the GEMVER composition ladder.

    B = A + u1 v1^T + u2 v2^T ; x = beta*B^T y + z ; w = alpha*B x

It reports what ``benchmarks/gemver.py`` reports, under the same names and
in the same order, and keeps every assertion of it on every device.
Variants: naive, streaming composition, manual composition (the paper's
§4.2 replication of the rank-1 update's result) and both replicas
streamed. Volumes from the memlets at the paper's N = 16,384; the
variants timed on the structural interpreter (``torch``, the reference's
``jnp``). The generated grid path compares the unfused kernel ladder (two
ger and two gemv kernels, B1 through device memory) with MapFusion (the
two rank-1 updates as one kernel, B1 in registers) and with 1-element
blocks; then the ger->ger->gemv chain as one kernel (the ``accumulate``
gemv) against the pairwise-fused baseline.

On the card the interpreter rows run at the reference's N = 1,024 and
the grid rows at the paper's N, where the kernels' work, not their launch,
decides the tiled-against-untiled race. ``small=True`` takes the
reference's small sizes and its numpy inputs (``default_rng(0)``, drawn in
its order). Outputs are held to float64 at the reference's tolerances.
Times: ``clock.Clock``. ``calibrate`` sweeps the minor tile of the fused
ladder and only reports: ``GridConversionPass.CALIBRATED_TILES`` stays
empty until the card's measurements fill it.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only gemver \
        [--small] [--device cpu] [--calibrate]
"""
from __future__ import annotations

import numpy as np
import torch

from .. import programs
from ..pipeline import (ExpandLibraryNodesPass, GridConversionPass,
                        MapFusionPass, MapTilingPass, PassManager,
                        SetExpansionPreferencePass, lower)
from ..pipeline.stages import resolve_device
from .clock import Clock, tensors

PAPER_N = programs.GEMVER_N
#: the interpreter rows' size (the reference's ``BENCH_N``)
BENCH_N = 1024
#: the chain's size in the small run (the reference's ``cn``)
CHAIN_N_SMALL = 384
GEMVER_INPUTS = ("A", "u1", "v1", "u2", "v2", "y", "z")
CHAIN_INPUTS = ("A", "u1", "v1", "u2", "v2", "xw")


def _draw(rng, n, names):
    return {k: rng.standard_normal((n, n) if k == "A" else n)
            .astype(np.float32) for k in names}


def _B(d):
    """B = A + u1 v1^T + u2 v2^T in float64, where ``d`` lies."""
    f = {k: v.double() for k, v in d.items()}
    return f["A"] + torch.outer(f["u1"], f["v1"]) + \
        torch.outer(f["u2"], f["v2"])


def reference(d):
    """(x, w) in float64."""
    B = _B(d)
    x = 0.9 * B.T @ d["y"].double() + d["z"].double()
    return x, 1.1 * B @ x


def _close(got, want):
    torch.testing.assert_close(got.double(), want, rtol=5e-2, atol=5e-1)


def _grid_pipeline(fused: bool, tiled: bool = True,
                   tile_size: int = None) -> PassManager:
    passes = [SetExpansionPreferencePass(("generic",)),
              ExpandLibraryNodesPass()]
    if fused:
        passes.append(MapFusionPass())
    if tiled:
        defaults = GridConversionPass.default_tiles("cuda")
        passes.append(MapTilingPass(tile_size=tile_size)
                      if tile_size else
                      MapTilingPass(tile_size=defaults.get("minor"),
                                    second_size=defaults.get("second")))
    passes.append(GridConversionPass())
    return PassManager(passes, name=f"grid_f{int(fused)}_t{int(tiled)}"
                                    f"_{tile_size or 'auto'}")


def _kernel_volume(sdfg):
    """Kernel-state volume only (the paper's Table-2 column excludes the
    host<->device staging copies)."""
    main = [st for st in sdfg.states if st.label == "main"][0]
    return main.off_chip_volume()


def run(report, small: bool = False, device=None, clock=None) -> dict:
    """Report the rows; returns the volumes and the grid kernels of each
    compiled variant."""
    dev = resolve_device(device)
    clock = clock or Clock(dev)
    rng = np.random.default_rng(0)
    n = 256 if small else BENCH_N
    d = tensors(_draw(rng, n, GEMVER_INPUTS), dev)
    x_ref, w_ref = reference(d)

    vols = {name: _kernel_volume(s) for name, s in
            programs.gemver_variants(PAPER_N).items()}
    times = {}
    for name, s in programs.gemver_variants(n).items():
        c = lower(s).compile("torch", device=dev)
        times[name] = clock.ms(lambda: c(**d))
        out = c(**d)
        _close(out["x_out"], x_ref)
        _close(out["w_out"], w_ref)

    paper = {"naive": "6.0", "streaming": "4.0", "manual": "3.0",
             "both_streamed": "(beyond-paper)"}
    for name in ("naive", "streaming", "manual", "both_streamed"):
        report(f"gemver_{name}_volume_GiB", vols[name] / 2**30,
               f"paper table2 {paper[name]} GiB; "
               f"ratio {vols['naive']/vols[name]:.2f}x")
        report(f"gemver_{name}_ms", times[name],
               f"n={n}, structural interpreter on {clock.where}",
               backend="torch")

    # the generated grid path: the unfused kernel ladder against the
    # MapFusion'd rank-1 pair, and 1-element blocks
    gn = 64 if small else PAPER_N
    gd = tensors(_draw(rng, gn, GEMVER_INPUTS), dev)
    gx_ref, gw_ref = reference(gd)
    grid_times, kernels, blocks = {}, {}, {}
    for name, fused, tiled in (("unfused", False, True),
                               ("fused", True, True),
                               ("untiled", True, False)):
        c = lower(programs.gemver(gn)).compile(
            "cuda", device=dev, pipeline=_grid_pipeline(fused, tiled))
        grid_times[name] = clock.ms(lambda: c(**gd))
        kernels[name] = c.report["grid_kernels"]
        blocks[name] = [e["block_shape"] for e in c.report["grid_converted"]]
        out = c(**gd)
        _close(out["x_out"], gx_ref)
        _close(out["w_out"], gw_ref)
        del out, c
    assert len(kernels["unfused"]) == 4 and len(kernels["fused"]) == 3

    report("gemver_grid_unfused_ms", grid_times["unfused"],
           f"n={gn}; kernels={kernels['unfused']}; on {clock.where}",
           backend="cuda")
    report("gemver_grid_fused_ms", grid_times["fused"],
           f"n={gn}; ger pair fused, B1 in-kernel, blocks="
           f"{blocks['fused'][0]}; speedup "
           f"{grid_times['unfused']/grid_times['fused']:.2f}x vs unfused; "
           f"on {clock.where}", backend="cuda",
           block_shape=blocks["fused"][0])
    report("gemver_grid_untiled_ms", grid_times["untiled"],
           f"n={gn}; fused but 1-element blocks {blocks['untiled'][0]}; "
           f"tiled speedup "
           f"{grid_times['untiled']/grid_times['fused']:.2f}x; on "
           f"{clock.where}", backend="cuda")
    clock.check_race(grid_times["fused"], grid_times["untiled"],
                     "tiled grid variant must beat the 1-element-block grid "
                     "variant")

    # the fused-DAG chain: ger->ger->gemv as ONE kernel (accumulate gemv)
    # against the pairwise-fused baseline (ger pair fused, the row gemv its
    # own kernel, B2 through device memory between them)
    cn = CHAIN_N_SMALL if small else PAPER_N
    cd = tensors(_draw(rng, cn, CHAIN_INPUTS), dev)
    w_chain = 1.1 * _B(cd) @ cd["xw"].double()
    chain_times, chain_kernels = {}, {}
    for name, pref in (("dag", ("accumulate", "generic")),
                       ("pairwise", ("generic",))):
        c = lower(programs.gemver_chain(cn)).compile(
            "cuda", device=dev,
            pipeline=programs.gemver_chain_pipeline(pref))
        chain_times[name] = clock.ms(lambda: c(**cd))
        chain_kernels[name] = c.report["grid_kernels"]
        _close(c(**cd)["w_out"], w_chain)
        del c
    assert len(chain_kernels["dag"]) == 1, \
        f"chain must fuse to ONE grid kernel, got {chain_kernels['dag']}"
    assert len(chain_kernels["pairwise"]) >= 2
    report("gemver_chain_dag_ms", chain_times["dag"],
           f"n={cn}; ger->ger->gemv as ONE kernel "
           f"{chain_kernels['dag']}; speedup "
           f"{chain_times['pairwise']/chain_times['dag']:.2f}x vs pairwise; "
           f"on {clock.where}", backend="cuda",
           grid_kernels=len(chain_kernels["dag"]))
    report("gemver_chain_pairwise_ms", chain_times["pairwise"],
           f"n={cn}; pairwise-fused baseline, kernels="
           f"{chain_kernels['pairwise']}; on {clock.where}", backend="cuda",
           grid_kernels=len(chain_kernels["pairwise"]))
    return {"volumes": vols, "grid_kernels": kernels,
            "chain_kernels": chain_kernels}


def calibrate(report, small: bool = False, device=None):
    """Sweep the minor (lane) tile of the fused grid ladder and report the
    measured winner: the numbers ``CALIBRATED_TILES`` should take, once
    they come from the card. Reports only; nothing is set."""
    dev = resolve_device(device)
    clock = Clock(dev)
    rng = np.random.default_rng(1)
    gn = 64 if small else PAPER_N
    gd = tensors(_draw(rng, gn, GEMVER_INPUTS), dev)
    best, times = None, {}
    for t in (8, 16, 32, 64, 128):
        if t > gn:
            continue
        c = lower(programs.gemver(gn)).compile(
            "cuda", device=dev, pipeline=_grid_pipeline(True, True,
                                                        tile_size=t))
        times[t] = clock.ms(lambda: c(**gd))
        blk = c.report["grid_converted"][0]["block_shape"]
        report(f"gemver_calibrate_tile{t}_ms", times[t],
               f"n={gn}; fused grid, minor tile {t}, blocks {blk}; on "
               f"{clock.where}", backend="cuda")
        if best is None or times[t] < times[best]:
            best = t
    report("gemver_calibrate_best_tile", best,
           f"n={gn}; measured crossover of the minor-tile sweep "
           f"{sorted(times)} on {clock.where}", backend="cuda")


if __name__ == "__main__":
    import sys

    from .run import main
    raise SystemExit(main(["--only", "gemver"] + sys.argv[1:]))
