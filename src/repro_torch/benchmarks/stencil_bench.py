"""Paper Fig. 19 on the port: the StencilFlow stencils (diffusion2d,
jacobi3d, diffusion3d), the 5-point star through the generated grid path,
and the two-iteration diffusion chain of Fig. 17 with its fused
multi-stage kernel. It reports what ``benchmarks/stencil_bench.py`` reports,
under the same names and in the same order.

At full size it runs the paper's domains, which the reference cuts for the
CPU: diffusion2d over 131,072 x 4,096 and jacobi3d/diffusion3d (alpha 0.1)
over 32,768 x 128 x 128, each one launch of its hand-written kernel
(``csrc/stencil_star.cu``); the star over ``programs.STAR_N``^2 = 16,386^2,
tiled (``star_tiled``) and with 1-element blocks (``star``: 16,384^2 =
268,435,456 programs, under the 2^31 - 1 a 1-D launch grid takes), against
the structural interpreter; and the chain over ``programs.STENCIL_DOMAIN``.
Fields are drawn on the device from a seeded generator. ``small=True``
takes the reference's small sizes and its numpy inputs (``default_rng(0)``,
drawn in the reference's order), so both benchmarks see the same data.

On the card each time is the median of CUDA-event timings after a warm-up,
with GOp/s and the share of the byte bound (the field read once and
written once at 3.35 TB/s, the H100 SXM data sheet's rate) in ``derived``,
and the tiled star must beat the untiled one, as the reference asserts. On
the CPU (``device="cpu"``, the plain versions) the times are one host-clock
call each and that assertion is not made: CPU times say nothing of the
card's.

``run`` returns every input and output, so a caller can hold them to an
oracle. ``calibrate`` sweeps the star's sublane tile and only reports:
``CALIBRATED_TILES`` stays empty until the card's measurements fill it.

    PYTHONPATH=src python -m repro_torch.benchmarks.stencil_bench [--small]
        [--device cpu] [--calibrate]
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from .. import programs
from ..frontends.stencil import build_stencil_program
from ..kernels import stencil
from ..pipeline import GridConversionPass, MapTilingPass, PassManager, lower
from ..pipeline.stages import resolve_device
from ..transforms import DeviceOffload, StreamingComposition

#: the paper's domains (2^17 x 4,096 and 2^15 x 128 x 128)
DOM2D = (131_072, 4_096)
DOM3D = (32_768, 128, 128)
#: the reference's small sizes: 2-D, 3-D, star, chain
SMALL = {"dom2d": (512, 128), "dom3d": (32, 16, 16), "star": (34, 34),
         "chain": (128, 64)}
COEFFS = (0.2, 0.1, 0.15, 0.25, 0.3)
ALPHA = 0.1
#: flops a point, as the reference counts them
FLOPS = {"diffusion2d": 9, "jacobi3d": 8, "diffusion3d": 13}
#: H100 SXM device memory rate (data sheet)
HBM_BYTES_PER_S = 3.35e12
#: CUDA-event timings a median is taken over
REPS = 5


class _Clock:
    """Times a call: CUDA events on the card (median of :data:`REPS` after a
    warm-up), one host-clock call after a warm-up on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.where = torch.cuda.get_device_name(device) if self.on_card \
            else "CPU (plain versions)"

    def ms(self, fn):
        fn()
        if not self.on_card:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def rate(self, points, flops, ms, field_bytes=None) -> str:
        """GOp/s and, on the card, the share of the byte bound."""
        out = f"{points * flops / ms / 1e6:.2f} GOp/s on {self.where}"
        if self.on_card:
            nbytes = field_bytes if field_bytes is not None else 8 * points
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            out += f"; {bound / ms:.1%} of the {bound:.4f} ms byte bound"
        return out


def _fields(small: bool, device: torch.device):
    """A field maker: the reference's numpy stream at small sizes, a seeded
    generator on the device at full size."""
    if small:
        rng = np.random.default_rng(0)
        return lambda shape: torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)
    g = torch.Generator(device=device).manual_seed(0)
    return lambda shape: torch.randn(shape, generator=g, device=device)


def chain_spec(dims) -> dict:
    """The Fig.-17 two-iteration diffusion program (the reference benchmark's
    ``diff2x``) over ``dims``."""
    spec = programs.diffusion_spec(dims)
    spec["name"] = "diff2x"
    return spec


def run(report, small: bool = False, device=None) -> dict:
    """Run the Fig.-19 suite and report each measurement; returns the
    inputs and outputs of every stage."""
    dev = resolve_device(device)
    clock = _Clock(dev)
    dom2d = SMALL["dom2d"] if small else DOM2D
    dom3d = SMALL["dom3d"] if small else DOM3D
    star_dom = SMALL["star"] if small else (programs.STAR_N,) * 2
    chain_dom = SMALL["chain"] if small else programs.STENCIL_DOMAIN
    field = _fields(small, dev)
    out = {}

    a2 = field(dom2d)
    o2 = stencil.diffusion2d(a2, COEFFS)
    t = clock.ms(lambda: stencil.diffusion2d(a2, COEFFS))
    report("stencil_diffusion2d_ms", t,
           f"{clock.rate(a2.numel(), FLOPS['diffusion2d'], t)}; "
           f"dom={dom2d}", backend="cuda")
    out["diffusion2d"] = {"a": a2, "coeffs": COEFFS, "out": o2}

    a3 = field(dom3d)
    oj = stencil.jacobi3d(a3)
    t = clock.ms(lambda: stencil.jacobi3d(a3))
    report("stencil_jacobi3d_ms", t,
           f"{clock.rate(a3.numel(), FLOPS['jacobi3d'], t)}; dom={dom3d}",
           backend="cuda")
    od = stencil.diffusion3d(a3, ALPHA)
    t = clock.ms(lambda: stencil.diffusion3d(a3, ALPHA))
    report("stencil_diffusion3d_ms", t,
           f"{clock.rate(a3.numel(), FLOPS['diffusion3d'], t)}; "
           f"alpha={ALPHA}", backend="cuda")
    out["jacobi3d"] = {"a": a3, "out": oj}
    out["diffusion3d"] = {"a": a3, "alpha": ALPHA, "out": od}

    # the generated grid path: the star map as one partial-coverage grid
    # kernel (2-D tiles, windowed halo reads) against the 1-element-block
    # grid kernel and the structural interpreter
    sn, sm = star_dom
    sa = field(star_dom)
    cg = lower(programs.star5(sn, sm)).compile("cuda", device=dev)
    assert cg.report["grid_kernels"] == ["star_tiled"], cg.report
    blocks = cg.report["grid_converted"][0]["block_shape"]
    cu = lower(programs.star5(sn, sm)).compile(
        "cuda", device=dev, pipeline=PassManager([GridConversionPass()],
                                                 name="star_untiled"))
    assert cu.report["grid_kernels"] == ["star"], cu.report
    cj = lower(programs.star5(sn, sm)).compile("torch", device=dev)
    og, ou, ot = (c(a=sa)["b"] for c in (cg, cu, cj))
    tg, tu, tj = (clock.ms(lambda c=c: c(a=sa)) for c in (cg, cu, cj))
    torch.testing.assert_close(og, ot, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ou, ot, rtol=1e-5, atol=1e-6)
    pts, nbytes = (sn - 2) * (sm - 2), 4 * (sn * sm + (sn - 2) * (sm - 2))
    report("stencil_star_grid_ms", tg,
           f"dom={star_dom}; generated grid kernel, blocks={blocks}; "
           f"tiled speedup {tu / tg:.2f}x vs 1-element blocks; "
           f"{clock.rate(pts, 6, tg, nbytes)}",
           backend="cuda", block_shape=blocks)
    report("stencil_star_grid_untiled_ms", tu,
           f"dom={star_dom}; 1-element-block grid kernel; "
           f"{clock.rate(pts, 6, tu, nbytes)}", backend="cuda")
    report("stencil_star_jnp_ms", tj,
           f"dom={star_dom}; structural interpreter (torch backend)",
           backend="torch")
    if clock.on_card:
        assert tg < tu, \
            "tiled grid variant must beat the 1-element-block grid variant"
    out["star"] = {"a": sa, "tiled": og, "untiled": ou, "torch": ot,
                   "block_shape": blocks,
                   "kernels": (cg.report["grid_kernels"],
                               cu.report["grid_kernels"])}

    # the Fig.-17 two-iteration diffusion program through the full stack
    sdfg = build_stencil_program(chain_spec(chain_dom))
    sdfg.apply(DeviceOffload)
    v0 = sdfg.off_chip_volume()
    sdfg.apply(StreamingComposition)
    v1 = sdfg.off_chip_volume()
    c = lower(sdfg).compile("cuda", device=dev)
    a = field(tuple(chain_dom))
    co = torch.tensor(COEFFS, device=dev)
    oc = c(a=a, b_coeffs=co, d_coeffs=co)["d"]
    t = clock.ms(lambda: c(a=a, b_coeffs=co, d_coeffs=co))
    report("stencilflow_chain_ms", t,
           f"fused={c.report['fused_regions']}; volume {v0}->{v1} B "
           f"({v0 / v1:.2f}x; intermediate b never leaves shared memory); "
           f"{clock.rate(a.numel(), 18, t)}", backend="cuda")
    out["chain"] = {"a": a, "coeffs": COEFFS, "out": oc,
                    "fused": c.report["fused_regions"], "volumes": (v0, v1)}
    return out


def calibrate(report, small: bool = False, device=None):
    """Sweep the sublane (second-minor) tile of the star grid kernel and
    report per-tile times and the fastest; the lane tile is the star's
    interior width up to 128 (the reference's 130-wide star)."""
    dev = resolve_device(device)
    clock = _Clock(dev)
    sn, sm = SMALL["star"] if small else (programs.STAR_N,) * 2
    g = torch.Generator(device=dev).manual_seed(2)
    sa = torch.randn((sn, sm), generator=g, device=dev)
    lanes = min(sm - 2, 128)
    best, times = None, {}
    for t in (2, 4, 8, 16, 32):
        if t >= sn - 2:
            continue
        pm = PassManager([MapTilingPass(tile_sizes={"j": lanes, "i": t}),
                          GridConversionPass()], name=f"star_tile{t}")
        c = lower(programs.star5(sn, sm)).compile("cuda", device=dev,
                                                  pipeline=pm)
        times[t] = clock.ms(lambda: c(a=sa))
        blk = c.report["grid_converted"][0]["block_shape"] \
            if c.report["grid_converted"] else None
        report(f"stencil_calibrate_tile{t}_ms", times[t],
               f"dom=({sn},{sm}); star grid, sublane tile {t}, blocks {blk}; "
               f"on {clock.where}", backend="cuda")
        if best is None or times[t] < times[best]:
            best = t
    report("stencil_calibrate_best_tile", best,
           f"dom=({sn},{sm}); measured crossover of sublane sweep "
           f"{sorted(times)} on {clock.where}", backend="cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="the reference's reduced sizes")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--calibrate", action="store_true",
                    help="also sweep the star's sublane tile")
    args = ap.parse_args(argv)

    def report(name, value, derived="", backend="cuda", **extra):
        print(f"{name},{value:.6g},{derived}", flush=True)

    print("name,value,derived")
    run(report, small=args.small, device=args.device)
    if args.calibrate:
        calibrate(report, small=args.small, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
