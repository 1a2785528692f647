#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU, ``nvcc``
and Triton:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc``
(generated Triton kernels compile at their first launch), holds each
kernel against its plain PyTorch version on the card, and drives the
compile spine — ``@dc_program`` -> ``lower`` -> passes -> ``compile`` —
through the port's entry points at the paper's sizes: AXPYDOT at
N = 209,715,200 and GEMVER at N = 16,384. Every phase prints a JSON line
with its seconds; any failed check raises and the script exits nonzero.
The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on the main path, its time, its plain version's time, the
least time the card could take for the same work and the time of one
PyTorch call that computes the same function; the last line is
``{"ok": true, "device": {...}}``.

Tolerance. A float32 sum whose longest chain of sequential additions is
L steps is off its exact value by about eps32 * sqrt(L) times the size of
its partial sums, and a partial sum is at most the sum's own size plus a
random walk of size ||t||_2 (the 2-norm of its terms t). So every result
is held, elementwise, to

    |got - want| <= 4 * eps32 * sqrt(L) * (||t||_2 + |want|),
    L = max(1024, n // 16384)

for an output summed from n terms. Each kernel here, and PyTorch's own
reductions, spreads a long sum over at least 16,384 lanes (the dot kernel
over 528 x 256 threads, a generated reduction over 528 programs of 128
lanes), and no window is streamed in more than 1,024 chunks (a gemv row of
16,384 takes 512 chunks of 32). At N = 209,715,200 the limit is about
1.6: leaving out one of the dot kernel's 528 chunks (~400k terms, a shift
of some hundreds) fails it, and the script plants that fault and checks that it is
rejected, as it does for a gemv that skips one chunk of its rows. A
single wrong element among 2e8 (a shift of ~1) can pass.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

#: NVIDIA H100 SXM data sheet: device memory rate and fp32 (non-tensor
#: core) peak, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

#: see the module docstring
EPS32 = 2.0 ** -23
TOL_FACTOR = 4.0
LANES = 16384
MIN_CHAIN = 1024

#: the TPU kernels the port's kernels replace (file:line of the function)
REPLACES = {
    "dot": "src/repro/kernels/dot/kernel.py:36",
    "axpydot": "src/repro/kernels/axpydot/kernel.py:46",
    "grid_kernel": "src/repro/codegen/pallas_backend.py:682",
    "two_phase": "src/repro/codegen/pallas_backend.py:894",
}
SOURCES = {
    "dot": "src/repro_torch/csrc/dot.cu",
    "axpydot": "src/repro_torch/csrc/axpydot.cu",
    "grid_kernel": "src/repro_torch/codegen/cuda_backend.py",
    "two_phase": "src/repro_torch/codegen/cuda_backend.py",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)




def chain_bound(n_terms: int) -> int:
    """L of the module docstring, for an output summed from n terms."""
    return max(MIN_CHAIN, n_terms // LANES)


class Smoke:
    def __init__(self):
        import torch
        import repro_torch.kernels  # noqa: F401  (registers the fusions)
        from repro_torch import programs
        self.torch = torch
        self.dev = torch.device("cuda")
        self.axpydot_n = programs.AXPYDOT_N
        self.gemver_n = programs.GEMVER_N
        self.seed = 2026
        self.captured = {}      # generated kernel name -> its last launch
        self.results = {}       # per-kernel measurements
        self.faults = []        # planted faults and how far they missed

    # -- helpers ---------------------------------------------------------
    def randn(self, *shape, dtype=None, seed=0):
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(self.seed + seed)
        x = torch.randn(*shape, generator=g, device=self.dev)
        return x if dtype is None else x.to(dtype)

    def time_ms(self, fn, reps=10, warmup=2):
        """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def within(self, got, want, norm2, n_terms):
        """(ok, max |got - want|, worst ratio of the error to its limit)
        under the tolerance of the module docstring; ``norm2`` holds the
        2-norm of each output's terms."""
        torch = self.torch
        got, want = got.double().reshape(-1), want.double().reshape(-1)
        norm2 = torch.as_tensor(norm2, dtype=torch.float64,
                                device=got.device).reshape(-1)
        limit = TOL_FACTOR * EPS32 * math.sqrt(chain_bound(n_terms)) * (
            norm2 + want.abs())
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and not bool((err > limit).any())
        return ok, float(err.max()), float((err / (limit + 1e-300)).max())

    def close(self, got, want, norm2, n_terms, what):
        """Check ``got`` against ``want``; returns (max error, worst
        ratio of the error to its limit)."""
        ok, err, ratio = self.within(got, want, norm2, n_terms)
        check(ok, f"{what}: |got-want| up to {err:.3e}, {ratio:.3g} x its "
                  f"limit (or non-finite values)")
        return err, ratio

    def refused(self, got, want, norm2, n_terms, what):
        """Check that a planted fault fails the tolerance."""
        ok, err, ratio = self.within(got, want, norm2, n_terms)
        check(not ok, f"planted fault {what} passed the tolerance "
                      f"({ratio:.3g} x its limit)")
        self.faults.append({"fault": what, "max_abs_err": err,
                            "x_limit": ratio})

    def run(self, compiled, **inputs):
        """Call a compiled program and check that each generated kernel
        its report names launched once on the card (the wrappers' counts
        per kernel), and no other generated kernel."""
        from repro_torch.codegen import cuda_backend as cb

        def counts():
            return Counter(cb.run_grid_kernel.launches_by_name) + \
                Counter(cb.run_two_phase.launches_by_name)

        before = counts()
        out = compiled(**inputs)
        moved, named = counts() - before, Counter(
            compiled.report["grid_kernels"])
        check(moved == named, f"launched {dict(moved)}, but the report "
                              f"names {dict(named)}")
        return out

    @staticmethod
    def axpydot_terms(a, x, y, w=None, b=None, u=None, v=None):
        """Float64 sum and 2-norm of the terms of sum((a x + y) w), or of
        sum((a x + y)(b u + v)), each product expanded into its terms."""
        x, y = x.double(), y.double()
        z, zz = a * x + y, a * a * x * x + y * y
        if b is None:
            w = w.double()
            return (z * w).sum(), (zz * w * w).sum().sqrt()
        u, v = u.double(), v.double()
        return ((z * (b * u + v)).sum(),
                (zz * (b * b * u * u + v * v)).sum().sqrt())

    # -- phase 1 ---------------------------------------------------------
    def build(self):
        from repro_torch.kernels import build
        out = build.build_all()
        for name, info in out.items():
            for line in info["ptxas"].splitlines():
                print(f"# {name}: {line.strip()}")
        return {"kernels": {k: round(v["seconds"], 3)
                            for k, v in out.items()}}

    # -- phase 2 ---------------------------------------------------------
    def kernels_vs_plain(self):
        torch = self.torch
        from repro_torch.kernels.axpydot import axpydot, axpydot_ref
        from repro_torch.kernels.build import partial_blocks
        from repro_torch.kernels.dot import dot, dot_ref
        cases = [(n, torch.float32) for n in (1, 1023, 1_000_003,
                                              self.axpydot_n)]
        cases.append((1_000_003, torch.bfloat16))
        rows = []
        a = 0.7
        for n, dt in cases:
            x, y, w = (self.randn(n, dtype=dt, seed=s) for s in (1, 2, 3))
            x64, w64 = x.double(), w.double()
            dot_want = ((x64 * w64).sum(), (x64 * x64 * w64 * w64).sum().sqrt())
            del x64, w64
            for name, fn, ref, args, (want, norm2) in (
                    ("dot", dot, dot_ref, (x, w), dot_want),
                    ("axpydot", axpydot, axpydot_ref, (a, x, y, w),
                     self.axpydot_terms(a, x, y, w))):
                k1, k2, p = fn(*args), fn(*args), ref(*args)
                torch.cuda.synchronize()
                check(torch.equal(k1, k2), f"{name} n={n}: repeat runs "
                                           f"differ (not deterministic)")
                what = f"{name} n={n} {dt}"
                err, _ = self.close(k1, p, norm2, n, f"{what} vs plain")
                err64, ratio = self.close(k1, want, norm2, n,
                                          f"{what} vs float64")
                self.close(p, want, norm2, n, f"{what}: plain vs float64")
                rows.append({"kernel": name, "n": n, "dtype": str(dt),
                             "max_abs_err": err, "err_vs_f64": err64,
                             "x_limit": ratio})
                if n != self.axpydot_n or dt != torch.float32:
                    continue
                if name == "dot":
                    # one of the first stage's chunks left out
                    chunk = -(-n // partial_blocks(x.device))
                    self.refused(fn(x[:n - chunk], w[:n - chunk]), want,
                                 norm2, n, f"dot N={n} without its last "
                                           f"{chunk}-element chunk")
                lib = (lambda: torch.dot(x, w)) if name == "dot" else \
                    (lambda: torch.dot(a * x + y, w))
                self.results[name] = {
                    "max_abs_err": err,
                    "ms": self.time_ms(lambda: fn(*args)),
                    "plain_ms": self.time_ms(lambda: ref(*args)),
                    "library_ms": self.time_ms(lib),
                    "bytes": sum(t.numel() * t.element_size()
                                 for t in args[-2 if name == "dot"
                                               else -3:]) + 4,
                    "ops": 2 * n if name == "dot" else 4 * n}
            del x, y, w
        return {"cases": rows, "planted_faults": self.faults}

    # -- the main path ---------------------------------------------------
    def quickstart(self):
        """The quickstart flow: offload + streaming composition, both
        backends, a compilation-cache hit on recompile."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.kernels.axpydot import axpydot
        from repro_torch.pipeline import (COMPILATION_CACHE, DeviceOffloadPass,
                                          StreamingCompositionPass, lower)
        n = 1 << 20
        a = 0.7
        x, y, w = (self.randn(n, seed=s) for s in (11, 12, 13))
        want, norm2 = self.axpydot_terms(a, x, y, w)
        out = {}
        for backend in ("torch", "cuda"):
            c = lower(programs.axpydot(n)).optimize(
                [DeviceOffloadPass(), StreamingCompositionPass()]
            ).compile(backend)
            before = axpydot.launches
            r = self.run(c, a=torch.tensor(a, device=self.dev), x=x, y=y, w=w)
            if backend == "cuda":
                check(axpydot.launches == before + 1,
                      "quickstart: the axpydot kernel did not launch")
            check(r["result"].device.type == self.dev.type,
                  "outputs must stay on the compiled device")
            self.close(r["result"], want, norm2, n, f"quickstart {backend}")
            out[backend] = {"result": float(r["result"].reshape(-1)[0]),
                            "fused_regions": c.report["fused_regions"]}
        check(out["cuda"]["fused_regions"] == ["Axpy+Dot"],
              f"quickstart: fused regions {out['cuda']['fused_regions']}")
        before = dict(COMPILATION_CACHE.stats)
        lower(programs.axpydot(n)).optimize(
            [DeviceOffloadPass(), StreamingCompositionPass()]).compile("cuda")
        after = COMPILATION_CACHE.stats
        check(after["hits"] == before["hits"] + 1,
              f"quickstart: no cache hit ({before} -> {after})")
        out["expected"] = float(want)
        out["cache"] = after
        return out

    def axpydot_paper(self):
        """AXPYDOT at the paper's N through default_pipeline("cuda"): with
        StreamingComposition the Axpy->Dot stream fuses into the axpydot
        kernel; without it the lone Dot expands to the dot kernel."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.kernels.axpydot import axpydot
        from repro_torch.kernels.dot import dot
        from repro_torch.pipeline import (DeviceOffloadPass,
                                          StreamingCompositionPass, lower)
        n = self.axpydot_n
        a = torch.tensor(0.7, device=self.dev)
        x, y, w = (self.randn(n, seed=s) for s in (21, 22, 23))
        want, norm2 = self.axpydot_terms(0.7, x, y, w)
        out = {}
        for streamed in (True, False):
            passes = [DeviceOffloadPass()] + \
                ([StreamingCompositionPass()] if streamed else [])
            c = lower(programs.axpydot(n)).optimize(passes).compile(
                "cuda", cache=None)
            counter = axpydot if streamed else dot
            before = counter.launches
            r = self.run(c, a=a, x=x, y=y, w=w)["result"]
            check(counter.launches == before + 1,
                  f"axpydot streamed={streamed}: kernel did not launch")
            regions = c.report["fused_regions"]
            check(regions == (["Axpy+Dot"] if streamed else []),
                  f"axpydot streamed={streamed}: fused regions {regions}")
            self.close(r, want, norm2, n, f"axpydot N={n} streamed={streamed}")
            out["streamed" if streamed else "unstreamed"] = {
                "result": float(r.reshape(-1)[0]), "fused_regions": regions}
        out["expected"] = float(want)
        return out

    def axpydot_grid_ladder(self):
        """The Table-1 grid ladder at the paper's N: unfused 2 kernels,
        fused 1; the two-producer DAG 3 unfused, 1 fused."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.pipeline import lower
        n = self.axpydot_n
        a, b = 0.7, -0.3
        x, y, w, u, v = (self.randn(n, seed=s) for s in (31, 32, 33, 34, 35))
        want = {"one": self.axpydot_terms(a, x, y, w),
                "dag": self.axpydot_terms(a, x, y, b=b, u=u, v=v)}
        out = {}
        ta, tb = torch.tensor(a, device=self.dev), torch.tensor(b,
                                                                device=self.dev)
        for prog, build, kw, counts in (
                ("one", programs.axpydot, dict(a=ta, x=x, y=y, w=w), (2, 1)),
                ("dag", programs.axpydot_two_producer,
                 dict(a=ta, b=tb, x=x, y=y, u=u, v=v), (3, 1))):
            for fused, count in zip((False, True), counts):
                c = lower(build(n)).compile(
                    "cuda", pipeline=programs.axpydot_grid_pipeline(fused),
                    cache=None)
                kernels = c.report["grid_kernels"]
                check(len(kernels) == count and
                      c.report["grid_fallbacks"] == [],
                      f"{prog} fused={fused}: grid kernels {kernels}, "
                      f"fallbacks {c.report['grid_fallbacks']}")
                r = self.run(c, **kw)["result"]
                self.close(r, *want[prog], n, f"{prog} N={n} fused={fused}")
                out[f"{prog}_{'fused' if fused else 'unfused'}"] = kernels
        return out

    def gemver(self):
        """GEMVER at N = 16,384: the generic-expansion build (ger pair fused,
        two row-streaming gemvs) and the ger->ger->gemv chain as ONE grid
        kernel, both against float64."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.pipeline import lower
        n = self.gemver_n
        names = ("A", "u1", "v1", "u2", "v2", "y", "z")
        d = {k: self.randn(*((n, n) if k == "A" else (n,)), seed=40 + i)
             for i, k in enumerate(names)}
        c = lower(programs.gemver(n)).compile(
            "cuda", expansion_level="generic", cache=None)
        kernels = c.report["grid_kernels"]
        # at this size MapTiling tiles the row maps too, in both packages
        # (tests/test_torch_grid.py holds the reference to the same list)
        check(kernels == ["ger0_map+ger1_map_tiled", "gemv0_rows_tiled",
                          "gemv1_rows_tiled"],
              f"gemver: grid kernels {kernels}")
        check(c.report["grid_fallbacks"] == [],
              f"gemver: fallbacks {c.report['grid_fallbacks']}")
        r = self.run(c, **d)
        B = d["A"].double() + torch.outer(d["u1"].double(), d["v1"].double())
        B += torch.outer(d["u2"].double(), d["v2"].double())
        B2 = B * B
        y, z = d["y"].double(), d["z"].double()
        self.close(r["x_out"], 0.9 * B.T @ y + z,
                   (0.81 * B2.T @ (y * y) + z * z).sqrt(), n, "gemver x")
        # w = 1.1 B x against the kernels' own x, so each gemv is held to
        # the bound of its own sum
        xg = r["x_out"].double()
        self.close(r["w_out"], 1.1 * B @ xg, 1.1 * (B2 @ (xg * xg)).sqrt(),
                   n, "gemver w")
        out = {"generic": kernels}
        cc = lower(programs.gemver_chain(n)).compile(
            "cuda", pipeline=programs.gemver_chain_pipeline(), cache=None)
        chain = cc.report["grid_kernels"]
        check(len(chain) == 1 and cc.report["grid_fallbacks"] == [],
              f"gemver chain: grid kernels {chain}")
        xw = d["y"]
        rc = self.run(cc, A=d["A"], u1=d["u1"], v1=d["v1"], u2=d["u2"],
                      v2=d["v2"], xw=xw)
        self.close(rc["w_out"], 1.1 * B @ y, 1.1 * (B2 @ (y * y)).sqrt(), n,
                   "gemver chain w")
        out["chain"] = chain
        self.gemver_inputs = d
        return out

    def rowsum(self):
        """The two-phase path: rowsum -> shift fused by MapFusion (an
        in-kernel wcr edge), one grid kernel at 16,384 x 16,384."""
        from repro_torch import programs
        from repro_torch.pipeline import lower
        from repro_torch.transforms import MapFusion
        n = self.gemver_n
        s = programs.rowsum_shift(n, n)
        check(s.apply(MapFusion) == 1, "rowsum: MapFusion did not apply")
        c = lower(s).compile("cuda", cache=None)
        kernels = c.report["grid_kernels"]
        check(len(kernels) == 1, f"rowsum: grid kernels {kernels}")
        A, y = self.gemver_inputs["A"], self.gemver_inputs["y"]
        r = self.run(c, A=A, y=y)["out"]
        A, y = A.double(), y.double()
        self.close(r, 2.0 * A.sum(1) + y,
                   (4.0 * (A * A).sum(1) + y * y).sqrt(), n, "rowsum")
        return {"kernels": kernels}

    # -- phase 8 ---------------------------------------------------------
    def observe(self, kernel, program, values, current):
        """Launch observer: keep each generated kernel's operands from the
        main path, to check and time the kernel after it."""
        self.captured[kernel.desc.name] = (kernel, program, dict(values),
                                           dict(current))

    def measure_generated(self, launches):
        torch = self.torch
        from repro_torch.codegen import cuda_backend
        rows = {}
        for name, (kernel, program, values, current) in \
                sorted(self.captured.items()):
            desc = kernel.desc
            emitter = "two_phase" if program.spec.internal_wcr \
                else "grid_kernel"
            ins = {c: (v.reshape(1) if v.dim() == 0 else v).contiguous()
                   for c, v in values.items()}

            def fresh():
                return {c: (v.reshape(1) if v.dim() == 0 else v).clone()
                        for c, v in current.items()}

            def plain(vals=values, cur=current):
                news = program.run(vals, [cur[es.data]
                                          for es in program.spec.outputs])
                return cuda_backend.stitch_results(program.spec, cur, news)

            want = plain()
            # the chain run on the squares of its operands sums the squares
            # of its terms
            sq = plain({c: v * v for c, v in values.items()},
                       {c: v * v for c, v in current.items()})
            norm2 = {c: v.abs().sqrt() for c, v in sq.items()}
            n_terms = {c: terms_per_output(desc, v.numel())
                       for c, v in current.items()}

            def launch(inputs):
                outs = fresh()
                cuda_backend.launch_kernel(desc, kernel.source, inputs, outs)
                return outs

            outs = launch(ins)
            err = ratio = 0.0
            for c in outs:
                e, r = self.close(outs[c], want[c], norm2[c], n_terms[c],
                                  f"{name} vs plain ({c})")
                err, ratio = max(err, e), max(ratio, r)
            if name == "gemv1_rows_tiled":
                # every row skips the first streamed chunk of its window
                chunk = cuda_backend.window_chunk(
                    math.prod(b for _, _, b in desc.tiles))
                (vec,) = [c for c, v in ins.items()
                          if v.dim() == 1 and v.numel() > 1]
                bad = dict(ins)
                bad[vec] = ins[vec].clone()
                bad[vec][:chunk] = 0
                (c,) = outs
                self.refused(launch(bad)[c], want[c], norm2[c], n_terms[c],
                             f"{name} without the first {chunk}-element "
                             f"chunk of each row")
            outs = fresh()
            ms = self.time_ms(lambda: cuda_backend.launch_kernel(
                desc, kernel.source, ins, outs))
            plain_ms = self.time_ms(plain, reps=3, warmup=1)
            nbytes = sum(v.numel() * v.element_size() for v in values.values())
            nbytes += sum(v.numel() * v.element_size()
                          for v in current.values())
            rows[f"{emitter}:{name}"] = {
                "emitter": emitter, "max_abs_err": err, "x_limit": ratio,
                "ms": ms,
                "plain_ms": plain_ms, "bytes": nbytes,
                "ops": kernel_ops(desc),
                "library_ms": self.library_ms(name, values),
                "launches": launches[name]}
            del outs, want, sq, norm2
        return rows

    def library_ms(self, name, values):
        """One PyTorch call (or, for a fused chain, the torch composite)
        that computes the same function, timed on the kernel's own
        operands; None where the path has no such call."""
        torch = self.torch
        v = values
        f = {k: float(t) for k, t in v.items() if t.dim() == 0}
        ones = torch.ones(v["A"].shape[1], device=self.dev) \
            if "A" in v else None
        calls = {
            "axpy0_map_tiled":
                lambda: torch.add(v["y"], v["x"], alpha=f["a"]),
            "axpy1_map_tiled":
                lambda: torch.add(v["v"], v["u"], alpha=f["b"]),
            "dot0_acc_tiled": lambda: torch.dot(*v.values()),
            "axpy0_map+dot0_acc_tiled":
                lambda: torch.dot(f["a"] * v["x"] + v["y"], v["w"]),
            "axpy1_map+axpy0_map+dot0_acc_tiled":
                lambda: torch.dot(f["a"] * v["x"] + v["y"],
                                  f["b"] * v["u"] + v["v"]),
            "ger0_map+ger1_map_tiled":
                lambda: torch.addr(torch.addr(v["A"], v["u1"], v["v1"]),
                                   v["u2"], v["v2"]),
            "gemv0_rows_tiled": lambda: torch.addmv(
                v["z"], v["ger1_Aout"].T, v["y"], alpha=0.9),
            "gemv1_rows_tiled": lambda: torch.addmv(
                v["x_out"], v["ger1_Aout"], v["x_out"], beta=0.0,
                alpha=1.1),
            "ger0_map+ger1_map+gemv0_acc_tiled":
                lambda: 1.1 * torch.mv(torch.addr(torch.addr(
                    v["A"], v["u1"], v["v1"]), v["u2"], v["v2"]), v["xw"]),
            "rowsum+shift_tiled": lambda: torch.addmv(
                v["y"], v["A"], ones, alpha=2.0),
        }
        fn = calls.get(name)
        return None if fn is None else self.time_ms(fn)


def terms_per_output(desc, out_elems: int) -> int:
    """Terms summed into each element of a generated kernel's output of
    ``out_elems`` elements: the iteration lattice times the longest
    window, over the output's size."""
    lattice = desc.n_kept * desc.n_reduction * math.prod(
        t for _, t, _ in desc.tiles)
    window = max([math.prod(a.window) for a in desc.loads if a.window],
                 default=1)
    return max(1, lattice * window // max(1, out_elems))


def kernel_ops(desc) -> int:
    """Arithmetic operations a generated kernel does on this run's data:
    the traced chain's elementwise operations (a window sum counts one add
    per element) times the iteration lattice."""
    from repro_torch.codegen import vocab
    seen, count = set(), 0

    def walk(node, mult):
        nonlocal count
        if not isinstance(node, vocab.Traced) or id(node) in seen:
            return
        seen.add(id(node))
        w = math.prod(node.window) if node.window else 1
        if node.op == "sum":
            count += mult * math.prod(node.args[0].window)
        elif node.op not in ("load", "acc", "ravel", "cast"):
            count += mult * w
        for a in node.args:
            walk(a, mult)

    for o in desc.outputs:
        walk(o.value, 1)
    for _, val, _ in desc.internal:
        walk(val, 1)
    lattice = desc.n_kept * desc.n_reduction * math.prod(
        t for _, t, _ in desc.tiles)
    return int(count * lattice)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke()
    from repro_torch.codegen import cuda_backend
    from repro_torch.kernels.axpydot import axpydot
    from repro_torch.kernels.dot import dot

    def phase(name, fn):
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3),
              **(info or {})})

    phase("build", smoke.build)
    phase("kernels_vs_plain", smoke.kernels_vs_plain)

    # the main path: every launch count from 0, read after its last phase
    dot.launches = axpydot.launches = 0
    cuda_backend.reset_launch_counts()
    cuda_backend.LAUNCH_OBSERVERS.append(smoke.observe)
    try:
        phase("quickstart", smoke.quickstart)
        phase("axpydot_paper", smoke.axpydot_paper)
        phase("axpydot_grid_ladder", smoke.axpydot_grid_ladder)
        phase("gemver", smoke.gemver)
        phase("two_phase_rowsum", smoke.rowsum)
    finally:
        cuda_backend.LAUNCH_OBSERVERS.remove(smoke.observe)
    launches = {"dot": dot.launches, "axpydot": axpydot.launches,
                "grid_kernel": cuda_backend.run_grid_kernel.launches,
                "two_phase": cuda_backend.run_two_phase.launches}
    per_kernel = {**cuda_backend.run_grid_kernel.launches_by_name,
                  **cuda_backend.run_two_phase.launches_by_name}
    emit({"phase": "main_path_launches", **launches,
          "per_kernel": per_kernel})
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    t0 = time.perf_counter()
    generated = smoke.measure_generated(per_kernel)
    emit({"phase": "measure", "seconds": round(time.perf_counter() - t0, 3),
          "x_limit": {k: r["x_limit"] for k, r in generated.items()},
          "planted_faults": smoke.faults})

    rows = []
    for name in ("dot", "axpydot"):
        r = smoke.results[name]
        rows.append((name, "cuda", SOURCES[name], REPLACES[name],
                     launches[name], r))
    for name, r in generated.items():
        rows.append((name, "triton", SOURCES[r["emitter"]],
                     REPLACES[r["emitter"]], r["launches"], r))
    kernels = []
    for name, route, source, replaces, n, r in rows:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_FLOP_PER_S * 1e3
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
