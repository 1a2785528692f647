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
N = 209,715,200, GEMVER at N = 16,384, LeNet-5 at batch 1,000 (its
conv+relu+pool block as one generated kernel too), a 4096^3 Gemm, the
two-iteration StencilFlow diffusion over 131,072 x 4,096, a 4-stage jacobi
chain over 2^26 points and a 5-point star over 16,386^2. Every phase
prints a JSON line with its seconds; any failed check raises and the
script exits nonzero.
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

The matmul kernel sums each output's K terms in one sequential chain, so
its L is max(1024, K) (the ``chain`` argument of ``within``); a bf16
output is further off by its own rounding, up to one bf16 ulp
(2^-7 |want|), which is added to its limit. Two more planted faults must
fail: a matmul without its last K tile, and a 2-stage stencil chain
without the zeroing of the positions outside the field between stages.
"""
from __future__ import annotations

import functools
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
#: the same data sheet's dense bf16 tensor-core peak
BF16_TENSOR_FLOP_PER_S = 989e12

#: see the module docstring
EPS32 = 2.0 ** -23
TOL_FACTOR = 4.0
LANES = 16384
MIN_CHAIN = 1024
#: one bf16 ulp relative to the value it rounds (8 significant bits: up to
#: 2^-7 at the bottom of a binade); two bf16 roundings of nearly one value
#: may differ by that much
BF16_ULP = 2.0 ** -7

#: the TPU kernels the port's kernels replace (file:line of the function)
REPLACES = {
    "dot": "src/repro/kernels/dot/kernel.py:36",
    "axpydot": "src/repro/kernels/axpydot/kernel.py:46",
    "grid_kernel": "src/repro/codegen/pallas_backend.py:682",
    "two_phase": "src/repro/codegen/pallas_backend.py:894",
    "matmul": "src/repro/kernels/gemm/kernel.py:80",
    "stencil2d": "src/repro/kernels/stencil/kernel.py:59",
    "stencil2d_chain": "src/repro/kernels/stencil/kernel.py:120",
}
SOURCES = {
    "dot": "src/repro_torch/csrc/dot.cu",
    "axpydot": "src/repro_torch/csrc/axpydot.cu",
    "grid_kernel": "src/repro_torch/codegen/cuda_backend.py",
    "two_phase": "src/repro_torch/codegen/cuda_backend.py",
    "matmul": "src/repro_torch/csrc/gemm.cu",
    "stencil2d": "src/repro_torch/csrc/stencil.cu",
    "stencil2d_chain": "src/repro_torch/csrc/stencil.cu",
}

#: the reference package's off-chip volumes in bytes (memlet analysis) of
#: LeNet-5 at batch 1,000 (naive, InputToConstant, + StreamingComposition)
#: and of the two-iteration diffusion over 131,072 x 4,096 (offloaded,
#: streamed); tests/test_torch_lenet.py and tests/test_torch_stencil.py
#: hold both packages to them
REF_LENET_VOLUMES = {"naive": 55_267_408, "const": 54_912_000,
                     "stream": 6_352_000}
REF_STENCIL_VOLUMES = {"offloaded": 12_884_901_968,
                       "streamed": 8_589_934_672}


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
        self.lenet_batch = programs.LENET_BATCH
        self.gemm_n = programs.GEMM_N
        self.stencil_domain = programs.STENCIL_DOMAIN
        self.jacobi_n = programs.JACOBI_N
        self.star_n = programs.STAR_N
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

    def within(self, got, want, norm2, n_terms, chain=None, out_rel=0.0):
        """(ok, max |got - want|, worst ratio of the error to its limit)
        under the tolerance of the module docstring; ``norm2`` holds the
        2-norm of each output's terms, ``chain`` the longest sequential
        chain of additions where it exceeds the default L, ``out_rel`` the
        rounding of the output's own type relative to its value."""
        torch = self.torch
        got, want = got.double().reshape(-1), want.double().reshape(-1)
        norm2 = torch.as_tensor(norm2, dtype=torch.float64,
                                device=got.device).reshape(-1)
        L = chain_bound(n_terms) if chain is None else max(MIN_CHAIN, chain)
        limit = TOL_FACTOR * EPS32 * math.sqrt(L) * (norm2 + want.abs()) \
            + out_rel * want.abs()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and not bool((err > limit).any())
        return ok, float(err.max()), float((err / (limit + 1e-300)).max())

    def close(self, got, want, norm2, n_terms, what, **kw):
        """Check ``got`` against ``want``; returns (max error, worst
        ratio of the error to its limit)."""
        ok, err, ratio = self.within(got, want, norm2, n_terms, **kw)
        check(ok, f"{what}: |got-want| up to {err:.3e}, {ratio:.3g} x its "
                  f"limit (or non-finite values)")
        return err, ratio

    def refused(self, got, want, norm2, n_terms, what, **kw):
        """Check that a planted fault fails the tolerance."""
        ok, err, ratio = self.within(got, want, norm2, n_terms, **kw)
        check(not ok, f"planted fault {what} passed the tolerance "
                      f"({ratio:.3g} x its limit)")
        self.faults.append({"fault": what, "max_abs_err": err,
                            "x_limit": ratio})

    def run(self, compiled, hand=None, **inputs):
        """Call a compiled program and check that each generated kernel
        its report names launched once on the card (the wrappers' counts
        per kernel), and no other generated kernel; with ``hand`` (hand
        kernel name -> launches), also that each hand-written kernel
        launched exactly so often, and no other."""
        from repro_torch.codegen import cuda_backend as cb

        def counts():
            return Counter(cb.run_grid_kernel.launches_by_name) + \
                Counter(cb.run_two_phase.launches_by_name)

        before, hand_before = counts(), hand_counts()
        out = compiled(**inputs)
        moved, named = counts() - before, Counter(
            compiled.report["grid_kernels"])
        check(moved == named, f"launched {dict(moved)}, but the report "
                              f"names {dict(named)}")
        if hand is not None:
            moved = hand_counts() - hand_before
            check(moved == Counter(hand), f"hand kernels launched "
                                          f"{dict(moved)}, not {hand}")
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
        rows += self.matmul_vs_plain()
        rows += self.stencils_vs_plain()
        return {"cases": rows, "planted_faults": self.faults}

    def lenet_matmuls(self):
        """(layer, M, K, N, activation) of the five matmul launches of one
        LeNet-5 forward at the batch the main path runs."""
        b = self.lenet_batch
        return [("conv1", b * 24 * 24, 25, 6, "relu"),
                ("conv2", b * 8 * 8, 150, 16, "relu"),
                ("fc1", b, 256, 120, "relu"), ("fc2", b, 120, 84, "relu"),
                ("fc3", b, 84, 10, None)]

    def matmul_terms(self, a, b, bias=None, act=None):
        """Float64 act(a @ b + bias), and the 2-norm of each output's
        terms (the products and the bias)."""
        from repro_torch.kernels.gemm.ref import act as activate
        a, b = a.double(), b.double()
        want, sq = a @ b, (a * a) @ (b * b)
        if bias is not None:
            want, sq = want + bias.double(), sq + bias.double() ** 2
        return activate(act, want), sq.sqrt()

    def matmul_vs_plain(self):
        """The matmul kernel against its plain version and float64: odd
        shapes, the five LeNet shapes (B as the path passes it, a
        transposed weight view), every activation, fp32 and bf16; one
        planted fault; times at the path's shapes and at 4096^3."""
        torch = self.torch
        from repro_torch.kernels.gemm import matmul, matmul_ref
        from repro_torch.kernels.gemm.kernel import K_TILE
        rows, timed = [], []
        cases = [("odd", 300, 200, 150, None), ("odd", 64, 1000, 32, None)]
        cases += self.lenet_matmuls()
        for i, (layer, M, K, N, path_act) in enumerate(cases):
            for dt in (torch.float32, torch.bfloat16):
                a = self.randn(M, K, dtype=dt, seed=100 + i)
                b = self.randn(N, K, dtype=dt, seed=200 + i)
                b = b.T if layer != "odd" else b.reshape(K, N)
                bias = self.randn(N, seed=300 + i)
                out_rel = BF16_ULP if dt == torch.bfloat16 else 0.0
                for act in (None, "relu", "silu", "gelu"):
                    got = matmul(a, b, bias, activation=act)
                    plain = matmul_ref(a, b, bias, activation=act)
                    want, norm2 = self.matmul_terms(a, b, bias, act)
                    what = f"matmul {layer} {M}x{K}x{N} {dt} {act}"
                    err, _ = self.close(got, plain, norm2, K,
                                        f"{what} vs plain", chain=K,
                                        out_rel=out_rel)
                    err64, ratio = self.close(got, want, norm2, K,
                                              f"{what} vs float64", chain=K,
                                              out_rel=out_rel)
                    rows.append({"kernel": "matmul", "layer": layer,
                                 "shape": [M, K, N], "dtype": str(dt),
                                 "act": act, "max_abs_err": err,
                                 "err_vs_f64": err64, "x_limit": ratio})
                    if layer == "conv2" and act == "relu" and \
                            dt == torch.float32:
                        keep = (K - 1) // K_TILE * K_TILE
                        self.refused(
                            matmul(a[:, :keep], b[:keep], bias,
                                   activation=act), want, norm2, K,
                            f"matmul {M}x{K}x{N} without its last "
                            f"{K - keep}-column K tile", chain=K)
                if layer != "odd" and dt == torch.float32:
                    timed.append(self.time_matmul(layer, a, b, bias,
                                                  path_act, err))
                del a, b
        n = self.gemm_n
        for dt in (torch.float32, torch.bfloat16):
            a = self.randn(n, n, dtype=dt, seed=400)
            b = self.randn(n, n, dtype=dt, seed=401)
            timed.append(self.time_matmul("gemm", a, b, None, None, None))
            del a, b
        lenet = [t for t in timed if t["layer"] != "gemm"]
        t_bytes = sum(t["t_bytes"] for t in lenet)
        t_ops = sum(t["t_ops"] for t in lenet)
        self.results["matmul"] = {
            "max_abs_err": max(t["max_abs_err"] for t in lenet),
            **{k: sum(t[k] for t in lenet)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "measured_on": "the five matmul launches of one LeNet-5 "
                           f"forward at batch {self.lenet_batch}, summed",
            "shapes": timed}
        return rows

    def time_matmul(self, layer, a, b, bias, act, err):
        """Times of the kernel, its plain version and one PyTorch call
        (``addmm`` or ``matmul``, then the activation) on these operands,
        and the least time the card could take (bytes at the memory rate,
        2 M N K operations at fp32's FMA or bf16's tensor-core peak)."""
        torch = self.torch
        from repro_torch.kernels.gemm import matmul, matmul_ref
        from repro_torch.kernels.gemm.ref import act as activate
        (M, K), N = a.shape, b.shape[1]

        def library():
            y = torch.matmul(a, b) if bias is None else \
                torch.addmm(bias, a, b)
            return activate(act, y)

        size = a.element_size()
        nbytes = (M * K + K * N + M * N) * size + (
            0 if bias is None else 4 * N)
        peak = FP32_FLOP_PER_S if a.dtype == torch.float32 else \
            BF16_TENSOR_FLOP_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * M * N * K / peak * 1e3
        if err is None:   # the square product: its error against plain
            got = matmul(a, b)
            err = float((got.double() - matmul_ref(a, b).double()).abs()
                        .max())
        return {"layer": layer, "shape": [M, K, N], "dtype": str(a.dtype),
                "act": act, "max_abs_err": err,
                "ms": self.time_ms(lambda: matmul(a, b, bias,
                                                  activation=act)),
                "plain_ms": self.time_ms(lambda: matmul_ref(
                    a, b, bias, activation=act)),
                "library_ms": self.time_ms(library),
                "bound_ms": max(t_bytes, t_ops), "t_bytes": t_bytes,
                "t_ops": t_ops,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def stencil_terms(self, a, coeffs_per_stage, offsets_per_stage):
        """Float64 chain of stencils with a constant-0 boundary, and the
        2-norm of each output's terms (the chain run with squared
        coefficients on the squared field)."""
        a = a.double()
        want, sq = a, a * a
        for c, offs in zip(coeffs_per_stage, offsets_per_stage):
            c = self.torch.as_tensor(c, dtype=self.torch.float64,
                                     device=a.device)
            want = stencil64(want, c, offs)
            sq = stencil64(sq, c * c, offs)
        return want, sq.sqrt()

    def stencils_vs_plain(self):
        """stencil2d (asymmetric radius-2 taps, a prime H) and
        stencil2d_chain (2 and 3 stages of mixed radii) against their
        plain versions and float64; the paper's domain with the
        diffusion taps, timed; one planted fault there."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch import programs
        from repro_torch.kernels.stencil import (stencil2d, stencil2d_chain,
                                                 stencil2d_chain_ref,
                                                 stencil2d_ref)
        diff = programs.DIFFUSION_OFFSETS
        skew = ((0, 0), (-2, 1), (1, 2), (2, -1), (0, -2), (-1, -1))
        wide = ((0, 0), (-2, 0), (2, 0), (0, -2), (0, 2))
        H, W = self.stencil_domain
        cases = [("stencil2d", (1009, 777), (skew,)),
                 ("stencil2d_chain", (1009, 515), (diff, skew)),
                 ("stencil2d_chain", (997, 1024), (wide, diff, skew)),
                 ("stencil2d", (H, W), (diff,)),
                 ("stencil2d_chain", (H, W), (diff, diff))]
        rows = []
        for i, (name, (h, w), stages) in enumerate(cases):
            a = self.randn(h, w, seed=500 + i)
            coeffs = [0.3 * self.randn(len(o), seed=600 + 10 * i + s)
                      for s, o in enumerate(stages)]
            if name == "stencil2d":
                fn, ref = (functools.partial(f, coeffs=coeffs[0],
                                             offsets=stages[0])
                           for f in (stencil2d, stencil2d_ref))
            else:
                fn, ref = (functools.partial(f, coeffs_per_stage=coeffs,
                                             offsets_per_stage=stages)
                           for f in (stencil2d_chain, stencil2d_chain_ref))
            got, plain = fn(a), ref(a)
            want, norm2 = self.stencil_terms(a, coeffs, stages)
            n_terms = sum(len(o) for o in stages)
            what = f"{name} {h}x{w} {len(stages)} stage(s)"
            err, _ = self.close(got, plain, norm2, n_terms, f"{what} vs plain")
            err64, ratio = self.close(got, want, norm2, n_terms,
                                      f"{what} vs float64")
            rows.append({"kernel": name, "shape": [h, w],
                         "taps": [len(o) for o in stages],
                         "max_abs_err": err, "err_vs_f64": err64,
                         "x_limit": ratio})
            del got, plain
            if (h, w) == (H, W):
                if name == "stencil2d_chain":
                    # the chain without its inter-stage mask: the field
                    # padded by R, where the mask zeroes nothing near it
                    R = sum(max(max(abs(di), abs(dj)) for di, dj in o)
                            for o in stages)
                    bad = stencil2d_chain(F.pad(a, (R, R, R, R)), coeffs,
                                          stages)[R:-R, R:-R]
                    self.refused(bad, want, norm2, n_terms,
                                 f"{name} {h}x{w} without the inter-stage "
                                 f"boundary mask")
                    del bad
                del want, norm2
                self.results[name] = self.time_stencil(
                    a, coeffs, stages, fn, ref, err)
            del a
        return rows

    def time_stencil(self, a, coeffs, stages, fn, ref, err):
        """Times of a stencil kernel, its plain version and F.conv2d with
        the taps as a kernel (one call a stage), and its bound: the field
        read once and written once."""
        torch = self.torch
        import torch.nn.functional as F
        weights = []
        for c, offs in zip(coeffs, stages):
            r = max(max(abs(di), abs(dj)) for di, dj in offs)
            k = torch.zeros(1, 1, 2 * r + 1, 2 * r + 1, device=a.device)
            for (di, dj), v in zip(offs, c):
                k[0, 0, di + r, dj + r] = v
            weights.append((k, r))

        def library():
            x = a[None, None]
            for k, r in weights:
                x = F.conv2d(x, k, padding=r)
            return x

        h, w = a.shape
        n_taps = sum(len(o) for o in stages)
        t_bytes = 2 * h * w * 4 / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * n_taps * h * w / FP32_FLOP_PER_S * 1e3
        return {"max_abs_err": err, "ms": self.time_ms(lambda: fn(a)),
                "plain_ms": self.time_ms(lambda: ref(a), reps=3, warmup=1),
                "library_ms": self.time_ms(library),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "shapes": [{"shape": [h, w], "taps": [len(o) for o in stages]}]}

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

    def lenet_paper(self):
        """LeNet-5 at the paper's batch with ``init_lenet_params(0)``: the
        naive build (DeviceOffload) on the torch backend, and the ladder
        (InputToConstant + DeviceOffload + StreamingComposition) on the
        cuda backend, where both conv+pool pairs fuse and one forward
        launches the matmul kernel five times; probs against the torch
        oracle at the reference's rtol 1e-3 / atol 1e-5."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.frontends.ml import (build_lenet, init_lenet_params,
                                              lenet_params_from_reference,
                                              lenet_reference)
        from repro_torch.pipeline import (DeviceOffloadPass,
                                          InputToConstantPass,
                                          StreamingCompositionPass, lower)
        from repro_torch.transforms import (DeviceOffload, InputToConstant,
                                            StreamingComposition)
        b = self.lenet_batch
        params = init_lenet_params(0)
        weights = lenet_params_from_reference(params, self.dev)
        x = self.randn(b, 1, 28, 28, seed=60)
        want = lenet_reference(weights, x)
        naive = lower(build_lenet(b)).optimize(
            [DeviceOffloadPass()]).compile("torch", cache=None)
        ladder = lower(build_lenet(b)).optimize(
            [InputToConstantPass(parameters=params), DeviceOffloadPass(),
             StreamingCompositionPass()]).compile("cuda", cache=None)
        regions = ladder.report["fused_regions"]
        check(regions.count("Conv2d+MaxPool2d") == 2,
              f"lenet: fused regions {regions}")
        out = {"fused_regions": regions}
        for name, c, kw, hand in (("naive", naive, weights, {}),
                                  ("ladder", ladder, {}, {"matmul": 5})):
            probs = self.run(c, hand=hand, x=x, **kw)["probs"]
            check(probs.shape == (b, 10) and probs.device == x.device,
                  f"lenet {name}: probs {tuple(probs.shape)} on "
                  f"{probs.device}")
            err = (probs - want).abs()
            check(bool(torch.isfinite(probs).all()) and
                  bool((err <= 1e-5 + 1e-3 * want.abs()).all()),
                  f"lenet {name}: probs off the oracle by up to "
                  f"{float(err.max()):.3e}")
            out[name] = {"max_abs_err": float(err.max()),
                         "argmax_agrees": float(
                             (probs.argmax(1) == want.argmax(1)).float()
                             .mean())}
        volumes = {}
        s = build_lenet(b)
        s.apply(DeviceOffload)
        volumes["naive"] = s.off_chip_volume()
        s = build_lenet(b)
        s.apply(InputToConstant, parameters=params)
        s.apply(DeviceOffload)
        volumes["const"] = s.off_chip_volume()
        s.apply(StreamingComposition)
        volumes["stream"] = s.off_chip_volume()
        if b == programs.LENET_BATCH:
            check(volumes == REF_LENET_VOLUMES,
                  f"lenet volumes {volumes} != the reference's "
                  f"{REF_LENET_VOLUMES}")
        out["off_chip_bytes"] = volumes
        out["reference_off_chip_bytes"] = REF_LENET_VOLUMES
        return out

    def plain_terms(self, plain, **inputs):
        """A plain program's result, and the 2-norm of each output's terms
        (the program run on the squares of its inputs: right for sums of
        products under relu and max)."""
        want = {k: v for k, v in plain(**inputs).items()}
        sq = plain(**{k: v * v for k, v in inputs.items()})
        return want, {k: v.abs().sqrt() for k, v in sq.items()}

    def convblock(self):
        """LeNet's conv+relu+pool block at batch 1,000 as ONE generated
        grid kernel (halo-aware MapFusion), and as two under the per-stage
        pipeline; both against the plain program (the torch backend)."""
        from repro_torch import programs
        from repro_torch.pipeline import lower
        b = self.lenet_batch
        inputs = {"x": self.randn(b, 1, 28, 28, seed=61),
                  "W": 0.1 * self.randn(8, 1, 5, 5, seed=62),
                  "bias": 0.1 * self.randn(8, seed=63)}
        plain = lower(programs.convblock(b)).compile("torch", cache=None)
        want, norm2 = self.plain_terms(plain, **inputs)
        out = {}
        for name, pipeline, count in (
                ("fused", None, 1),
                ("perstage", programs.perstage_pipeline(), 2)):
            c = lower(programs.convblock(b)).compile(
                "cuda", pipeline=pipeline, cache=None)
            kernels = c.report["grid_kernels"]
            check(len(kernels) == count and c.report["grid_fallbacks"] == [],
                  f"convblock {name}: grid kernels {kernels}, fallbacks "
                  f"{c.report['grid_fallbacks']}")
            got = self.run(c, hand={}, **inputs)["y"]
            err, ratio = self.close(got, want["y"], norm2["y"], 25,
                                    f"convblock {name}")
            out[name] = {"kernels": kernels, "max_abs_err": err,
                         "x_limit": ratio}
        return out

    def gemm_program(self):
        """A Gemm ``@dc_program`` through ``frontends/blas.gemm`` at
        4096^3, fp32 and bf16: its ``cuda`` level launches the matmul
        kernel once per call; against float64."""
        torch = self.torch
        from repro_torch import programs
        n = self.gemm_n
        out = {}
        for dt in ("float32", "bfloat16"):
            c = programs.gemm.lower(n=n, dtype=dt).compile("cuda", cache=None)
            check(c.report["expansions"] == ["gemm0->cuda"],
                  f"gemm {dt}: expansions {c.report['expansions']}")
            A = self.randn(n, n, dtype=getattr(torch, dt), seed=64)
            B = self.randn(n, n, dtype=getattr(torch, dt), seed=65)
            got = self.run(c, hand={"matmul": 1}, A=A, B=B)["C"]
            check(got.dtype == A.dtype, f"gemm {dt}: output {got.dtype}")
            want, norm2 = self.matmul_terms(A, B)
            err, ratio = self.close(
                got, want, norm2, n, f"gemm {n}^3 {dt}", chain=n,
                out_rel=BF16_ULP if dt == "bfloat16" else 0.0)
            out[dt] = {"max_abs_err": err, "x_limit": ratio}
            del A, B, want, norm2, got
        return out

    def stencilflow_paper(self):
        """The two-iteration diffusion program at the paper's 2-D domain:
        offloaded only, the two Stencil nodes launch stencil2d twice;
        streamed, they fuse ('Stencil+Stencil') into one stencil2d_chain
        launch; both against float64."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.frontends.stencil import build_stencil_program
        from repro_torch.pipeline import (DeviceOffloadPass,
                                          StreamingCompositionPass, lower)
        H, W = self.stencil_domain
        offs = programs.DIFFUSION_OFFSETS
        a = self.randn(H, W, seed=70)
        co = torch.tensor([0.2, 0.1, 0.15, 0.25, 0.3], device=self.dev)
        want, norm2 = self.stencil_terms(a, [co, co], [offs, offs])
        staged = lower(build_stencil_program(programs.diffusion_spec((H, W))))
        staged.optimize([DeviceOffloadPass()])
        volumes = {"offloaded": staged.sdfg.off_chip_volume()}
        out = {}
        for name, regions, hand in (
                ("unfused", [], {"stencil2d": 2}),
                ("fused", ["Stencil+Stencil"], {"stencil2d_chain": 1})):
            if name == "fused":
                staged.optimize([StreamingCompositionPass()])
                volumes["streamed"] = staged.sdfg.off_chip_volume()
            c = staged.compile("cuda", cache=None)
            check(c.report["fused_regions"] == regions,
                  f"stencilflow {name}: fused regions "
                  f"{c.report['fused_regions']}")
            got = self.run(c, hand=hand, a=a, b_coeffs=co, d_coeffs=co)["d"]
            err, ratio = self.close(got, want, norm2, 10,
                                    f"stencilflow {name} {H}x{W}")
            out[name] = {"max_abs_err": err, "x_limit": ratio}
            del got
        if (H, W) == programs.STENCIL_DOMAIN:
            check(volumes == REF_STENCIL_VOLUMES,
                  f"stencilflow volumes {volumes} != the reference's "
                  f"{REF_STENCIL_VOLUMES}")
        out["off_chip_bytes"] = volumes
        out["reference_off_chip_bytes"] = REF_STENCIL_VOLUMES
        return out

    def jacobi_chain(self):
        """The 4-stage jacobi chain over 2^26 interior points as ONE
        16-tasklet grid kernel; against float64."""
        from repro_torch import programs
        from repro_torch.pipeline import lower
        n = self.jacobi_n
        a = self.randn(n, seed=71)
        c = lower(programs.jacobi_chain(n)).compile("cuda", cache=None)
        kernels, conv = c.report["grid_kernels"], c.report["grid_converted"]
        check(len(kernels) == 1 and conv[0].get("tasklets") == 16,
              f"jacobi chain: grid kernels {kernels} ({conv})")
        got = self.run(c, hand={}, a=a)["b"]
        coef = (0.25, 0.5, 0.25)
        want = jacobi64(a.double(), coef)
        norm2 = jacobi64(a.double() ** 2, [v * v for v in coef]).sqrt()
        err, ratio = self.close(got, want, norm2, 81, f"jacobi chain N={n}")
        return {"kernels": kernels, "tasklets": conv[0]["tasklets"],
                "max_abs_err": err, "x_limit": ratio}

    def star(self):
        """The 5-point star over the interior of a 16,386^2 field: one
        partial-coverage grid kernel that leaves the boundary of b
        untouched; against float64."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.pipeline import lower
        n = self.star_n
        a = self.randn(n, n, seed=72)
        c = lower(programs.star5(n, n)).compile("cuda", cache=None)
        kernels = c.report["grid_kernels"]
        check(len(kernels) == 1 and c.report["grid_fallbacks"] == [],
              f"star: grid kernels {kernels}, fallbacks "
              f"{c.report['grid_fallbacks']}")
        got = self.run(c, hand={}, a=a)["b"]
        star = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
        c64 = torch.tensor([0.5, 0.125, 0.125, 0.125, 0.125],
                           dtype=torch.float64, device=self.dev)
        a64 = a.double()
        want = torch.zeros_like(a64)
        norm2 = torch.zeros_like(a64)
        want[1:-1, 1:-1] = stencil64(a64, c64, star)[1:-1, 1:-1]
        norm2[1:-1, 1:-1] = stencil64(a64 * a64, c64 * c64,
                                      star)[1:-1, 1:-1].sqrt()
        del a64
        err, ratio = self.close(got, want, norm2, 5, f"star {n}^2")
        edge = torch.cat([got[0], got[-1], got[:, 0], got[:, -1]])
        check(bool((edge == 0).all()), "star: the boundary of b was written")
        return {"kernels": kernels, "max_abs_err": err, "x_limit": ratio}

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
            t0 = time.perf_counter()
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
            print(f"# measured {name} in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
        return rows

    def library_ms(self, name, values):
        """One PyTorch call (or, for a fused chain, the torch composite)
        that computes the same function, timed on the kernel's own
        operands; None where the path has no such call."""
        torch = self.torch
        import torch.nn.functional as F
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
            "conv+pool_tiled": lambda: F.max_pool2d(torch.relu(F.conv2d(
                v["x"], v["W"], v["bias"])), 2),
            "conv_tiled": lambda: torch.relu(F.conv2d(v["x"], v["W"],
                                                      v["bias"])),
            "pool_tiled": lambda: F.max_pool2d(v["t"], 2),
            "jacobi0+jacobi1+jacobi2+jacobi3_tiled":
                lambda: jacobi64(v["a"], (0.25, 0.5, 0.25)),
            "star_tiled": lambda: F.conv2d(v["a"][None, None], star_weight(
                v["a"].device)),
        }
        fn = calls.get(name)
        return None if fn is None else self.time_ms(fn)


#: the hand-written kernels' wrappers, by kernel name
HAND_KERNELS = ("dot", "axpydot", "matmul", "stencil2d", "stencil2d_chain")


def hand_wrappers():
    from repro_torch.kernels.axpydot import axpydot
    from repro_torch.kernels.dot import dot
    from repro_torch.kernels.gemm import matmul
    from repro_torch.kernels.stencil import stencil2d, stencil2d_chain
    return {"dot": dot, "axpydot": axpydot, "matmul": matmul,
            "stencil2d": stencil2d, "stencil2d_chain": stencil2d_chain}


def hand_counts() -> Counter:
    return Counter({k: w.launches for k, w in hand_wrappers().items()})


def stencil64(a, coeffs, offsets):
    """out[p] = sum_k coeffs[k] a[p + offsets[k]] with a constant-0
    boundary, in a's dtype (float64 here)."""
    import torch.nn.functional as F
    r = max(max(abs(di), abs(dj)) for di, dj in offsets)
    p = F.pad(a, (r, r, r, r))
    H, W = a.shape
    out = a.new_zeros(a.shape)
    for c, (di, dj) in zip(coeffs, offsets):
        out += c * p[r + di:r + di + H, r + dj:r + dj + W]
    return out


def jacobi64(a, coef, stages=4, margin=64):
    """The jacobi chain of ``programs.jacobi_chain`` in a's dtype (the
    float64 reference, and in fp32 the torch composite): stage k computes
    [margin (k+1), n - margin (k+1)) from its predecessor; the rest of
    each stage's output stays 0."""
    n = a.shape[0]
    cur = a
    for k in range(stages):
        lo, hi = margin * (k + 1), n - margin * (k + 1)
        nxt = a.new_zeros(a.shape)
        nxt[lo:hi] = (coef[0] * cur[lo - 1:hi - 1] + coef[1] * cur[lo:hi]
                      + coef[2] * cur[lo + 1:hi + 1])
        cur = nxt
    return cur


def star_weight(device):
    """The star of ``programs.star5`` as a 3 x 3 conv2d weight."""
    import torch
    k = torch.zeros(1, 1, 3, 3, device=device)
    k[0, 0, 1, 1] = 0.5
    k[0, 0, 0, 1] = k[0, 0, 2, 1] = k[0, 0, 1, 0] = k[0, 0, 1, 2] = 0.125
    return k


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

    def phase(name, fn):
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3),
              **(info or {})})

    phase("build", smoke.build)
    phase("kernels_vs_plain", smoke.kernels_vs_plain)

    # the main path: every launch count from 0, read after its last phase
    for wrapper in hand_wrappers().values():
        wrapper.launches = 0
    cuda_backend.reset_launch_counts()
    cuda_backend.LAUNCH_OBSERVERS.append(smoke.observe)
    try:
        phase("quickstart", smoke.quickstart)
        phase("axpydot_paper", smoke.axpydot_paper)
        phase("axpydot_grid_ladder", smoke.axpydot_grid_ladder)
        phase("gemver", smoke.gemver)
        phase("two_phase_rowsum", smoke.rowsum)
        phase("lenet_paper", smoke.lenet_paper)
        phase("convblock", smoke.convblock)
        phase("gemm_program", smoke.gemm_program)
        phase("stencilflow_paper", smoke.stencilflow_paper)
        phase("jacobi_chain", smoke.jacobi_chain)
        phase("star", smoke.star)
    finally:
        cuda_backend.LAUNCH_OBSERVERS.remove(smoke.observe)
    launches = {**dict(hand_counts()),
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
    for name in HAND_KERNELS:
        r = smoke.results[name]
        rows.append((name, "cuda", SOURCES[name], REPLACES[name],
                     launches[name], r))
    for name, r in generated.items():
        rows.append((name, "triton", SOURCES[r["emitter"]],
                     REPLACES[r["emitter"]], r["launches"], r))
    kernels = []
    for name, route, source, replaces, n, r in rows:
        if "bound_ms" in r:     # summed over the shapes the row measured
            bound_ms, bound_by = r["bound_ms"], r["bound_by"]
        else:
            t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = r["ops"] / FP32_FLOP_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
        row = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": n,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": r["library_ms"]}
        for extra in ("measured_on", "shapes"):
            if extra in r:
                row[extra] = r[extra]
        kernels.append(row)
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
