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
chain over 2^26 points and a 5-point star over 16,386^2; the paper's Fig. 19
through the port's own benchmark (``repro_torch.benchmarks.stencil_bench``:
diffusion2d over 131,072 x 4,096, jacobi3d and diffusion3d over 32,768 x
128 x 128, the star tiled and with 1-element blocks, the chain); and the
paged-KV serving path with starcoder2-3b at full width and depth (30
layers, d_model 3,072, seeded random weights from the port's init): a
``Scheduler`` answers ``benchmarks/serve_bench.py``'s 64 requests (prompt
16, 24 new tokens, 16-token pages, model length 512, 64 slots) through
``DecodeStepCompiler`` under ``default_pipeline("cuda")`` — one generated
attention kernel a layer — in fp32 (greedy streams token-identical to the
dense ``TransformerLM.decode_step`` loop), in bf16 held step by step
against the torch-level step, and in bf16 timed; then one bucket with the
hand-written ``decode_attention`` kernel (``expansion_level="flash"``).
Then, with starcoder2-3b's weights freed, the RWKV6 family at rwkv6-7b's
full width and depth (32 layers, d_model 4,096, 64 heads of 64, d_ff
14,336, vocab 65,536; 6,980,902,912 seeded random fp32 parameters):
``TransformerLM.forward`` on 4 x 1,024 tokens (one launch of the
hand-written ``wkv_chunked`` kernel a layer) and a ``Scheduler`` at the
same serving geometry with 16-token prefill chunks (one ``wkv_chunked``
launch a layer for each request's prompt; decode steps take the
sequential scan), fp32 streams against the model's ``decode_step`` loop,
bf16 held step by step and bf16 timed. Last, with rwkv6-7b's weights
freed, gemma3-4b's prefill at full width and depth (34 layers, d_model
2,560, 8 query and 4 KV heads of 256, d_ff 10,240, vocab 262,144, tied
embeddings; seeded random fp32 parameters): ``TransformerLM.forward`` on
2 x 4,096 tokens with ``attention_impl="chunked"``, one launch of the
hand-written ``flash_attention`` kernel a layer (29 layers with the
1,024-token window, 5 global), held to the same forward with the einsum
attention (``attention_impl="naive"``).
Every phase prints a JSON line with its seconds; any failed check raises
and the script exits nonzero.
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
over 528 x 256 threads, 4 blocks of 256 an SM, each thread summing about
1,550 terms, four at a time from every 135,168th vector; a generated
reduction over 528 programs of 2,048 lanes, each lane about 190 terms),
and no window is streamed in more than 1,024 chunks (a gemv row of
16,384 takes 256 chunks of 64, in ranges over 9 programs). At
N = 209,715,200 the limit is about 1.6: leaving out one of the dot
kernel's 528 blocks' share of the terms (~396k terms in runs of 1,024, a
shift of some hundreds) fails it, and the script plants that fault and
checks that it is rejected, as it does for a gemv whose rows skip their
first streamed chunk of 64 and for the two-phase row sum at 16,384 x
16,384 without its last 128 columns (its last reduction step). A single wrong element among 2e8 (a shift of
~1) can pass.

The matmul kernels sum each output's K terms in one sequential chain (the
fma route one product at a time, the wgmma route 16 at a time on the
tensor cores), so their L is max(1024, K) (the ``chain`` argument of
``within``); a bf16 output is further off by its own rounding, up to one
bf16 ulp (2^-7 |want|), which is added to its limit. Three more planted
faults must fail: a matmul without its last K tile on each route (6
columns of the fma route's conv2 product, 64 of a wgmma product), and a
2-stage stencil chain without the zeroing of the positions outside the
field between stages.

Decode attention, out = sum_j p_j v_j with p = softmax(s) and
s_j = q . k_j / sqrt(Dh), is held per output to

    4 eps32 (2 sqrt(Dh) T + sqrt(C) + 1) A  (+ one bf16 ulp of |want|),

T the largest sum_d |q_d k_jd| / sqrt(Dh) over the row's unmasked j and
A = sum_j p_j |v_jd|: an fp32 score is off by about eps32 sqrt(Dh) T, which
moves each p_j by that much relative to itself (twice, through the
normalizer), and the sum over C positions adds eps32 sqrt(C) A; the
generated row kernel's one-pass softmax rescales its sums once a 32-row
chunk, a chain of at most C / 32 fp32 products, inside the sqrt(C) term.
Two planted faults must fail it: the hand kernel run with pos + 1, whose
mask admits one position that holds nonzero K/V, and the generated row
kernel with its loop range one row short (ending at pos - 1), which never
reads row pos though the mask admits it.

The Fig.-19 kernels (``diffusion2d``, ``jacobi3d``, ``diffusion3d``) sum
each output's 5 or 7 terms in one chain of that length, so they take the
bound above with n = 5 or 7 (L = 1,024), against float64 and against their
plain versions. The float64 oracle is computed slab by slab along the first
axis (2^26 points a slab, with a halo of one row or plane), so a 2 GiB
field never has a whole float64 copy. Two planted faults must fail:
diffusion2d with c1 and c2 exchanged (up and down swapped), and jacobi3d
launched on each 4,096-plane slab of D alone, so that the planes at the
slab edges lose a neighbour. The ``stencil_fig19`` phase holds every output
of the benchmark the same way (the star's 5 terms, the two-iteration chain's
10), checks its report names against the reference benchmark's, and prints
its peak device memory.

The WKV (``wkv_chunked``) is held per output to

    4 eps32 (sqrt(L) + 16 Lambda) M  (+ one bf16 ulp of |want|),

L = 1,024 (no sum in the kernel runs longer than 2 hd + 16 terms), M the
same recurrence run in float64 on |r|, |k|, |v|, |u| and |state0| (each
output's, and the final state's, sum of the magnitudes of its terms), and
Lambda the largest |cumulative log decay| within a chunk of this run's w
(at most 56 for the model's w): a product of decays exp(la_t - la_j) is
formed from two fp32 cumulative sums of up to 16 logs, each off by up to
8 Lambda eps32, so each term is off by up to 16 Lambda eps32 relative to
itself, and the sums add eps32 sqrt(L) M. The kernel takes its products
on the tensor cores as three tf32 products each (hi hi + hi lo + lo hi of
x = hi + lo), off by at most about 2^-21 (4 eps32) of each product: 4 eps32
M, inside the sqrt(L) term. It takes its logs and powers in base 2 on the
special-function unit: __log2f is off by at most 2^-22 absolute for w in
[0.5, 1) (2 ulp, relative, below 0.5: at most 2 Lambda eps32 more on a
cumulative log, inside the factor 4 of the Lambda term), so 16 of them put
up to 2^-18 = 32 eps32 on a cumulative log2, which a power 2^x turns into
ln 2 * 32 eps32 = 22 eps32 relative; a term takes two such powers and
ex2.approx adds 2 ulp to each, so under 50 eps32 relative to each term
even where w is near 1 and Lambda near 0. With the sums' eps32 sqrt(L)
and the tf32 products' 4 eps32 that is under 86 eps32 M, inside the
4 eps32 sqrt(L) M = 128 eps32 M that the limit grants at Lambda = 0.
A control, the plain chunked form with every product's operands
rounded to tf32 (what a kernel that dropped hi lo and lo hi would
compute), must fail the limit together with the fp32 parity below by at
least 4x at the admission shapes (from a zero and from a random state)
and the forward shape: the limit alone rejected it by only 1.0-1.4x on
the outputs. Two planted faults must fail the limit:
the last chunk of the forward shape run without the state carried into
it, and the admission shape from a random state0 (a later prefill chunk)
with the state's columns 16:32 (one warp's 16 value channels) zeroed.
The forward's fp32 logits are held to 2^-12 of the row's largest |logit|
of the same forward with the WKV through its plain version: the two differ
only by the WKV's fp32 rounding (relative 1e-5 or less, by the bound
above) carried through 32 residual layers, and 2^-12 leaves more than an
order of magnitude for its growth on the way.

Prefill flash attention (``flash_attention``) is held per output to the
decode-attention bound above, with C the row's admitted keys (Sk for a row
that admits none, whose output is the mean of V) and T the largest score
term sum over them; the online softmax's rescalings (one per 32-key tile)
are a chain of at most Sk / 32 fp32 products, inside the sqrt(C) term. The
kernel takes both products on the tensor cores, in fp32 as three tf32
products each (below 2^-21 of each product, as for the WKV: inside the
sqrt(Dh) and sqrt(C) terms), scales the scores after the product (one more
rounding of a score, inside the sqrt(Dh) T term) and takes expf, as the
plain version takes torch.exp. Two planted faults must fail it:
gemma3-4b's global layer with the diagonal masked out (the kernel run
with q_offset = -1) and its windowed layer with the window widened by
one. The chunked forward's fp32 logits are held to
2^-12 of the row's largest |logit| of the naive forward, by the reasoning
given for the WKV forward above: the two differ only by the attention's
fp32 rounding (relative 1e-5 or less) carried through 34 layers.

fp32 parity of the tensor-core kernels. The worst-case limits above
grant each output a multiple of a rounding budget that long rows and
large decays make wide, so a kernel that takes one tf32 product (11
significant bits, off by up to 2^-12 = 2,048 eps32 of each product)
where it should take three can stay inside them: the WKV limit rejected
such a control by only 1.0-1.4x on its outputs, and the attention limit
passes it on rows with hundreds of admitted keys. So ``wkv_chunked`` and
``flash_attention`` in fp32 are also held to the plain version's own
accuracy: the kernel's largest error against float64 must be at most P =
16 times the largest error against float64 of the plain version, run in
true fp32 on the card on the same inputs (TF32 off for PyTorch's
products, checked where the parity is taken), with a floor of eps32
max|want| so that an exact plain result divides nothing by zero. P is
argued from what differs between the two: (i) the order of the sums:
both sum in fp32 chains whose rounding error grows as the square root of
their length (the kernel's MMAs sum 8 products and the accumulator at a
time, the plain version's einsums in its library's order; the tensor
cores' own additions round toward zero, which biases a long chain, so
the flash kernel adds its Q K^T partial sums in fp32 outside them),
which moves the largest error of millions of outputs by up to about 2x;
(ii) the products: the plain version's are fp32 (exact within an FMA, or
rounded once, eps32 / 2); three tf32 products drop lo lo and read lo
with 11 significant bits, each part below 2^-22 of the product, so up to
3 * 2^-22 = 6 eps32 of each product, with signs that follow the data, as
a rounding's do: up to 6x on the products' share of the error; (iii) the
special-function unit: the WKV takes its logs and powers with lg2.approx
and ex2.approx (2 ulp) where the plain version takes torch.log and
torch.exp (1 ulp), up to 2x on the decay's share; the attention takes
expf, as the plain version does. At most 2 * 6 = 12 < P = 16 where the
three meet. One tf32 product errs by up to 2,048 eps32 of each product,
some 340 times three products' 6 eps32; on the CPU an emulation of it
(operands rounded to tf32 by their bits, as ``tf32`` does) erred
410-490x the plain version at the WKV's path shapes and 680-1,460x at a
gemma3-4b-like attention (B = 1, S = 1,024, Hq 2, Hkv 1, Dh 256, causal;
two emulations), so it fails parity by 25x or more. The controls
(``Smoke.wkv_tf32_only``, ``Smoke.flash_tf32_only``) must fail the limit
and parity together by at least 4x at the path's fp32 shapes; the
kernels must pass both. bf16 outputs take the worst-case limit alone:
their own rounding (one bf16 ulp, 2^16 eps32 of the value) is most of
both errors.

The serving logits in bf16 are held against the torch-level step (the
interpreter rung: a whole-array PyTorch attention) on the same inputs,
to 4 bf16 ulps of the row's largest |logit|. The two steps round
activations to bf16 at the same places except inside attention, where
the two sum in different orders, so an attention output may land on the
neighbouring bf16 value in each of the 30 layers; those flips reach the
logits through the rest of the step. fp32 is where the step is held
exactly: there the greedy streams must equal the dense loop's token for
token.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
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
#: an fp32 product on the tf32 tensor cores (495 TFLOP/s dense) as three
#: tf32 products (the WKV's and flash attention's fp32 route)
TF32X3_FLOP_PER_S = 495e12 / 3

#: see the module docstring
EPS32 = 2.0 ** -23
TOL_FACTOR = 4.0
LANES = 16384
MIN_CHAIN = 1024
#: fp32 parity: a tensor-core kernel's largest error against float64 at
#: most this many times its plain version's (see the module docstring)
PARITY = 16
#: a control must fail the limit and parity together by this much
CONTROL_MARGIN = 4.0
#: one bf16 ulp relative to the value it rounds (8 significant bits: up to
#: 2^-7 at the bottom of a binade); two bf16 roundings of nearly one value
#: may differ by that much
BF16_ULP = 2.0 ** -7

#: ragged bf16 matmul shapes (M, K, N) whose layouts TMA takes, held on the
#: wgmma route with B N-major and K-major (tests/test_torch_gpu.py holds the
#: same shapes)
WGMMA_SHAPES = [(1000, 520, 4104), (64, 64, 64), (4104, 256, 136)]

#: the TPU kernels the port's kernels replace (file:line of the function)
REPLACES = {
    "dot": "src/repro/kernels/dot/kernel.py:36",
    "axpydot": "src/repro/kernels/axpydot/kernel.py:46",
    "grid_kernel": "src/repro/codegen/pallas_backend.py:682",
    "two_phase": "src/repro/codegen/pallas_backend.py:894",
    "matmul": "src/repro/kernels/gemm/kernel.py:80",
    "stencil2d": "src/repro/kernels/stencil/kernel.py:59",
    "stencil2d_chain": "src/repro/kernels/stencil/kernel.py:120",
    "diffusion2d": "src/repro/kernels/stencil/kernel.py:164",
    "jacobi3d": "src/repro/kernels/stencil/kernel.py:197",
    "diffusion3d": "src/repro/kernels/stencil/kernel.py:228",
    "decode_attention": "src/repro/kernels/attention/decode.py:49",
    "wkv_chunked": "src/repro/kernels/rwkv/kernel.py:69",
    "flash_attention": "src/repro/kernels/attention/kernel.py:69",
}
SOURCES = {
    "dot": "src/repro_torch/csrc/dot.cu",
    "axpydot": "src/repro_torch/csrc/axpydot.cu",
    "grid_kernel": "src/repro_torch/codegen/cuda_backend.py",
    "two_phase": "src/repro_torch/codegen/cuda_backend.py",
    "matmul": "src/repro_torch/csrc/gemm.cu",
    "stencil2d": "src/repro_torch/csrc/stencil.cu",
    "stencil2d_chain": "src/repro_torch/csrc/stencil.cu",
    "diffusion2d": "src/repro_torch/csrc/stencil_star.cu",
    "jacobi3d": "src/repro_torch/csrc/stencil_star.cu",
    "diffusion3d": "src/repro_torch/csrc/stencil_star.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "wkv_chunked": "src/repro_torch/csrc/wkv.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}

#: the serving step's per-layer attention kernels (``attn{li}_grid_tiled``,
#: one generated row kernel a layer, identical but for the layer) are
#: measured and reported as one row
ATTN_RE = re.compile(r"attn\d+_grid_tiled")
ATTN_KEY = "attn*_grid_tiled"

#: bf16 serving logits are held against the torch-level step on the same
#: inputs to this many bf16 ulps of the row's largest |logit| (see the
#: module docstring)
BF16_TOL_ULPS = 4

#: positions in a WKV chunk, and the forward's fp32 logits held against the
#: same forward with the plain WKV to this share of the row's largest
#: |logit| (see the module docstring)
WKV_CHUNK = 16
FWD_LOGIT_TOL = 2.0 ** -12

#: the reference package's off-chip volumes in bytes (memlet analysis) of
#: LeNet-5 at batch 1,000 (naive, InputToConstant, + StreamingComposition)
#: and of the two-iteration diffusion over 131,072 x 4,096 (offloaded,
#: streamed); tests/test_torch_lenet.py and tests/test_torch_stencil.py
#: hold both packages to them
REF_LENET_VOLUMES = {"naive": 55_267_408, "const": 54_912_000,
                     "stream": 6_352_000}
REF_STENCIL_VOLUMES = {"offloaded": 12_884_901_968,
                       "streamed": 8_589_934_672}

#: the Fig.-19 stars: points a float64 oracle slab holds, the planes of D a
#: launch takes in the planted jacobi3d fault, and the flops a point as
#: ``benchmarks/stencil_bench.py`` counts them
SLAB_POINTS = 1 << 26
JACOBI_FAULT_PLANES = 4096
STAR_FLOPS = {"diffusion2d": 9, "jacobi3d": 8, "diffusion3d": 13}
#: the report names of the reference's Fig.-19 benchmark, in its order
#: (tests/test_torch_fig19.py holds the port's benchmark to the reference's)
FIG19_NAMES = ["stencil_diffusion2d_ms", "stencil_jacobi3d_ms",
               "stencil_diffusion3d_ms", "stencil_star_grid_ms",
               "stencil_star_grid_untiled_ms", "stencil_star_jnp_ms",
               "stencilflow_chain_ms"]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def chain_bound(n_terms: int) -> int:
    """L of the module docstring, for an output summed from n terms."""
    return max(MIN_CHAIN, n_terms // LANES)


def tf32(x):
    """fp32 ``x`` rounded to tf32 (10 explicit mantissa bits, to nearest)
    by its bit pattern, as the kernels' ``split`` rounds hi."""
    import torch
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1fff).view(torch.float32)


def tf32_einsum(eq, a, b, products=1):
    """``torch.einsum(eq, a, b)`` in fp32 with its operands on tf32: one
    product of the rounded operands (a kernel that takes one tf32 product),
    or three, hi hi + hi lo + lo hi of x = hi + lo with lo rounded to tf32
    too (the kernels' fp32 route)."""
    import torch
    a, b = a.float(), b.float()
    ah, bh = tf32(a), tf32(b)
    if products == 1:
        return torch.einsum(eq, ah, bh)
    return torch.einsum(eq, ah, tf32(b - bh)) + \
        torch.einsum(eq, tf32(a - ah), bh) + torch.einsum(eq, ah, bh)


def parity(got, plain, want):
    """(ok, ratio) of fp32 parity (module docstring): ``got``'s largest
    error against the float64 ``want`` over PARITY times ``plain``'s (at
    least eps32 max|want|); ok when the ratio is at most 1 and ``got`` is
    finite. The plain version's products must have run in true fp32."""
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32,
          "parity: PyTorch's fp32 products run in TF32")
    want = want.double()
    floor = EPS32 * float(want.abs().max())
    plain_err = max(float((plain.double() - want).abs().max()), floor)
    ratio = float((got.double() - want).abs().max()) / (PARITY * plain_err)
    return bool(torch.isfinite(got).all()) and ratio <= 1, ratio


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
        #: the Fig.-19 benchmark's sizes: the paper's domains unless
        #: ``fig19_small`` (the reference's small sizes)
        from repro_torch.benchmarks import stencil_bench
        self.fig19_small = False
        self.fig19_dom2d = stencil_bench.DOM2D
        self.fig19_dom3d = stencil_bench.DOM3D
        self.seed = 2026
        #: the serving slice: starcoder2-3b at full width and depth
        #: (``serve_layers`` None), the benchmark's 64 requests
        self.serve_arch = "starcoder2-3b"
        self.serve_config = None    # a ModelConfig overrides the arch's
        self.serve_requests = programs.SERVE_REQUESTS
        self.serve_state = None
        self.attn_layers = None
        #: the largest bucket's last step (B, ctx, inputs) and its logits,
        #: from a held-step run
        self.step_inputs = self.step_want = None
        #: the RWKV slice: rwkv6-7b at full width and depth (``rwkv_config``
        #: a ModelConfig overrides the arch's), forward on batch x seq
        #: tokens, the benchmark's requests
        self.rwkv_arch = "rwkv6-7b"
        self.rwkv_config = None
        self.rwkv_batch, self.rwkv_seq = 4, 1024
        self.rwkv_requests = programs.SERVE_REQUESTS
        self.rwkv_state = None
        self.wkv_ops = {}       # "forward"/"admission" -> the path's operands
        #: the gemma3-4b prefill: full width and depth (``gemma_config`` a
        #: ModelConfig overrides the arch's), forward on batch x seq tokens
        self.gemma_arch = "gemma3-4b"
        self.gemma_config = None
        self.gemma_batch, self.gemma_seq = 2, 4096
        #: "windowed"/"global" -> the first such layer's attention operands
        self.flash_ops = {}
        self.flash_calls = Counter()
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
        from repro_torch.kernels.dot import dot, dot_ref
        from repro_torch.kernels import build
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
                    # one block's share of the terms left out: block b
                    # takes every G-th run of 256 16-byte vectors
                    G, run = build.partial_blocks(x.device), 256 * 4
                    bad = x.clone()
                    full = n // (G * run) * (G * run)
                    bad[:full].view(-1, G, run)[:, -1] = 0
                    tail = bad[full:][(G - 1) * run:G * run]
                    tail.zero_()
                    dropped = full // G + tail.numel()
                    self.refused(fn(bad, w), want, norm2, n,
                                 f"dot N={n} without one block's share "
                                 f"({dropped} terms)")
                    del bad
                lib = (lambda: torch.dot(x, w)) if name == "dot" else \
                    (lambda: torch.dot(a * x + y, w))
                self.results[name] = {
                    "max_abs_err": err,
                    "ms": self.time_ms(lambda: fn(*args)),
                    "device_ms": self.device_ms(lambda: fn(*args)),
                    "plain_ms": self.time_ms(lambda: ref(*args)),
                    "library_ms": self.time_ms(lib),
                    "library_device_ms": self.device_ms(lib),
                    "bytes": sum(t.numel() * t.element_size()
                                 for t in args[-2 if name == "dot"
                                               else -3:]) + 4,
                    "ops": 2 * n if name == "dot" else 4 * n}
            del x, y, w
        rows += self.matmul_vs_plain()
        rows += self.stencils_vs_plain()
        rows += self.stars_vs_plain()
        rows += self.attention_vs_plain()
        rows += self.wkv_vs_plain()
        rows += self.flash_vs_plain()
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
        """The matmul kernels against their plain version and float64: odd
        shapes, the five LeNet shapes (B as the path passes it, a
        transposed weight view), ragged TMA-legal shapes with B N-major
        and K-major, every activation, fp32 and bf16, each launch on the
        route ``route`` names (bf16 at the TMA-legal shapes on wgmma,
        fp32 always on fma); one planted fault on each route; times at
        the path's shapes and at 4096^3."""
        torch = self.torch
        from repro_torch.kernels.gemm import matmul, matmul_ref
        from repro_torch.kernels.gemm.kernel import (K_TILE, WGMMA_K_TILE,
                                                     route)
        rows, timed = [], []
        # (layer, M, K, N, the path's activation, B as a W.T view)
        cases = [("odd", 300, 200, 150, None, False),
                 ("odd", 64, 1000, 32, None, False),
                 ("odd", 20000, 72, 40, None, False)]
        cases += [(*c, True) for c in self.lenet_matmuls()]
        cases += [("wgmma", M, K, N, None, t) for M, K, N in WGMMA_SHAPES
                  for t in (False, True)]
        for i, (layer, M, K, N, path_act, wt) in enumerate(cases):
            for dt in (torch.float32, torch.bfloat16):
                a = self.randn(M, K, dtype=dt, seed=100 + i)
                b = self.randn(N, K, dtype=dt, seed=200 + i)
                b = b.T if wt else b.reshape(K, N)
                bias = self.randn(N, seed=300 + i)
                out_rel = BF16_ULP if dt == torch.bfloat16 else 0.0
                which = route(a, b)
                if dt == torch.float32 or layer == "wgmma":
                    check(which == ("fma" if dt == torch.float32
                                    else "wgmma"),
                          f"matmul {layer} {M}x{K}x{N} {dt}: route {which}")
                for act in (None, "relu", "silu", "gelu"):
                    before = matmul.routes[which]
                    got = matmul(a, b, bias, activation=act)
                    check(matmul.routes[which] == before + 1,
                          f"matmul {layer} {M}x{K}x{N} {dt}: not launched "
                          f"on the {which} route")
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
                                 "b_layout": "K-major" if wt else "N-major",
                                 "route": which, "act": act,
                                 "max_abs_err": err, "err_vs_f64": err64,
                                 "x_limit": ratio})
                    # the planted faults: conv2 in fp32 (fma) and the
                    # K = 256 W.T product in bf16 (wgmma) without the
                    # last K tile of their route
                    if act == "relu" and wt and (
                            (layer, dt) == ("conv2", torch.float32) or
                            (layer, dt, K) == ("wgmma", torch.bfloat16,
                                               256)):
                        tile = K_TILE if which == "fma" else WGMMA_K_TILE
                        keep = (K - 1) // tile * tile
                        a_cut, b_cut = a[:, :keep], b[:keep]
                        check(route(a_cut, b_cut) == which,
                              f"the planted {which} fault takes "
                              f"{route(a_cut, b_cut)}")
                        self.refused(
                            matmul(a_cut, b_cut, bias, activation=act),
                            want, norm2, K,
                            f"matmul ({which}) {M}x{K}x{N} {dt} without "
                            f"its last {K - keep}-column K tile", chain=K,
                            out_rel=out_rel)
                if layer not in ("odd", "wgmma") and dt == torch.float32:
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
               for k in ("ms", "device_ms", "plain_ms", "library_ms",
                         "library_device_ms", "bound_ms")},
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "measured_on": "the five matmul launches of one LeNet-5 "
                           f"forward at batch {self.lenet_batch}, summed",
            "shapes": timed}
        return rows

    def device_ms(self, fn, reps=10):
        """The card's own time for one call of ``fn``: ``reps`` calls
        captured in one CUDA graph, replayed between two CUDA events, the
        best of three replays over ``reps``. No host time (unlike
        ``time_ms``'s CUDA events around the Python call): the graph's
        kernels run back to back, about a microsecond apart. The warm-up
        call runs on the capture stream, outside the capture, so that
        what a wrapper keeps per stream exists before it."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
        graph.replay()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        check(min(times) > 0, "the replayed graph took no time on the card")
        return min(times) / reps

    def time_matmul(self, layer, a, b, bias, act, err):
        """Times of the kernel (CUDA events around the wrapper call, and
        its device time, ``device_ms``), its plain version and one
        PyTorch call (``addmm`` or ``matmul``, then the activation) on
        these operands, and the least time the card could take (bytes at
        the memory rate, 2 M N K operations at fp32's FMA or bf16's
        tensor-core peak)."""
        torch = self.torch
        from repro_torch.kernels.gemm import matmul, matmul_ref
        from repro_torch.kernels.gemm.kernel import route
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

        def kernel():
            return matmul(a, b, bias, activation=act)

        return {"layer": layer, "shape": [M, K, N], "dtype": str(a.dtype),
                "route": route(a, b), "act": act, "max_abs_err": err,
                "ms": self.time_ms(kernel),
                "device_ms": self.device_ms(kernel),
                "plain_ms": self.time_ms(lambda: matmul_ref(
                    a, b, bias, activation=act)),
                "library_ms": self.time_ms(library),
                "library_device_ms": self.device_ms(library),
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
        stencil2d_chain (2, 3 and 6 stages of mixed radii; a halo of 60
        that forces the smallest tile) against their plain versions and
        float64, on both load routes (W = 515 and 777 take cp.async, W a
        multiple of 4 TMA), each repeated byte for byte; halos of 110 (one
        stage) and 75 (a chain) that take one slab; the paper's domain
        with the diffusion taps, timed; one planted fault there. Then a
        field with an inf and a NaN: the same outputs non-finite as in the
        plain version, the rest within its limit."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch import programs
        from repro_torch.kernels.stencil import (stencil2d, stencil2d_chain,
                                                 stencil2d_chain_ref,
                                                 stencil2d_ref)
        from repro_torch.kernels.stencil.kernel import layout, route
        diff = programs.DIFFUSION_OFFSETS
        skew = ((0, 0), (-2, 1), (1, 2), (2, -1), (0, -2), (-1, -1))
        wide = ((0, 0), (-2, 0), (2, 0), (0, -2), (0, 2))
        far = ((0, 0), (-10, 0), (10, 0), (3, -7))
        far1 = ((0, 0), (-110, 3), (110, -5))
        far2 = (((0, 0), (-37, 2), (37, 0)), ((1, 0), (0, 38), (-3, -38)))
        H, W = self.stencil_domain
        cases = [("stencil2d", (1009, 777), (skew,)),
                 ("stencil2d_chain", (1009, 515), (diff, skew)),
                 ("stencil2d_chain", (997, 1024), (wide, diff, skew)),
                 ("stencil2d_chain", (1013, 515), (diff, skew) * 3),
                 ("stencil2d_chain", (331, 300), (far,) * 6),
                 ("stencil2d", (211, 300), (far1,)),
                 ("stencil2d_chain", (97, 515), far2),
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
            what = f"{name} {h}x{w} {len(stages)} stage(s)"
            check(torch.equal(fn(a), got), f"{what}: repeat runs differ")
            want, norm2 = self.stencil_terms(a, coeffs, stages)
            n_terms = sum(len(o) for o in stages)
            err, _ = self.close(got, plain, norm2, n_terms, f"{what} vs plain")
            err64, ratio = self.close(got, want, norm2, n_terms,
                                      f"{what} vs float64")
            rows.append({"kernel": name, "shape": [h, w],
                         "taps": [len(o) for o in stages],
                         "tile": [layout(stages)["th"],
                                  layout(stages)["tw"]],
                         "slabs": layout(stages)["n_slabs"],
                         "load_route": route(a),
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
        a = self.randn(1009, 777, seed=590)
        a[10, 10], a[20, 30], a[40, 7] = math.inf, -math.inf, math.nan
        stages = (diff, skew)
        coeffs = [0.3 * self.randn(len(o), seed=591 + s)
                  for s, o in enumerate(stages)]
        got = stencil2d_chain(a, coeffs, stages)
        plain = stencil2d_chain_ref(a, coeffs, stages)
        fin = plain.isfinite()
        check(torch.equal(got.isnan(), plain.isnan()) and
              torch.equal(got.isinf(), plain.isinf()) and
              torch.equal(got[~fin & ~plain.isnan()],
                          plain[~fin & ~plain.isnan()]),
              "stencil2d_chain with an inf and a NaN: the non-finite "
              "outputs differ from the plain version's")
        x = a.masked_fill(~a.isfinite(), 0.0)
        _, norm2 = self.stencil_terms(x, coeffs, stages)
        err, ratio = self.close(got[fin], plain[fin], norm2[fin], 11,
                                "stencil2d_chain with an inf and a NaN, "
                                "finite outputs vs plain")
        rows.append({"kernel": "stencil2d_chain", "shape": [1009, 777],
                     "taps": [5, 6], "non_finite": int((~fin).sum()),
                     "load_route": route(a), "max_abs_err": err,
                     "x_limit": ratio})
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
        from repro_torch.kernels.stencil.kernel import route
        return {"max_abs_err": err, "load_route": route(a),
                "ms": self.time_ms(lambda: fn(a)),
                "device_ms": self.device_ms(lambda: fn(a)),
                "plain_ms": self.time_ms(lambda: ref(a), reps=3, warmup=1),
                "library_ms": self.time_ms(library),
                "library_device_ms": self.device_ms(library, reps=3),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "shapes": [{"shape": [h, w], "taps": [len(o) for o in stages]}]}

    # -- the Fig.-19 stars ------------------------------------------------
    def slab_within(self, got, a, oracle, halo, n_terms, against=None):
        """(ok, max |got - want|, worst ratio to the limit) of ``got`` under
        the module docstring's tolerance, the float64 oracle computed slab
        by slab along the first axis (``SLAB_POINTS`` a slab, ``halo`` rows
        or planes beyond it, 0 outside the field); ``against``, if given,
        is what ``got`` is held to instead of the oracle's result (with the
        oracle's 2-norms)."""
        torch = self.torch
        n = a.shape[0]
        step = max(1, SLAB_POINTS // max(1, a[0].numel()))
        ok, err, ratio = True, 0.0, 0.0
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            lo, hi = r0 - halo, r1 + halo
            x = torch.zeros((hi - lo,) + tuple(a.shape[1:]),
                            dtype=torch.float64, device=a.device)
            x[max(lo, 0) - lo:min(hi, n) - lo] = a[max(lo, 0):min(hi, n)]
            rows = torch.arange(lo, hi, device=a.device)
            keep = slice(halo, halo + r1 - r0)
            want = oracle(x, rows, False)[keep]
            norm2 = oracle(x * x, rows, True)[keep].sqrt()
            o, e, r = self.within(got[r0:r1], want if against is None
                                  else against[r0:r1], norm2, n_terms)
            ok, err, ratio = ok and o, max(err, e), max(ratio, r)
            del x, want, norm2
        return ok, err, ratio

    def held(self, result, what):
        """Check a ``slab_within`` result; returns (max error, ratio)."""
        ok, err, ratio = result
        check(ok, f"{what}: |got-want| up to {err:.3e}, {ratio:.3g} x its "
                  f"limit (or non-finite values)")
        return err, ratio

    def planted(self, result, what):
        """Check that a planted fault's ``slab_within`` result fails."""
        ok, err, ratio = result
        check(not ok, f"planted fault {what} passed the tolerance "
                      f"({ratio:.3g} x its limit)")
        self.faults.append({"fault": what, "max_abs_err": err,
                            "x_limit": ratio})

    def star_cases(self):
        """(kernel, shape, params) of ``stars_vs_plain``: tiny, odd and the
        reference tests' shapes, then the Fig.-19 benchmark's (the path's)."""
        from repro_torch.benchmarks import stencil_bench as fig19
        co = fig19.COEFFS
        odd2 = [(1, 1), (67, 129), (64, 48), (65, 33), (1009, 777),
                (97, 4099)]
        odd3 = [(1, 1, 1), (17, 13, 11), (5, 33, 7), (16, 12, 10),
                (97, 130, 67), (65, 9, 4099)]
        cases = [("diffusion2d", s, co) for s in odd2]
        cases += [(k, s, p) for s in odd3 for k, p in
                  (("jacobi3d", None), ("diffusion3d", 0.37))]
        cases += [("diffusion2d", self.fig19_dom2d, co),
                  ("jacobi3d", self.fig19_dom3d, None),
                  ("diffusion3d", self.fig19_dom3d, fig19.ALPHA)]
        return cases

    def stars_vs_plain(self):
        """diffusion2d, jacobi3d and diffusion3d against their plain
        versions and float64 at odd shapes and the path's, byte-identical
        repeats; two planted faults at the path's shapes; times there."""
        torch = self.torch
        from repro_torch.kernels import stencil
        rows = []
        for i, (kind, shape, params) in enumerate(self.star_cases()):
            a = self.randn(*shape, seed=700 + i)
            fn = getattr(stencil, kind)
            plain_fn = getattr(stencil, f"{kind}_ref")
            args = () if params is None else (params,)
            got, again, plain = fn(a, *args), fn(a, *args), plain_fn(a, *args)
            torch.cuda.synchronize()
            what = f"{kind} {'x'.join(map(str, shape))}"
            check(torch.equal(got, again), f"{what}: repeat runs differ")
            n_terms = 5 if kind == "diffusion2d" else 7
            oracle = star_oracle(kind, shape[0], params)
            err, _ = self.held(self.slab_within(
                got, a, oracle, 1, n_terms, against=plain), f"{what} vs plain")
            err64, ratio = self.held(self.slab_within(
                got, a, oracle, 1, n_terms), f"{what} vs float64")
            self.held(self.slab_within(plain, a, oracle, 1, n_terms),
                      f"{what}: plain vs float64")
            rows.append({"kernel": kind, "shape": list(shape),
                         "params": params, "max_abs_err": err,
                         "err_vs_f64": err64, "x_limit": ratio,
                         "bitwise_equal_plain": bool(torch.equal(got, plain))})
            del again, plain
            path = shape in (self.fig19_dom2d, self.fig19_dom3d)
            if path and kind == "diffusion2d":
                # up and down exchanged
                c0, c1, c2, c3, c4 = params
                self.planted(self.slab_within(
                    fn(a, (c0, c2, c1, c3, c4)), a, oracle, 1, n_terms),
                    f"{what} with c1 and c2 exchanged")
            if path and kind == "jacobi3d":
                # each slab of planes alone: its edge planes lose a neighbour
                step = JACOBI_FAULT_PLANES
                bad = torch.cat([fn(a[s:s + step])
                                 for s in range(0, shape[0], step)])
                self.planted(self.slab_within(bad, a, oracle, 1, n_terms),
                             f"{what} launched {step} planes at a "
                             f"time")
                del bad
            if path:
                self.results[kind] = self.time_star(kind, a, params, err)
            del a, got
        return rows

    def time_star(self, kind, a, params, err):
        """Times of a Fig.-19 kernel, its plain version and one PyTorch call
        (F.conv2d with the five taps in a 3 x 3 weight, F.conv3d with the
        seven in a 3 x 3 x 3 one; padding 1, TF32 off), and its bound: the
        field read once and written once."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import stencil
        args = () if params is None else (params,)
        fn, plain_fn = getattr(stencil, kind), getattr(stencil, f"{kind}_ref")
        if kind == "diffusion2d":
            c0, c1, c2, c3, c4 = params
            k = torch.tensor([[0.0, c1, 0.0], [c3, c0, c4], [0.0, c2, 0.0]],
                             device=a.device)[None, None]

            def library():
                return F.conv2d(a[None, None], k, padding=1)
        else:
            wc, wn = (1 / 7, 1 / 7) if kind == "jacobi3d" else \
                (1 - 6 * params, params)
            k = torch.zeros(1, 1, 3, 3, 3, device=a.device)
            k[0, 0, 1, 1, 1] = wc
            for d in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                      (1, 1, 2)):
                k[(0, 0) + d] = wn

            def library():
                return F.conv3d(a[None, None], k, padding=1)
        t_bytes = 2 * a.numel() * a.element_size() / HBM_BYTES_PER_S * 1e3
        t_ops = STAR_FLOPS[kind] * a.numel() / FP32_FLOP_PER_S * 1e3
        return {"max_abs_err": err, "ms": self.time_ms(lambda: fn(a, *args)),
                "device_ms": self.device_ms(lambda: fn(a, *args)),
                "plain_ms": self.time_ms(lambda: plain_fn(a, *args), reps=3,
                                         warmup=1),
                "library_ms": self.time_ms(library),
                "library_device_ms": self.device_ms(library, reps=3),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "shapes": [{"shape": list(a.shape), "params": params}]}

    def stencil_fig19(self):
        """The port's Fig.-19 benchmark (``stencil_bench.run``) at the
        paper's domains: its report lines, in the reference's order; the
        kernels it launched (the three stars, the fused chain, and the
        star's tiled and 1-element-block grid kernels, nothing else); every
        output held to float64 slab by slab; the phase's peak device
        memory. Frees its fields before the serving phases."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.benchmarks import stencil_bench as fig19
        from repro_torch.codegen import cuda_backend as cb
        lines = []

        def report(name, value, derived="", backend="cuda", **extra):
            print(f"# {name},{value:.6g},{derived}", flush=True)
            lines.append({"name": name, "value": value, "derived": derived,
                          "backend": backend, **extra})

        def grid_counts():
            return Counter(cb.run_grid_kernel.launches_by_name) + \
                Counter(cb.run_two_phase.launches_by_name)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        hand0, grid0 = hand_counts(), grid_counts()
        res = fig19.run(report, small=self.fig19_small, device=self.dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        hand, grid = hand_counts() - hand0, grid_counts() - grid0
        check([ln["name"] for ln in lines] == FIG19_NAMES,
              f"fig19 report names {[ln['name'] for ln in lines]}")
        check(set(hand) == {"diffusion2d", "jacobi3d", "diffusion3d",
                            "stencil2d_chain"},
              f"fig19 hand kernels launched {dict(hand)}")
        check(set(grid) == {"star_tiled", "star"} and
              grid["star_tiled"] == grid["star"],
              f"fig19 grid kernels launched {dict(grid)}")
        ch = res["chain"]
        check(ch["fused"] == ["Stencil+Stencil"],
              f"fig19 chain fused regions {ch['fused']}")
        if not self.fig19_small:
            check(tuple(ch["volumes"]) == tuple(REF_STENCIL_VOLUMES.values()),
                  f"fig19 chain volumes {ch['volumes']}")
        x_limit = {}
        d2, j3, d3, st = (res[k] for k in ("diffusion2d", "jacobi3d",
                                           "diffusion3d", "star"))
        for name, got, a, kind, params, halo, n_terms in (
                ("diffusion2d", d2["out"], d2["a"], "diffusion2d",
                 d2["coeffs"], 1, 5),
                ("jacobi3d", j3["out"], j3["a"], "jacobi3d", None, 1, 7),
                ("diffusion3d", d3["out"], d3["a"], "diffusion3d",
                 d3["alpha"], 1, 7),
                ("star_tiled", st["tiled"], st["a"], "star", None, 1, 5),
                ("star", st["untiled"], st["a"], "star", None, 1, 5),
                ("chain", ch["out"], ch["a"], "chain", ch["coeffs"], 2, 10)):
            oracle = star_oracle(kind, a.shape[0], params)
            _, x_limit[name] = self.held(
                self.slab_within(got, a, oracle, halo, n_terms),
                f"fig19 {name} {'x'.join(map(str, a.shape))} vs float64")
        shapes = {k: list(res[k]["a"].shape) for k in res}
        del res, d2, j3, d3, st, ch
        torch.cuda.empty_cache()
        return {"report": [{k: v for k, v in ln.items()} for ln in lines],
                "shapes": shapes, "launches": {**dict(hand), **dict(grid)},
                "x_limit": x_limit, "peak_mem_gb": peak / 1e9,
                "held_before_gb": start / 1e9,
                "star_n": programs.STAR_N}

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
        kernel once per call, bf16 on the wgmma route, fp32 on the fma
        route; against float64."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.kernels.gemm import matmul
        n = self.gemm_n
        out = {}
        for dt in ("float32", "bfloat16"):
            c = programs.gemm.lower(n=n, dtype=dt).compile("cuda", cache=None)
            check(c.report["expansions"] == ["gemm0->cuda"],
                  f"gemm {dt}: expansions {c.report['expansions']}")
            A = self.randn(n, n, dtype=getattr(torch, dt), seed=64)
            B = self.randn(n, n, dtype=getattr(torch, dt), seed=65)
            which = "wgmma" if dt == "bfloat16" else "fma"
            before = matmul.routes[which]
            got = self.run(c, hand={"matmul": 1}, A=A, B=B)["C"]
            check(matmul.routes[which] == before + 1,
                  f"gemm {dt}: the launch did not take the {which} route")
            check(got.dtype == A.dtype, f"gemm {dt}: output {got.dtype}")
            want, norm2 = self.matmul_terms(A, B)
            err, ratio = self.close(
                got, want, norm2, n, f"gemm {n}^3 {dt}", chain=n,
                out_rel=BF16_ULP if dt == "bfloat16" else 0.0)
            out[dt] = {"route": which, "max_abs_err": err, "x_limit": ratio}
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

    # -- the serving slice: decode attention and the paged-KV path ---------
    def attn_inputs(self, B, C, H, Dh, dtype, seed, most_masked=False):
        torch = self.torch
        q = self.randn(B, H, Dh, dtype=dtype, seed=seed)
        k = self.randn(B, C, H, Dh, dtype=dtype, seed=seed + 1)
        v = self.randn(B, C, H, Dh, dtype=dtype, seed=seed + 2)
        g = torch.Generator(device=self.dev).manual_seed(self.seed + seed)
        hi = max(1, C // 16) if most_masked else C
        pos = torch.randint(0, hi, (B,), generator=g, device=self.dev)
        return q, k, v, pos.to(torch.int32)

    def attn_terms(self, q, k, v, pos, window):
        """Float64 decode attention and the magnitudes of the attention
        tolerance (module docstring): per (b, h) the largest |score| term
        sum T and per output A = sum_j p_j |v_j|."""
        torch = self.torch
        q64, k64, v64 = q.double(), k.double(), v.double()
        C, Dh = k.shape[1], q.shape[-1]
        scale = 1.0 / math.sqrt(Dh)
        s = torch.einsum("bhd,bchd->bhc", q64, k64) * scale
        j = torch.arange(C, device=q.device)[None, None, :]
        p_ = pos.long()[:, None, None]
        mask = j <= p_
        if window is not None:
            mask &= j > p_ - window
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                              device=s.device))
        p = torch.softmax(s, dim=-1)
        want = torch.einsum("bhc,bchd->bhd", p, v64)
        t = torch.einsum("bhd,bchd->bhc", q64.abs(), k64.abs()) * scale
        tmax = torch.where(mask, t, torch.zeros_like(t)).amax(-1)
        a = torch.einsum("bhc,bchd->bhd", p, v64.abs())
        return want, tmax, a

    def attn_within(self, got, want, tmax, a, C, Dh, out_rel):
        """(ok, max error, worst ratio) under the attention tolerance."""
        torch = self.torch
        limit = TOL_FACTOR * EPS32 * (
            2 * math.sqrt(Dh) * tmax[..., None] + math.sqrt(C) + 1) * a \
            + out_rel * want.abs()
        err = (got.double() - want).abs()
        ok = bool(torch.isfinite(got).all()) and not bool((err > limit).any())
        return ok, float(err.max()), float((err / (limit + 1e-300)).max())

    def attention_vs_plain(self):
        """decode_attention against its plain version and float64 at odd
        shapes, the serving shapes, a long context, a sliding window and
        mostly-masked buckets; a mask that admits one unwritten position
        (the kernel run with pos + 1) must fail the tolerance."""
        torch = self.torch
        from repro_torch.kernels.attention import (decode_attention,
                                                   decode_attention_ref)
        bf, f32 = torch.bfloat16, torch.float32
        cases = [("odd", 3, 40, 5, 64, None, f32, False),
                 ("odd", 3, 40, 5, 64, None, bf, False),
                 ("serving", 64, 48, 24, 128, None, bf, False),
                 ("serving", 64, 48, 24, 128, None, f32, False),
                 ("long", 8, 4096, 24, 128, None, bf, False),
                 ("window", 4, 2048, 8, 256, 1024, bf, False),
                 ("mostly_masked", 64, 512, 24, 128, None, bf, True)]
        rows = []
        for i, (what, B, C, H, Dh, win, dt, masked) in enumerate(cases):
            q, k, v, pos = self.attn_inputs(B, C, H, Dh, dt, 100 + 10 * i,
                                            masked)
            got = decode_attention(q, k, v, pos, window=win)
            again = decode_attention(q, k, v, pos, window=win)
            plain = decode_attention_ref(q, k, v, pos, win)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"decode_attention {what}: "
                                           f"repeat runs differ")
            want, tmax, a = self.attn_terms(q, k, v, pos, win)
            out_rel = BF16_ULP if dt == bf else 0.0
            name = f"decode_attention {what} B={B} C={C} H={H} Dh={Dh} " \
                   f"window={win} {dt}"
            ok, err, _ = self.attn_within(got, plain.double(), tmax, a, C,
                                          Dh, 2 * out_rel)
            check(ok, f"{name} vs plain: |got-want| up to {err:.3e}")
            ok, err64, ratio = self.attn_within(got, want, tmax, a, C, Dh,
                                                out_rel)
            check(ok, f"{name} vs float64: |got-want| up to {err64:.3e}")
            ok, _, _ = self.attn_within(plain, want, tmax, a, C, Dh, out_rel)
            check(ok, f"{name}: plain vs float64")
            rows.append({"kernel": "decode_attention", "case": what,
                         "shape": [B, C, H, Dh], "window": win,
                         "dtype": str(dt), "max_abs_err": err,
                         "err_vs_f64": err64, "x_limit": ratio})
            if what == "serving" and dt == bf:
                # slot pos + 1 holds nonzero (random) K/V, never written by
                # the sequence: a mask that admits it must fail
                self.attn_fault = (q, k, v, pos)
                bad = decode_attention(q, k, v, pos + 1)
                ok, err, ratio = self.attn_within(bad, want, tmax, a, C, Dh,
                                                  out_rel)
                check(not ok, f"planted fault decode_attention with pos + 1 "
                              f"passed the tolerance ({ratio:.3g} x)")
                self.faults.append({
                    "fault": f"decode_attention {what}: the mask admits "
                             f"slot pos + 1", "max_abs_err": err,
                    "x_limit": ratio})
            del q, k, v, got, again, plain, want, tmax, a
        return rows

    def serving_model(self):
        """starcoder2-3b at full width and depth with seeded random weights
        from the port's init (fp32 parameters, as the config says), on
        the card, and the benchmark's prompts."""
        torch = self.torch
        if self.serve_state is not None:
            return self.serve_state
        from repro_torch import programs
        from repro_torch.configs import get_config
        from repro_torch.models import TransformerLM
        cfg = self.serve_config or get_config(self.serve_arch)
        model = TransformerLM(cfg)
        t0 = time.perf_counter()
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        params = model.init(g)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gc = torch.Generator().manual_seed(self.seed)
        prompts = torch.randint(0, cfg.vocab, (self.serve_requests,
                                               programs.SERVE_PROMPT),
                                generator=gc).tolist()
        self.serve_state = (model, params, prompts, init_s)
        return self.serve_state

    def scheduler(self, model, params, n_requests=None, **kw):
        from repro_torch import programs
        from repro_torch.serving import Scheduler
        # serve_bench's page count: a request's worst case plus one, and
        # the null page
        per = (programs.SERVE_PROMPT + programs.SERVE_NEW_TOKENS) \
            // programs.SERVE_PAGE_SIZE + 1
        n_requests = n_requests or self.serve_requests
        return Scheduler(model, params, max_slots=programs.SERVE_MAX_SLOTS,
                         page_size=programs.SERVE_PAGE_SIZE,
                         n_pages=n_requests * per + 1,
                         max_model_len=programs.SERVE_MAX_MODEL_LEN,
                         prefill_chunk=programs.SERVE_PROMPT,
                         device=self.dev, **kw)

    def checked(self, sched, compare, names):
        """Wrap the scheduler's compiler: every bucket compiles at the grid
        rung with ``names`` as its grid kernels (none of the attention
        scopes falling back), and each step launches each of them once and
        no other; with ``compare``, the torch-level step (the interpreter
        rung) runs first on copies of the same inputs and the step's bf16
        logits are held to it, and the largest bucket's last step is kept
        in ``step_inputs``/``step_want``. Returns the seconds each bucket
        took to compile and a one-element list holding the worst ratio of
        the logits' error to its limit."""
        torch = self.torch
        from repro_torch.codegen import cuda_backend as cb
        comp = sched.compiler
        step_for = comp.step_for
        compile_s = {}
        worst = [0.0]

        def wrapped_step_for(B, ctx):
            fresh = (B, ctx) not in comp._steps
            t0 = time.perf_counter()
            step = step_for(B, ctx)
            if fresh:
                torch.cuda.synchronize()
                compile_s[f"{B}x{ctx}"] = time.perf_counter() - t0
            rep = step.report
            check(step.rung == "grid", f"bucket {(B, ctx)} runs at rung "
                                       f"{step.rung!r}")
            check(rep["grid_kernels"] == names,
                  f"bucket {(B, ctx)}: grid kernels {rep['grid_kernels']}")
            attn_off = [m for m, _ in rep["grid_fallbacks"] +
                        rep["grid_skipped"] if m.startswith("attn")]
            check(not attn_off, f"bucket {(B, ctx)}: attention scopes "
                                f"not converted: {attn_off}")

            def run(kwargs):
                ref = keep = None
                if compare:
                    keep = {k: (v.clone() if k in step.donate_names
                                else v) for k, v in kwargs.items()}
                    ref = comp.fallback_for(B, ctx)(keep)["logits"]
                before = Counter(cb.run_grid_kernel.launches_by_name)
                res = step(kwargs)
                moved = Counter(cb.run_grid_kernel.launches_by_name) - before
                check(moved == Counter(names), f"step launches {dict(moved)}")
                if compare:
                    got, want = res["logits"].double(), ref.double()
                    lim = BF16_TOL_ULPS * BF16_ULP * \
                        want.abs().amax(-1, keepdim=True)
                    ratio = float(((got - want).abs() / lim).max())
                    worst[0] = max(worst[0], ratio)
                    check(bool(torch.isfinite(got).all()) and ratio <= 1,
                          f"bucket {(B, ctx)}: logits off the torch-level "
                          f"step by {ratio:.3g} x the limit")
                    if self.step_inputs is None or \
                            ctx >= self.step_inputs[1]:
                        self.step_inputs = (B, ctx, keep)
                        self.step_want = res["logits"]
                return res
            return _StepView(step, run)

        comp.step_for = wrapped_step_for
        return compile_s, worst

    def finish(self, sched, reqs, n_requests, new):
        """The run's checks: every request served to its last token with a
        typed finish reason, no rung of the degradation ladder fired."""
        from repro_torch.serving import FINISH_REASONS
        sched.check_invariants()
        st = sched.stats()
        check(len(reqs) == n_requests and all(
            r.finish_reason in FINISH_REASONS for r in reqs),
            f"finish reasons {st['finish_reasons']}")
        # a straggler is a slow step (a bucket's first step compiles its
        # generated kernels), not a fault; anything else the watchdog logs
        # is
        faults = [e for e in st["watchdog_events"]
                  if e["kind"] != "straggler"]
        check(st["fallback_steps"] == 0 and st["recomputes"] == 0 and
              not st["compiler_events"] and not faults,
              f"the degradation ladder fired: {st}")
        check(all(len(r.tokens_out) == new for r in reqs),
              "a request ended early")
        return st

    def timed(self, sched, prompts, new):
        """Serve ``prompts`` once more, timed: tokens/s over the summed time
        of the run's decode steps, p50/p99 token latency, peak memory."""
        torch = self.torch
        for p in prompts:
            sched.submit(p, new)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reqs = sched.run()
        wall = time.perf_counter() - t0
        stats = self.finish(sched, reqs, len(prompts), new)
        steady = [t for r in reqs for t in r.token_times[3:]]
        med = statistics.median(steady)
        ntok = sum(len(r.tokens_out) for r in reqs)
        q = statistics.quantiles(steady, n=100)
        # every decode step of the run, stalls included: its duration as
        # the scheduler timed it (call to synchronised logits on the host)
        decode_s = sum(sched.watchdog.monitor.durations)
        decode_tokens = ntok - len(reqs)    # the first comes from prefill
        return {
            "requests": len(reqs), "tokens": ntok,
            "decode_steps": sched.n_decode_steps,
            "decode_tokens": decode_tokens, "decode_seconds": decode_s,
            "tokens_per_s": decode_tokens / decode_s,
            "tokens_per_s_wall": ntok / wall, "wall_s": wall,
            "p50_token_ms": med * 1e3, "p99_token_ms": q[98] * 1e3,
            "finish_reasons": stats["finish_reasons"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    def serve_starcoder2(self):
        """The Scheduler answers the benchmark's 64 requests three times:
        in fp32 (streams token-identical to the dense decode_step loop),
        in bf16 with every compiled step held against the torch-level
        step on the same inputs, and in bf16 timed. Every bucket's report
        lists one attn grid kernel per layer, each launched once a step,
        no fallback."""
        from repro_torch import programs
        from repro_torch.pipeline.cache import CompilationCache
        model, params, prompts, init_s = self.serving_model()
        cfg = model.cfg
        L = self.attn_layers = cfg.n_layers
        new = programs.SERVE_NEW_TOKENS
        attn_names = [f"attn{li}_grid_tiled" for li in range(L)]
        out = {"arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
               "param_init_seconds": init_s,
               "n_params": sum(p.numel() for p in _leaves(params))}

        # 1. fp32: streams against the dense decode_step loop
        cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
        from repro_torch.models import TransformerLM
        m32 = TransformerLM(cfg32)
        s32 = self.scheduler(m32, params, cache_dtype="float32",
                             compile_cache=CompilationCache())
        c32, _ = self.checked(s32, False, attn_names)
        for p in prompts:
            s32.submit(p, new)
        reqs = s32.run()
        self.finish(s32, reqs, len(prompts), new)
        dense = self.dense_greedy(m32, params, prompts, new)
        same = sum(r.tokens_out == d for r, d in zip(reqs, dense))
        check(same == len(reqs), f"fp32 streams: {same} of {len(reqs)} "
                                 f"equal the dense decode_step loop")
        out["fp32"] = {"streams_equal_dense": same,
                       "compile_seconds": c32,
                       "decode_steps": s32.n_decode_steps,
                       "slow_steps": s32.stats()["watchdog_events"]}
        del s32, reqs, dense

        # 2. bf16, each step held against the torch-level step
        cc = CompilationCache()
        sb = self.scheduler(model, params, compile_cache=cc)
        self.step_inputs = None
        cbf, worst = self.checked(sb, True, attn_names)
        for p in prompts:
            sb.submit(p, new)
        self.finish(sb, sb.run(), len(prompts), new)
        out["bf16_checked"] = {"compile_seconds": cbf,
                               "logits_x_limit": worst[0],
                               "decode_steps": sb.n_decode_steps,
                               "slow_steps": sb.stats()["watchdog_events"]}
        del sb

        # 3. bf16 timed (the buckets compiled above: cache hits)
        st = self.scheduler(model, params, compile_cache=cc)
        self.checked(st, False, attn_names)
        out["bf16_timed"] = self.timed(st, prompts, new)
        out["step_profile"] = self.profile_step(st.compiler)
        return out

    def profile_step(self, compiler, steps=3, attention=True):
        """Where one decode step's time goes: the largest bucket's step run
        ``steps`` times on the scheduler's inputs under torch.profiler —
        wall time a step (host clock, synchronised), device busy time (the
        sum of the card's kernel times), the idle share, the attention row
        kernels' time (``attention``) and the device kernels by time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        B, ctx, kwargs = self.step_inputs
        step = compiler.step_for(B, ctx)
        pages = {k: v for k, v in kwargs.items() if k in step.donate_names}

        def fresh():
            kw = dict(kwargs)
            kw.update({k: v.clone() for k, v in pages.items()})
            return kw

        def run(kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        plain = [run(fresh()) for _ in range(steps + 1)][1:]
        inputs = [fresh() for _ in range(steps)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for kw in inputs:
                run(kw)
        # the card's own kernel events (not the CPU ops that launched them)
        kernels = [e for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        by_name = Counter()
        calls = Counter()
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
        busy_ms = sum(by_name.values()) / 1e3 / steps
        wall_ms = statistics.median(plain) * 1e3
        out = {"bucket": [B, ctx], "wall_ms": wall_ms,
               "device_busy_ms": busy_ms,
               "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
               "kernels_per_step": len(kernels) / steps,
               "top_device_kernels": [
                   {"name": n[:80], "ms_per_step": t / 1e3 / steps,
                    "calls_per_step": calls[n] / steps}
                   for n, t in by_name.most_common(8)]}
        if attention:
            # the attention row kernels share one Triton function, named
            # by its code
            attn_fn = self.captured[ATTN_KEY][0].desc.fn
            out["attention_kernels_ms"] = sum(
                t for n, t in by_name.items()
                if n.startswith(attn_fn)) / 1e3 / steps
        return out

    def dense_greedy(self, model, params, prompts, new):
        """Greedy decode through TransformerLM.decode_step on a dense fp32
        cache: the whole batch's prompts, then one token a step."""
        torch = self.torch
        B = len(prompts)
        toks = torch.as_tensor(prompts, dtype=torch.int32, device=self.dev)
        cache = model.init_cache(B, toks.shape[1] + new, dtype=torch.float32,
                                 device=self.dev)
        logits, cache = model.decode_step(params, cache, toks)
        streams = [[t] for t in logits[:, -1].argmax(-1).tolist()]
        for _ in range(new - 1):
            last = torch.as_tensor([[s[-1]] for s in streams],
                                   dtype=torch.int32, device=self.dev)
            logits, cache = model.decode_step(params, cache, last)
            for s, t in zip(streams, logits[:, 0].argmax(-1).tolist()):
                s.append(t)
        return streams

    def serve_flash(self):
        """One bucket of the same model compiled with the hand kernel's
        level (``expansion_level="flash"``), run on the scheduler's inputs:
        decode_attention launches once a layer, and the logits equal the
        generated-kernel step's within the bf16 tolerance."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.kernels.attention import decode_attention
        from repro_torch.pipeline.cache import CompilationCache
        from repro_torch.serving import DecodeStepCompiler
        model, params, _, _ = self.serving_model()
        B, ctx, kwargs = self.step_inputs
        n_pages = kwargs["kp0"].shape[0]
        comp = DecodeStepCompiler(
            model, params, page_size=programs.SERVE_PAGE_SIZE,
            n_pages=n_pages, cache=CompilationCache(), donate=False,
            device=self.dev, expansion_level="flash")
        t0 = time.perf_counter()
        step = comp.step_for(B, ctx)
        compile_s = time.perf_counter() - t0
        check(step.report["grid_kernels"] == [],
              f"flash step grid kernels {step.report['grid_kernels']}")
        before = decode_attention.launches
        got = step(kwargs)["logits"]
        torch.cuda.synchronize()
        n = decode_attention.launches - before
        check(n == model.cfg.n_layers, f"decode_attention launched {n} "
                                       f"times, not {model.cfg.n_layers}")
        want = self.step_want.double()
        lim = BF16_TOL_ULPS * BF16_ULP * want.abs().amax(-1, keepdim=True)
        ratio = float(((got.double() - want).abs() / lim).max())
        check(ratio <= 1, f"flash step logits off the grid step by "
                          f"{ratio:.3g} x the limit")
        return {"bucket": [B, ctx], "decode_attention_launches": n,
                "compile_seconds": compile_s, "logits_x_limit": ratio}

    # -- the RWKV6 family --------------------------------------------------
    def rwkv_cfg(self):
        from repro_torch.configs import get_config
        return self.rwkv_config or get_config(self.rwkv_arch)

    def wkv_inputs(self, B, S, H, hd, dtype, seed, state):
        """WKV operands drawn as the reference's tests draw them (r, k, v
        0.5 N(0, 1), w = exp(-0.5 - 3 U(0, 1)) in the model's range, u
        0.3 N(0, 1)); ``state`` "none" (None), "zero" (a zero tensor, as
        serving admission passes it) or "random" (0.1 N(0, 1))."""
        torch = self.torch
        r, k, v = (0.5 * self.randn(B, S, H, hd, seed=seed + i)
                   for i in range(3))
        g = torch.Generator(device=self.dev).manual_seed(self.seed + seed)
        w = torch.exp(-0.5 - 3.0 * torch.rand(B, S, H, hd, generator=g,
                                              device=self.dev))
        u = 0.3 * self.randn(H, hd, seed=seed + 3)
        s0 = None
        if state == "zero":
            s0 = torch.zeros(B, H, hd, hd, device=self.dev)
        elif state == "random":
            s0 = 0.1 * self.randn(B, H, hd, hd, seed=seed + 4)
        r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
        return r, k, v, w, u, s0

    def wkv_terms(self, r, k, v, w, u, state0):
        """The float64 WKV (the sequential scan) and the magnitudes of the
        WKV tolerance (module docstring): the scan of the absolute values,
        for the output and the final state, and Lambda."""
        torch = self.torch
        from repro_torch.kernels.rwkv import wkv_ref
        B, S, H, hd = r.shape
        r64, k64, v64, w64, u64 = (x.double() for x in (r, k, v, w, u))
        s64 = torch.zeros(B, H, hd, hd, dtype=torch.float64,
                          device=r.device) if state0 is None \
            else state0.double()
        want, want_st = wkv_ref(r64, k64, v64, w64, u64, s64)
        mag, mag_st = wkv_ref(r64.abs(), k64.abs(), v64.abs(), w64,
                              u64.abs(), s64.abs())
        lw = torch.log(w64.clamp(min=1e-8)).reshape(
            B, S // WKV_CHUNK, WKV_CHUNK, H, hd)
        lam = float(lw.cumsum(2).abs().amax())
        return want, want_st, mag, mag_st, lam

    def wkv_within(self, got, want, mag, lam, out_rel):
        """(ok, max error, worst ratio) under the WKV tolerance."""
        torch = self.torch
        limit = TOL_FACTOR * EPS32 * (math.sqrt(MIN_CHAIN)
                                      + WKV_CHUNK * lam) * mag \
            + out_rel * want.abs()
        err = (got.double() - want).abs()
        ok = bool(torch.isfinite(got).all()) and not bool((err > limit).any())
        return ok, float(err.max()), float((err / (limit + 1e-300)).max())

    @staticmethod
    def wkv_work(r, state0):
        """Bytes the WKV must move (r, k, v, w read once, u, state0 when
        given, out and the final state written once) and the operations it
        does, per chunk and head: the state term and the state update
        (4 C hd^2 + 2 hd^2), the strictly causal scores and their products
        with v over the C (C - 1) / 2 pairs (4 P hd), and per element the
        decay factors, the bonus and the sums (15 C hd)."""
        B, S, H, hd = r.shape
        C, P = WKV_CHUNK, WKV_CHUNK * (WKV_CHUNK - 1) // 2
        state = B * H * hd * hd * 4
        nbytes = 5 * r.numel() * r.element_size() + H * hd * 4 + state \
            + (0 if state0 is None else state)
        ops = B * H * (S // C) * (4 * C * hd * hd + 2 * hd * hd + 4 * P * hd
                                  + 15 * C * hd)
        return nbytes, ops

    def wkv_tf32_only(self, r, k, v, w, u, state0, products=1):
        """The plain chunked WKV (``kernels/rwkv/ref.py::wkv_chunked``)
        with every product's operands on tf32 (``tf32_einsum``): by default
        one tf32 product where the kernel takes three (the control);
        ``products=3`` emulates the kernel's three. The bonus and the decay
        stay fp32, as in the kernel."""
        torch = self.torch
        B, S, H, hd = r.shape
        C, N = WKV_CHUNK, S // WKV_CHUNK

        def mm(eq, a, b):
            return tf32_einsum(eq, a, b, products)

        rc, kc, vc, wc = (x.float().reshape(B, N, C, H, hd)
                          for x in (r, k, v, w))
        lw = torch.log(wc.clamp(min=1e-8))
        la = lw.cumsum(2)
        r_t = rc * torch.exp(la - lw)
        k_t = kc * torch.exp(-la)
        k_rev = kc * torch.exp(la[:, :, -1:] - la)
        a_last = torch.exp(la[:, :, -1])
        mask = torch.tril(torch.ones(C, C, dtype=torch.bool,
                                     device=r.device), diagonal=-1)
        scores = mm("bnthd,bnjhd->bnhtj", r_t, k_t) * mask
        out = mm("bnhtj,bnjhd->bnthd", scores, vc) \
            + torch.einsum("bnthd,hd,bnthd->bnth", rc, u, kc)[..., None] * vc
        t_mat = mm("bnjhd,bnjhe->bnhde", k_rev, vc)
        state = torch.zeros(B, H, hd, hd, device=r.device) \
            if state0 is None else state0.float()
        for n in range(N):
            out[:, n] += mm("bthd,bhde->bthe", r_t[:, n], state)
            state = a_last[:, n][..., :, None] * state + t_mat[:, n]
        return out.reshape(B, S, H, hd), state

    def wkv_vs_plain(self):
        """wkv_chunked against its plain version and the float64 scan at odd
        shapes (hd 64 and 32, bf16, a nonzero state0) and the path's shapes
        (serving admission: one 16-token chunk of rwkv6-7b from a zero state
        tensor, and from a random one; the forward: batch x seq from no
        state); the last chunk of the forward shape without its carried
        state, the admission chunk with one value slice of its state
        zeroed, and the plain version on tf32 products alone at the path's
        shapes (the control, by the limit and fp32 parity together, by at
        least CONTROL_MARGIN), must fail; in fp32 the kernel also passes
        parity with its plain version."""
        torch = self.torch
        from repro_torch.kernels.rwkv import wkv_chunked, wkv_chunked_ref
        bf, f32 = torch.bfloat16, torch.float32
        cfg = self.rwkv_cfg()
        H, hd = cfg.n_heads, cfg.head_dim
        cases = [("odd", 3, 48, 5, 64, f32, "none"),
                 ("odd", 3, 48, 5, 32, f32, "none"),
                 ("odd", 3, 48, 5, 64, bf, "none"),
                 ("odd", 3, 48, 5, 64, f32, "random"),
                 ("admission", 1, WKV_CHUNK, H, hd, f32, "zero"),
                 ("admission", 1, WKV_CHUNK, H, hd, f32, "random"),
                 ("forward", self.rwkv_batch, self.rwkv_seq, H, hd, f32,
                  "none")]
        rows = []
        for i, (what, B, S, H_, hd_, dt, st) in enumerate(cases):
            r, k, v, w, u, s0 = self.wkv_inputs(B, S, H_, hd_, dt,
                                                200 + 10 * i, st)
            got, got_st = wkv_chunked(r, k, v, w, u, s0)
            again, again_st = wkv_chunked(r, k, v, w, u, s0)
            plain, plain_st = wkv_chunked_ref(r, k, v, w, u, s0)
            torch.cuda.synchronize()
            name = f"wkv_chunked {what} B={B} S={S} H={H_} hd={hd_} {dt} " \
                   f"state0={st}"
            check(torch.equal(got, again) and torch.equal(got_st, again_st),
                  f"{name}: repeat runs differ")
            want, want_st, mag, mag_st, lam = self.wkv_terms(r, k, v, w, u,
                                                             s0)
            out_rel = BF16_ULP if dt == bf else 0.0
            worst = {}
            for part, a, p_, ref, m, rel in (
                    ("out", got, plain, want, mag, out_rel),
                    ("state", got_st, plain_st, want_st, mag_st, 0.0)):
                ok, err, _ = self.wkv_within(a, p_.double(), m, lam,
                                             2 * rel)
                check(ok, f"{name} {part} vs plain: |got-want| up to "
                          f"{err:.3e}")
                ok, err64, ratio = self.wkv_within(a, ref, m, lam, rel)
                check(ok, f"{name} {part} vs float64: |got-want| up to "
                          f"{err64:.3e}")
                ok, plain64, _ = self.wkv_within(p_, ref, m, lam, rel)
                check(ok, f"{name} {part}: plain vs float64")
                worst[part] = {"max_abs_err": err, "err_vs_f64": err64,
                               "plain_err_vs_f64": plain64,
                               "x_limit": ratio}
                if dt == f32:
                    ok, par = parity(a, p_, ref)
                    check(ok, f"{name} {part}: fp32 parity {par:.3g} x")
                    worst[part]["x_parity"] = par
            rows.append({"kernel": "wkv_chunked", "case": what,
                         "shape": [B, S, H_, hd_], "dtype": str(dt),
                         "state0": st, "lambda": lam, **worst})
            if what in ("admission", "forward"):
                # the control: one tf32 product where the kernel takes three
                one, one_st = self.wkv_tf32_only(r, k, v, w, u, s0)
                _, err, ratio = self.wkv_within(one, want, mag, lam, 0.0)
                _, _, ratio_st = self.wkv_within(one_st, want_st, mag_st,
                                                 lam, 0.0)
                par = parity(one, plain, want)[1]
                par_st = parity(one_st, plain_st, want_st)[1]
                check(max(ratio, par) >= CONTROL_MARGIN,
                      f"control {name}: tf32 products alone failed the WKV "
                      f"limit and parity by only {max(ratio, par):.3g} x")
                self.faults.append({
                    "fault": f"wkv_chunked {what} state0={st}: the plain "
                             f"version on one tf32 product each (control)",
                    "max_abs_err": err, "x_limit": ratio, "x_parity": par,
                    "state_x_limit": ratio_st, "state_x_parity": par_st})
                del one, one_st
            if what == "admission" and st == "random":
                # one warp's 16 value channels of the incoming state lost
                # (a later prefill chunk continues the cached state)
                e0, e = 16, 16
                lost = s0.clone()
                lost[..., e0:e0 + e] = 0
                bad, _ = wkv_chunked(r, k, v, w, u, lost)
                ok, err, ratio = self.wkv_within(bad, want, mag, lam, 0.0)
                check(not ok, f"planted fault wkv_chunked without a state "
                              f"slice passed ({ratio:.3g} x)")
                self.faults.append({
                    "fault": f"wkv_chunked {what}: state0's columns "
                             f"{e0}:{e0 + e} zeroed",
                    "max_abs_err": err, "x_limit": ratio})
            if what == "forward":
                # the last chunk run without the state the chunks before
                # it carry into it
                tail = [x[:, -WKV_CHUNK:] for x in (r, k, v, w)]
                bad, _ = wkv_chunked(*tail, u)
                ok, err, ratio = self.wkv_within(
                    bad, want[:, -WKV_CHUNK:], mag[:, -WKV_CHUNK:],
                    lam, 0.0)
                check(not ok, f"planted fault wkv_chunked without the "
                              f"carried state passed ({ratio:.3g} x)")
                self.faults.append({
                    "fault": f"wkv_chunked {what}: the last chunk without "
                             f"its carried state", "max_abs_err": err,
                    "x_limit": ratio})
            del r, k, v, w, got, again, plain, want, mag
        return rows

    def rwkv_model(self):
        """rwkv6-7b at full width and depth with seeded random weights from
        the port's init (fp32 parameters, as the config says), on the
        card."""
        torch = self.torch
        if self.rwkv_state is not None:
            return self.rwkv_state
        from repro_torch.models import TransformerLM
        model = TransformerLM(self.rwkv_cfg())
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=self.dev).manual_seed(
            self.seed))
        torch.cuda.synchronize()
        self.rwkv_state = (model, params, time.perf_counter() - t0)
        return self.rwkv_state

    @contextlib.contextmanager
    def wkv_route(self, fn):
        """Route the model's chunked WKV calls through ``fn`` for the
        duration (the model reaches the kernel as ``blocks.wkv_chunked``)."""
        from repro_torch.kernels.rwkv import wkv_chunked
        from repro_torch.models import blocks
        blocks.wkv_chunked = fn
        try:
            yield
        finally:
            blocks.wkv_chunked = wkv_chunked

    def capture_wkv(self, key):
        """A route that launches the kernel as the model would and keeps the
        first call's operands in ``wkv_ops[key]``, to time the kernel at
        the path's own operands afterwards."""
        from repro_torch.kernels.rwkv import wkv_chunked

        def fn(r, k, v, w, u, state0=None):
            self.wkv_ops.setdefault(key, (r, k, v, w, u, state0))
            return wkv_chunked(r, k, v, w, u, state0)
        return self.wkv_route(fn)

    def free_starcoder2(self):
        """Drop starcoder2-3b's weights and the steps that hold its pages
        before the RWKV phases (rwkv6-7b's fp32 weights are 27.9 GB)."""
        self.serve_state = None
        self.step_inputs = self.step_want = None
        self.torch.cuda.empty_cache()

    def forward_rwkv6(self):
        """TransformerLM.forward at rwkv6-7b's full width and depth on batch
        x seq tokens, fp32 activations: wkv_chunked launches once a layer
        (from no state), and the logits stay within 2^-12 of the row's
        largest |logit| of the same forward with the WKV's plain version."""
        torch = self.torch
        from repro_torch.kernels.rwkv import wkv_chunked, wkv_chunked_ref
        from repro_torch.models import TransformerLM
        self.free_starcoder2()
        model, params, init_s = self.rwkv_model()
        cfg = model.cfg
        m32 = TransformerLM(dataclasses.replace(cfg,
                                                activation_dtype="float32"))
        g = torch.Generator().manual_seed(self.seed + 1)
        toks = torch.randint(0, cfg.vocab, (self.rwkv_batch, self.rwkv_seq),
                             generator=g).to(self.dev)
        before = wkv_chunked.launches
        with self.capture_wkv("forward"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _ = m32.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        n = wkv_chunked.launches - before
        check(n == cfg.n_layers, f"forward launched wkv_chunked {n} times, "
                                 f"not {cfg.n_layers}")
        check(tuple(got.shape) == (self.rwkv_batch, self.rwkv_seq,
                                   model.vocab_padded),
              f"forward logits {tuple(got.shape)}")
        got = got[..., :cfg.vocab]
        check(bool(torch.isfinite(got).all()), "forward: non-finite logits")
        with self.wkv_route(wkv_chunked_ref):
            want, _ = m32.forward(params, {"tokens": toks})
        want = want[..., :cfg.vocab]
        lim = FWD_LOGIT_TOL * want.abs().amax(-1, keepdim=True)
        ratio = float(((got - want).abs() / lim).max())
        check(ratio <= 1, f"forward logits off the plain-WKV forward by "
                          f"{ratio:.3g} x the limit")
        return {"arch": cfg.name, "n_layers": cfg.n_layers,
                "d_model": cfg.d_model, "tokens": [self.rwkv_batch,
                                                   self.rwkv_seq],
                "param_init_seconds": init_s,
                "n_params": sum(p.numel() for p in _leaves(params)),
                "forward_seconds": fwd_s, "wkv_chunked_launches": n,
                "logits_x_limit": ratio,
                "max_abs_logit": float(want.abs().max())}

    def serve_rwkv6(self):
        """The Scheduler answers the benchmark's 64 requests with rwkv6-7b
        three times, as serve_starcoder2 does: fp32 streams equal to the
        model's decode_step loop, bf16 steps held to the torch-level step,
        bf16 timed. The steps list no grid kernel (RWKV layers are
        whole-array tasklets, as in the reference), every run launches
        wkv_chunked once a layer for each 16-token prefill chunk, no
        fallback fires."""
        torch = self.torch
        from repro_torch import programs
        from repro_torch.kernels.rwkv import wkv_chunked
        from repro_torch.models import TransformerLM
        from repro_torch.pipeline.cache import CompilationCache
        from repro_torch.serving import state_specs
        model, params, _ = self.rwkv_model()
        cfg = model.cfg
        new = programs.SERVE_NEW_TOKENS
        gc = torch.Generator().manual_seed(self.seed)
        prompts = torch.randint(0, cfg.vocab, (self.rwkv_requests,
                                               programs.SERVE_PROMPT),
                                generator=gc).tolist()
        # prefill chunks of SERVE_PROMPT = 16 tokens: each full chunk takes
        # the chunked WKV, a shorter tail the scan
        chunks = sum(len(p) // WKV_CHUNK for p in prompts)
        specs = state_specs(model)
        out = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "prefill_chunks": chunks,
               "state_mb_per_slot": sum(
                   math.prod(shape) * 4 for _, shape, _ in specs.values())
               / 1e6}

        def served(sched, label, compare=False, capture=None):
            before = wkv_chunked.launches
            route = self.capture_wkv(capture) if capture else \
                contextlib.nullcontext()
            compile_s, worst = self.checked(sched, compare, [])
            with route:
                if label == "bf16_timed":
                    res = self.timed(sched, prompts, new)
                    reqs = None
                else:
                    for p in prompts:
                        sched.submit(p, new)
                    reqs = sched.run()
                    self.finish(sched, reqs, len(prompts), new)
                    res = {"compile_seconds": compile_s,
                           "decode_steps": sched.n_decode_steps,
                           "slow_steps": sched.stats()["watchdog_events"]}
            n = wkv_chunked.launches - before
            check(n == cfg.n_layers * chunks,
                  f"{label}: wkv_chunked launched {n} times, not "
                  f"{cfg.n_layers} x {chunks} prefill chunks")
            res["wkv_chunked_launches"] = n
            if compare:
                res["logits_x_limit"] = worst[0]
            out[label] = res
            return reqs

        # 1. fp32: streams against the model's decode_step loop
        m32 = TransformerLM(dataclasses.replace(cfg,
                                                activation_dtype="float32"))
        s32 = self.scheduler(m32, params, cache_dtype="float32",
                             compile_cache=CompilationCache(),
                             n_requests=len(prompts))
        reqs = served(s32, "fp32", capture="admission")
        dense = self.dense_greedy(m32, params, prompts, new)
        same = sum(r.tokens_out == d for r, d in zip(reqs, dense))
        check(same == len(reqs), f"fp32 streams: {same} of {len(reqs)} "
                                 f"equal the decode_step loop")
        out["fp32"]["streams_equal_dense"] = same
        del s32, reqs, dense

        # 2. bf16, each step held against the torch-level step
        cc = CompilationCache()
        self.step_inputs = None
        sb = self.scheduler(model, params, compile_cache=cc,
                            n_requests=len(prompts))
        served(sb, "bf16_checked", compare=True)
        del sb

        # 3. bf16 timed (the buckets compiled above: cache hits)
        st = self.scheduler(model, params, compile_cache=cc,
                            n_requests=len(prompts))
        served(st, "bf16_timed")
        out["step_profile"] = self.profile_step(st.compiler,
                                                attention=False)
        self.step_inputs = self.step_want = None
        return out

    def measure_wkv(self):
        """wkv_chunked at the path's own operands (the forward's first layer
        and the first serving admission): ms, plain_ms, the float64 check,
        and the bound."""
        from repro_torch.kernels.rwkv import wkv_chunked, wkv_chunked_ref
        rows = {}
        for key in ("forward", "admission"):
            ops = self.wkv_ops[key]
            r, s0 = ops[0], ops[5]
            want, _, mag, _, lam = self.wkv_terms(*ops)
            got = wkv_chunked(*ops)[0]
            ok, err, ratio = self.wkv_within(got, want, mag, lam, 0.0)
            check(ok, f"wkv_chunked at the {key} operands vs float64: "
                      f"{err:.3e}")
            ok, par = parity(got, wkv_chunked_ref(*ops)[0], want)
            check(ok, f"wkv_chunked at the {key} operands: fp32 parity "
                      f"{par:.3g} x")
            del got
            nbytes, n_ops = self.wkv_work(r, s0)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / FP32_FLOP_PER_S * 1e3
            B, S, H, hd = r.shape
            rows[key] = {
                "max_abs_err": err, "x_limit": ratio, "x_parity": par,
                "ms": self.time_ms(lambda: wkv_chunked(*ops)),
                "device_ms": self.device_ms(lambda: wkv_chunked(*ops)),
                "plain_ms": self.time_ms(lambda: wkv_chunked_ref(*ops)),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": n_ops,
                "shapes": f"B={B}, S={S}, H={H}, hd={hd}, {r.dtype}, "
                          f"state0={'None' if s0 is None else 'zeros'}"}
        row = dict(rows["forward"], library_ms=None)
        row["admission"] = rows["admission"]
        return row

    # -- gemma3-4b prefill: flash attention --------------------------------
    def gemma_cfg(self):
        from repro_torch.configs import get_config
        return self.gemma_config or get_config(self.gemma_arch)

    def flash_mask(self, sq, sk, causal, window, q_offset):
        """(Sq, Sk) bool: query row r (at q_offset + r) admits key c."""
        torch = self.torch
        qp = q_offset + torch.arange(sq, device=self.dev)[:, None]
        c = torch.arange(sk, device=self.dev)[None, :]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=self.dev)
        if causal:
            mask &= c <= qp
        if window is not None:
            mask &= c > qp - window
        return mask

    def flash_terms(self, q, k, v, causal, window, q_offset, block=512):
        """Float64 attention and the magnitudes of the attention tolerance
        (module docstring), a block of query rows at a time: per (b, row, h)
        T, the largest sum_d |q_d k_cd| / sqrt(Dh) over the row's admitted
        keys; per row C, its admitted keys (Sk for a row that admits none:
        its output is the mean of V); per output A = sum_c p_c |v_cd|."""
        torch = self.torch
        B, Sq, Hq, Dh = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        k64 = k.double().repeat_interleave(Hq // Hkv, dim=2)
        v64 = v.double().repeat_interleave(Hq // Hkv, dim=2)
        scale = 1.0 / math.sqrt(Dh)
        f64 = dict(dtype=torch.float64, device=q.device)
        want = torch.empty(B, Sq, Hq, Dh, **f64)
        a = torch.empty(B, Sq, Hq, Dh, **f64)
        tmax = torch.empty(B, Sq, Hq, **f64)
        count = torch.empty(Sq, **f64)
        mask_all = self.flash_mask(Sq, Sk, causal, window, q_offset)
        for r0 in range(0, Sq, block):
            r1 = min(Sq, r0 + block)
            mask = mask_all[r0:r1]
            q64 = q[:, r0:r1].double()
            s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale
            p = torch.softmax(torch.where(mask, s, torch.tensor(-1e30, **f64)),
                              dim=-1)
            del s
            want[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", p, v64)
            a[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", p, v64.abs())
            del p
            t = torch.einsum("bqhd,bkhd->bhqk", q64.abs(), k64.abs()) * scale
            tmax[:, r0:r1] = torch.where(mask, t, torch.zeros((), **f64)
                                         ).amax(-1).transpose(1, 2)
            del t
            n = mask.sum(-1).double()
            count[r0:r1] = torch.where(n > 0, n,
                                       torch.tensor(float(Sk), **f64))
        return want, tmax, a, count

    def flash_within(self, got, want, tmax, a, count, out_rel):
        """(ok, max error, worst ratio) under the attention tolerance, with
        C the row's admitted keys."""
        torch = self.torch
        Dh = got.shape[-1]
        limit = TOL_FACTOR * EPS32 * (
            2 * math.sqrt(Dh) * tmax[..., None]
            + count.sqrt()[None, :, None, None] + 1) * a \
            + out_rel * want.abs()
        err = (got.double() - want).abs()
        ok = bool(torch.isfinite(got).all()) and not bool((err > limit).any())
        return ok, float(err.max()), float((err / (limit + 1e-300)).max())

    def flash_tf32_only(self, q, k, v, causal=True, window=None,
                        q_offset=0, products=1, bk=1024):
        """The plain flash attention (``kernels/attention/ref.py::
        flash_attention``, its online softmax over bk-key chunks) with the
        operands of both products, Q K^T and P V, on tf32
        (``tf32_einsum``): by default one tf32 product where the kernel
        takes three (the control); ``products=3`` emulates the kernel's
        three. The scores are scaled after their product, as in the
        kernel; the mask and the softmax stay fp32."""
        torch = self.torch
        from repro_torch.kernels.attention.ref import NEG_INF, gqa_repeat
        B, Sq, Hq, Dh = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        k, v = gqa_repeat(k, Hq // Hkv), gqa_repeat(v, Hq // Hkv)
        scale = 1.0 / math.sqrt(Dh)
        f32 = dict(dtype=torch.float32, device=q.device)
        m = torch.full((B, Hq, Sq), NEG_INF, **f32)
        l = torch.zeros(B, Hq, Sq, **f32)
        acc = torch.zeros(B, Hq, Sq, Dh, **f32)
        mask = self.flash_mask(Sq, Sk, causal, window, q_offset)
        for c0 in range(0, Sk, bk):
            c1 = min(Sk, c0 + bk)
            s = tf32_einsum("bqhd,bkhd->bhqk", q, k[:, c0:c1],
                            products) * scale
            s = torch.where(mask[:, c0:c1], s, torch.tensor(NEG_INF, **f32))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            del s
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + tf32_einsum(
                "bhqk,bkhd->bhqd", p, v[:, c0:c1], products)
            m = m_new
            del p
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        return out.permute(0, 2, 1, 3).to(q.dtype)

    def flash_vs_plain(self):
        """flash_attention against its plain version and float64 at odd
        shapes (tiny, Sq = 97, Sq != Sk; Dh 64, 96, 112, 128, 256; MHA, GQA,
        MQA; causal or not, a window or not, q_offset != 0, rows that admit
        no key), gemma3-4b's two prefill shapes (windowed and global) and
        starcoder2-3b's; in fp32 the kernel also passes parity with its
        plain version. Two planted faults must fail: the global shape
        with the diagonal masked out (q_offset = -1) and the windowed shape
        with the window widened by one; and the control (the plain version
        on one tf32 product each) must fail the limit and parity together
        by at least CONTROL_MARGIN at gemma3-4b's two fp32 shapes."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.kernels.attention import (flash_attention,
                                                   flash_attention_ref)
        bf, f32 = torch.bfloat16, torch.float32
        g = self.gemma_cfg()
        sc = get_config("starcoder2-3b")
        B, S, W = self.gemma_batch, self.gemma_seq, g.window
        gem = (B, S, S, g.n_heads, g.n_kv_heads, g.head_dim)
        # what, (B, Sq, Sk, Hq, Hkv, Dh), causal, window, q_offset, dtype
        cases = [("tiny", (1, 5, 5, 2, 1, 64), True, None, 0, f32),
                 ("tiny", (1, 5, 5, 2, 1, 64), True, None, 0, bf),
                 ("ragged_mha", (2, 97, 97, 4, 4, 64), True, None, 0, f32),
                 ("ragged_mha", (2, 97, 97, 4, 4, 64), True, None, 0, bf),
                 ("mqa_sq<sk", (1, 70, 200, 4, 1, 96), False, None, 0, f32),
                 ("gqa_sq>sk", (2, 200, 70, 8, 2, 112), True, 32, 0, f32),
                 ("q_offset", (2, 100, 300, 4, 2, 128), True, 64, 200, f32),
                 ("q_offset", (2, 100, 300, 4, 2, 128), True, 64, 200, bf),
                 ("window", (1, 600, 600, 4, 2, 256), True, 100, 0, bf),
                 ("all_masked", (1, 96, 32, 4, 2, 64), False, 16, 0, f32),
                 ("gemma3_windowed", gem, True, W, 0, f32),
                 ("gemma3_global", gem, True, None, 0, f32),
                 ("gemma3_windowed", gem, True, W, 0, bf),
                 ("starcoder2", (1, S, S, sc.n_heads, sc.n_kv_heads,
                                 sc.head_dim), True, None, 0, f32)]
        rows = []
        for i, (what, shape, causal, win, off, dt) in enumerate(cases):
            Bc, Sq, Sk, Hq, Hkv, Dh = shape
            q = self.randn(Bc, Sq, Hq, Dh, dtype=dt, seed=300 + 10 * i)
            k = self.randn(Bc, Sk, Hkv, Dh, dtype=dt, seed=301 + 10 * i)
            v = self.randn(Bc, Sk, Hkv, Dh, dtype=dt, seed=302 + 10 * i)
            kw = dict(causal=causal, window=win, q_offset=off)
            got = flash_attention(q, k, v, **kw)
            again = flash_attention(q, k, v, **kw)
            plain = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            name = f"flash_attention {what} {list(shape)} causal={causal} " \
                   f"window={win} q_offset={off} {dt}"
            check(torch.equal(got, again), f"{name}: repeat runs differ")
            want, tmax, a, count = self.flash_terms(q, k, v, **kw)
            out_rel = BF16_ULP if dt == bf else 0.0
            ok, err, _ = self.flash_within(got, plain.double(), tmax, a,
                                           count, 2 * out_rel)
            check(ok, f"{name} vs plain: |got-want| up to {err:.3e}")
            ok, err64, ratio = self.flash_within(got, want, tmax, a, count,
                                                 out_rel)
            check(ok, f"{name} vs float64: |got-want| up to {err64:.3e}")
            ok, plain64, _ = self.flash_within(plain, want, tmax, a, count,
                                               out_rel)
            check(ok, f"{name}: plain vs float64")
            rows.append({"kernel": "flash_attention", "case": what,
                         "shape": list(shape), "causal": causal,
                         "window": win, "q_offset": off, "dtype": str(dt),
                         "max_abs_err": err, "err_vs_f64": err64,
                         "plain_err_vs_f64": plain64, "x_limit": ratio})
            if dt == f32:
                ok, par = parity(got, plain, want)
                check(ok, f"{name}: fp32 parity {par:.3g} x")
                rows[-1]["x_parity"] = par
            if what.startswith("gemma3") and dt == f32:
                # the control: one tf32 product where the kernel takes three
                one = self.flash_tf32_only(q, k, v, **kw)
                _, e1, r1 = self.flash_within(one, want, tmax, a, count, 0.0)
                p1 = parity(one, plain, want)[1]
                check(max(r1, p1) >= CONTROL_MARGIN,
                      f"control {name}: tf32 products alone failed the "
                      f"limit and parity by only {max(r1, p1):.3g} x")
                self.faults.append({
                    "fault": f"flash_attention {what}: the plain version on "
                             f"one tf32 product each (control)",
                    "max_abs_err": e1, "x_limit": r1, "x_parity": p1})
                del one
            fault = None
            if what == "gemma3_global" and dt == f32:
                # q_offset = -1: row r admits keys c <= r - 1, not c <= r
                fault = ("the diagonal masked out",
                         dict(kw, q_offset=off - 1))
            elif what == "gemma3_windowed" and dt == f32:
                fault = ("the window widened by one", dict(kw, window=W + 1))
            if fault is not None:
                bad = flash_attention(q, k, v, **fault[1])
                ok, err, ratio = self.flash_within(bad, want, tmax, a, count,
                                                   0.0)
                check(not ok, f"planted fault flash_attention {what} with "
                              f"{fault[0]} passed ({ratio:.3g} x)")
                self.faults.append({
                    "fault": f"flash_attention {what}: {fault[0]}",
                    "max_abs_err": err, "x_limit": ratio})
                del bad
            del q, k, v, got, again, plain, want, tmax, a, count
        return rows

    def free_rwkv6(self):
        """Drop rwkv6-7b's weights and the steps that hold its state before
        gemma3-4b's (15.5 GB in fp32). The serving runs leave reference
        cycles (schedulers and their compiled steps) that hold the weights
        until the cycle collector runs: run it."""
        self.rwkv_state = None
        self.step_inputs = self.step_want = None
        gc.collect()
        self.torch.cuda.empty_cache()

    @contextlib.contextmanager
    def capture_flash(self):
        """Route the model's chunked attention (``blocks.attention_chunked``)
        through a function that counts its windowed and global calls, keeps
        the first of each kind's operands in ``flash_ops``, and calls the
        real one, which launches the kernel."""
        from repro_torch.models import blocks, layers

        def fn(q, k, v, *, causal=True, window=None, q_offset=0, bk=1024):
            key = "global" if window is None else "windowed"
            self.flash_calls[key] += 1
            self.flash_ops.setdefault(key, (q, k, v, dict(
                causal=causal, window=window, q_offset=q_offset)))
            return layers.attention_chunked(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset,
                                            bk=bk)
        blocks.attention_chunked = fn
        try:
            yield
        finally:
            blocks.attention_chunked = layers.attention_chunked

    def forward_gemma3(self):
        """TransformerLM.forward at gemma3-4b's full width and depth on
        batch x seq tokens, fp32 activations, attention_impl="chunked":
        flash_attention launches once a layer (29 windowed, 5 global), and
        the logits stay within 2^-12 of the row's largest |logit| of the
        same forward with attention_impl="naive" (the einsum attention)."""
        torch = self.torch
        from repro_torch.kernels.attention import flash_attention
        from repro_torch.models import TransformerLM
        self.free_rwkv6()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cfg = self.gemma_cfg()
        B, S = self.gemma_batch, self.gemma_seq
        chunked = TransformerLM(dataclasses.replace(
            cfg, attention_impl="chunked", activation_dtype="float32"))
        naive = TransformerLM(dataclasses.replace(
            cfg, attention_impl="naive", activation_dtype="float32"))
        t0 = time.perf_counter()
        params = chunked.init(torch.Generator(device=self.dev).manual_seed(
            self.seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in _leaves(params))
        g = torch.Generator().manual_seed(self.seed + 2)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=g).to(self.dev)
        n_windowed = sum(sp.window is not None for sp in chunked.layer_specs)
        self.flash_calls.clear()
        before = flash_attention.launches
        with self.capture_flash():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _ = chunked.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            chunked_s = time.perf_counter() - t0
        n = flash_attention.launches - before
        check(n == cfg.n_layers, f"forward launched flash_attention {n} "
                                 f"times, not {cfg.n_layers}")
        calls = dict(self.flash_calls)
        check(calls == {"windowed": n_windowed,
                        "global": cfg.n_layers - n_windowed},
              f"forward's chunked attention calls {calls}")
        check(tuple(got.shape) == (B, S, chunked.vocab_padded),
              f"forward logits {tuple(got.shape)}")
        got = got[..., :cfg.vocab]
        check(bool(torch.isfinite(got).all()), "forward: non-finite logits")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = naive.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t0
        check(flash_attention.launches - before == n,
              "the naive forward launched flash_attention")
        want = want[..., :cfg.vocab]
        ratio = 0.0
        for b in range(B):
            for r0 in range(0, S, 1024):
                w = want[b, r0:r0 + 1024]
                lim = FWD_LOGIT_TOL * w.abs().amax(-1, keepdim=True)
                ratio = max(ratio, float(
                    ((got[b, r0:r0 + 1024] - w).abs() / lim).max()))
        check(ratio <= 1, f"chunked forward logits off the naive forward by "
                          f"{ratio:.3g} x the limit")
        max_logit = float(want.abs().max())
        del got, want
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        profile = self.profile_forward(chunked, params, toks, chunked_s)
        del params
        torch.cuda.empty_cache()
        return {"arch": cfg.name, "n_layers": cfg.n_layers,
                "d_model": cfg.d_model, "heads": [cfg.n_heads,
                                                  cfg.n_kv_heads,
                                                  cfg.head_dim],
                "window": cfg.window, "tokens": [B, S],
                "param_init_seconds": init_s, "n_params": n_params,
                "forward_seconds": {"chunked": chunked_s, "naive": naive_s},
                "flash_attention_launches": n, "attention_calls": calls,
                "logits_x_limit": ratio, "max_abs_logit": max_logit,
                "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9,
                "profile": profile}

    def profile_forward(self, model, params, toks, wall_s):
        """Where the chunked forward's time goes: one more forward under
        torch.profiler (its own 34 flash_attention launches) — the card's
        busy time (the sum of its kernel times), the idle share against the
        unprofiled forward's wall time, the flash kernel's share and the
        device kernels by time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
        by_name, calls = Counter(), Counter()
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                by_name[e.name] += e.time_range.elapsed_us()
                calls[e.name] += 1
        busy_ms = sum(by_name.values()) / 1e3
        flash_ms = sum(t for n, t in by_name.items()
                       if "flash_attention_kernel" in n) / 1e3
        return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
                "device_idle_share": max(0.0, 1 - busy_ms / (wall_s * 1e3)),
                "flash_attention_ms": flash_ms,
                "flash_attention_share":
                    flash_ms / busy_ms if busy_ms else None,
                "kernels": sum(calls.values()),
                "top_device_kernels": [
                    {"name": n[:80], "ms": t / 1e3, "calls": calls[n]}
                    for n, t in by_name.most_common(6)]}

    def measure_flash(self):
        """flash_attention at the path's own operands (the forward's first
        windowed and first global layer, fp32, and the windowed layer's
        operands in bf16): the float64 check and, in fp32, parity; ms,
        device_ms, plain_ms, library_ms (scaled_dot_product_attention with
        the same boolean mask on GQA-repeated K/V) and the bound: 4 Dh flops
        per admitted (q, k) pair over the route's peak (fp32: three tf32
        products on the tensor cores; bf16: the bf16 tensor-core peak), or
        q, k, v and out once over the memory rate, whichever is larger. An
        fp32 row also gives the bound at the FMA peak (``bound_fma_ms``, the
        bound of PRs 17-20). ``sass`` counts the kernel library's tf32 MMAs,
        cp.async copies and atomics."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.attention import (flash_attention,
                                                   flash_attention_ref)
        rows = {}
        for key, src, dtype in (("windowed", "windowed", torch.float32),
                                ("global", "global", torch.float32),
                                ("windowed_bf16", "windowed",
                                 torch.bfloat16)):
            q, k, v, kw = self.flash_ops[src]
            q, k, v = (x.to(dtype) for x in (q, k, v))
            B, Sq, Hq, Dh = q.shape
            Sk, Hkv = k.shape[1], k.shape[2]
            want, tmax, a, count = self.flash_terms(q, k, v, **kw)
            got = flash_attention(q, k, v, **kw)
            bf16 = dtype == torch.bfloat16
            ok, err, ratio = self.flash_within(
                got, want, tmax, a, count, BF16_ULP if bf16 else 0.0)
            check(ok, f"flash_attention at the {key} layer's operands vs "
                      f"float64: {err:.3e}")
            par = None
            if not bf16:
                ok, par = parity(got, flash_attention_ref(q, k, v, **kw),
                                 want)
                check(ok, f"flash_attention at the {key} layer's operands: "
                          f"fp32 parity {par:.3g} x")
            del want, tmax, a, count, got
            mask = self.flash_mask(Sq, Sk, **kw)
            pairs = int(mask.sum())
            qt = q.transpose(1, 2)
            kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
                      for x in (k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

            es = q.element_size()
            nbytes = 2 * q.numel() * es + 2 * k.numel() * es
            n_ops = 4 * Dh * pairs * B * Hq
            peak = BF16_TENSOR_FLOP_PER_S if bf16 else TF32X3_FLOP_PER_S
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / peak * 1e3
            ms = self.time_ms(lambda: flash_attention(q, k, v, **kw))
            device_ms = self.device_ms(lambda: flash_attention(q, k, v, **kw))
            rows[key] = {
                "max_abs_err": err, "x_limit": ratio, "x_parity": par,
                "ms": ms, "device_ms": device_ms,
                "plain_ms": self.time_ms(
                    lambda: flash_attention_ref(q, k, v, **kw)),
                "library_ms": self.time_ms(sdpa),
                "library_device_ms": self.device_ms(sdpa),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": max(t_bytes, t_ops) / device_ms,
                "bytes": nbytes, "ops": n_ops, "admitted_pairs": pairs,
                "shapes": f"B={B}, S={Sq}, Hq={Hq}, Hkv={Hkv}, Dh={Dh}, "
                          f"causal={kw['causal']}, window={kw['window']}, "
                          f"{q.dtype}"}
            if not bf16:
                fma_ms = max(t_bytes, n_ops / FP32_FLOP_PER_S * 1e3)
                rows[key]["bound_fma_ms"] = fma_ms
                rows[key]["bound_fma_share"] = fma_ms / device_ms
            del q, k, v, qt, kt, vt, mask
        sass = sass_counts("flash_attention")
        check(sass["tf32_mma"] > 0 and sass["cp_async"] > 0 and
              sass["atomics"] == 0,
              f"flash_attention's library: {sass} (tensor-core MMAs and "
              f"cp.async expected, no atomics)")
        row = dict(rows["windowed"], sass=sass)
        row["global"] = rows["global"]
        row["windowed_bf16"] = rows["windowed_bf16"]
        return row

    @staticmethod
    def attn_rows(pos, C, window):
        """K/V rows the masked attention reads, summed over the batch: j
        with max(0, pos - window + 1) <= j <= min(pos, C - 1)."""
        p = pos.long()
        lo = (p - window + 1).clamp(min=0) if window else 0 * p
        return int((p.clamp(max=C - 1) - lo + 1).clamp(min=0).sum())

    def measure_attention(self, launches):
        """decode_attention and the generated attention row kernel at the
        serving shapes (the operands the main path gave the generated
        kernel): ms, plain_ms, library_ms (scaled_dot_product_attention
        with the same boolean mask) and the byte bound."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.codegen import cuda_backend
        from repro_torch.kernels.attention import (decode_attention,
                                                   decode_attention_ref)
        kernel, program, values, current = self.captured[ATTN_KEY]
        by_conn = {es.conn: values[es.data] for es in program.spec.inputs}
        q, k, v, pos = (by_conn[c] for c in ("q", "k", "v", "pos"))
        B, C, H, Dh = k.shape
        ins = {c: (t.reshape(1) if t.dim() == 0 else t).contiguous()
               for c, t in values.items()}

        def fresh():
            return {c: t.clone() for c, t in current.items()}

        def plain_grid():
            news = program.run(values, [current[es.data]
                                        for es in program.spec.outputs])
            return cuda_backend.stitch_results(program.spec, current, news)

        want, tmax, a = self.attn_terms(q, k, v, pos, None)
        outs = fresh()
        ptx = self.ptx_loads(cuda_backend.launch_kernel(
            kernel.desc, kernel.source, ins, outs))
        (oname,) = outs
        ok, gerr, gratio = self.attn_within(outs[oname], want, tmax, a, C, Dh,
                                            BF16_ULP)
        check(ok, f"generated attention kernel vs float64: {gerr:.3e}")
        # the fused loop's range one row short (ending at pos - 1): row pos,
        # which the mask admits, is never loaded
        bad_src, n = re.subn(r"(ri\d+) = tl\.minimum\(\1, (\d+)\)",
                             r"\1 = tl.minimum(\1, \2) - 1", kernel.source)
        check(n == 1, f"the attention source has {n} range ends, not 1")
        bad = fresh()
        cuda_backend.launch_kernel(kernel.desc, bad_src, ins, bad)
        ok, ferr, fratio = self.attn_within(bad[oname], want, tmax, a, C, Dh,
                                            BF16_ULP)
        check(not ok, f"planted fault {ATTN_KEY} with its range ending at "
                      f"pos - 1 passed the tolerance ({fratio:.3g} x)")
        self.faults.append({"fault": f"{ATTN_KEY}: the loop range ends at "
                                     f"pos - 1", "max_abs_err": ferr,
                            "x_limit": fratio})
        del bad
        ok, herr, hratio = self.attn_within(decode_attention(q, k, v, pos),
                                            want, tmax, a, C, Dh, BF16_ULP)
        check(ok, f"decode_attention at the serving shapes: {herr:.3e}")
        j = torch.arange(C, device=self.dev)
        mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
        kt, vt, q4 = k.transpose(1, 2), v.transpose(1, 2), q[:, :, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask)

        lib, lib_device = self.time_ms(sdpa), self.device_ms(sdpa)
        # the function needs only the K/V rows its mask admits (this run's
        # pos): q, pos and out once, and 2 x those rows of K and V
        rows_kv = self.attn_rows(pos, C, None)
        nbytes = sum(t.numel() * t.element_size() for t in (q, pos, q)) \
            + 2 * rows_kv * H * Dh * k.element_size()
        ops = 4 * rows_kv * H * Dh
        shape = (f"B={B}, C={C}, H={H}, Dh={Dh}, {q.dtype}, "
                 f"{rows_kv} of {B * C} K/V rows unmasked")
        outs = fresh()
        rows = {
            "decode_attention": {
                "max_abs_err": herr, "x_limit": hratio,
                "ms": self.time_ms(lambda: decode_attention(q, k, v, pos)),
                "device_ms": self.device_ms(
                    lambda: decode_attention(q, k, v, pos)),
                "plain_ms": self.time_ms(
                    lambda: decode_attention_ref(q, k, v, pos)),
                "library_ms": lib, "library_device_ms": lib_device,
                "bytes": nbytes, "ops": ops,
                "launches_per_step": self.attn_layers,
                "shapes": shape},
            f"grid_kernel:{ATTN_KEY}": {
                "emitter": "grid_kernel", "max_abs_err": gerr,
                "x_limit": gratio,
                "ms": self.time_ms(lambda: cuda_backend.launch_kernel(
                    kernel.desc, kernel.source, ins, outs)),
                "device_ms": self.device_ms(lambda: cuda_backend.
                                            launch_kernel(kernel.desc,
                                                          kernel.source,
                                                          ins, outs)),
                "plain_ms": self.time_ms(plain_grid, reps=3, warmup=1),
                "library_ms": lib, "library_device_ms": lib_device,
                "bytes": nbytes, "ops": ops, "ptx": ptx,
                "range_fault": {"max_abs_err": ferr, "x_limit": fratio},
                "launches": sum(n for name, n in launches.items()
                                if ATTN_RE.fullmatch(name)),
                "launches_per_step": self.attn_layers,
                "shapes": shape}}
        return rows


    # -- phase 8 ---------------------------------------------------------
    def observe(self, kernel, program, values, current):
        """Launch observer: keep each generated kernel's operands from the
        main path, to check and time the kernel after it (one entry for
        the serving step's per-layer attention kernels, which differ only
        in their layer)."""
        name = kernel.desc.name
        if ATTN_RE.fullmatch(name):
            name = ATTN_KEY
        self.captured[name] = (kernel, program, dict(values), dict(current))

    def measure_generated(self, launches):
        torch = self.torch
        from repro_torch.codegen import cuda_backend
        rows = {}
        for name, (kernel, program, values, current) in \
                sorted(self.captured.items()):
            if name == ATTN_KEY:        # measure_attention's
                continue
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

            outs = fresh()
            ptx = self.ptx_loads(cuda_backend.launch_kernel(
                desc, kernel.source, ins, outs))
            err = ratio = 0.0
            for c in outs:
                e, r = self.close(outs[c], want[c], norm2[c], n_terms[c],
                                  f"{name} vs plain ({c})")
                err, ratio = max(err, e), max(ratio, r)
            if name == "rowsum+shift_tiled":
                # the last reduction step skipped: the columns of the last
                # tile of the summed axis left out
                _, tile, _ = desc.tiles[desc.axis(desc.span[1])]
                bad = dict(ins)
                bad["A"] = ins["A"].clone()
                bad["A"][:, -tile:] = 0
                (c,) = outs
                self.refused(launch(bad)[c], want[c], norm2[c], n_terms[c],
                             f"{name} without the last {tile} columns (its "
                             f"last reduction step)")
                del bad
            if name == "gemv1_rows_tiled":
                # every row skips the first streamed chunk of its window
                chunk = desc.chunk
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

            def kernel_call():
                cuda_backend.launch_kernel(desc, kernel.source, ins, outs)

            ms = self.time_ms(kernel_call)
            device_ms = self.device_ms(kernel_call)
            plain_ms = self.time_ms(plain, reps=3, warmup=1)
            nbytes = sum(v.numel() * v.element_size() for v in values.values())
            nbytes += sum(v.numel() * v.element_size()
                          for v in current.values())
            library_ms, library_device_ms = self.library_ms(name, values)
            rows[f"{emitter}:{name}"] = {
                "emitter": emitter, "max_abs_err": err, "x_limit": ratio,
                "ms": ms, "device_ms": device_ms,
                "plain_ms": plain_ms, "bytes": nbytes,
                "ops": kernel_ops(desc),
                "library_ms": library_ms,
                "library_device_ms": library_device_ms,
                "ptx": ptx, "launches": launches[name]}
            del outs, want, sq, norm2
            print(f"# measured {name} in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
        return rows

    @staticmethod
    def ptx_loads(compiled):
        """Per function of a generated kernel (``main``, then ``final``),
        the 16-byte global loads (``ld.global...v4``) and ``cp.async``
        copies in the PTX of the compiled kernels its launch returned."""
        out = {}
        for step, kern in zip(("main", "final"), compiled):
            ptx = getattr(kern, "asm", {}).get("ptx", "")
            out[step] = {
                "ld_global_v4": len(re.findall(r"ld\.global[\w.:]*\.v4",
                                               ptx)),
                "cp_async": ptx.count("cp.async")}
        return out

    def library_ms(self, name, values):
        """One PyTorch call (or, for a fused chain, the torch composite)
        that computes the same function, timed on the kernel's own
        operands by CUDA events and by ``device_ms``; (None, None) where
        the path has no such call."""
        torch = self.torch
        import torch.nn.functional as F
        v = values
        f = {k: float(t) for k, t in v.items() if t.dim() == 0}
        ones = torch.ones(v["A"].shape[1], device=self.dev) \
            if "A" in v else None
        star = star_weight(self.dev)
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
            "star_tiled": lambda: F.conv2d(v["a"][None, None], star),
            "star": lambda: F.conv2d(v["a"][None, None], star),
        }
        fn = calls.get(name)
        if fn is None:
            return None, None
        return self.time_ms(fn), self.device_ms(fn)


class _StepView:
    """A compiled step whose call goes through ``run`` (the smoke's checks)
    and whose attributes are the step's."""

    def __init__(self, step, run):
        self._step, self._run = step, run

    def __call__(self, kwargs):
        return self._run(kwargs)

    def __getattr__(self, name):
        return getattr(self._step, name)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


#: the hand-written kernels' wrappers, by kernel name
HAND_KERNELS = ("dot", "axpydot", "matmul", "stencil2d", "stencil2d_chain",
                "diffusion2d", "jacobi3d", "diffusion3d", "decode_attention",
                "wkv_chunked", "flash_attention")


def hand_wrappers():
    from repro_torch.kernels.attention import (decode_attention,
                                               flash_attention)
    from repro_torch.kernels.axpydot import axpydot
    from repro_torch.kernels.dot import dot
    from repro_torch.kernels.gemm import matmul
    from repro_torch.kernels.rwkv import wkv_chunked
    from repro_torch.kernels import stencil
    return {"dot": dot, "axpydot": axpydot, "matmul": matmul,
            "stencil2d": stencil.stencil2d,
            "stencil2d_chain": stencil.stencil2d_chain,
            "diffusion2d": stencil.diffusion2d, "jacobi3d": stencil.jacobi3d,
            "diffusion3d": stencil.diffusion3d,
            "decode_attention": decode_attention,
            "wkv_chunked": wkv_chunked, "flash_attention": flash_attention}


def sass_counts(name):
    """Instructions of hand kernel ``name``'s built library, from
    ``cuobjdump -sass``: tf32 tensor-core MMAs (``HMMA...TF32``), cp.async
    copies (``LDGSTS``) and atomics (``ATOM``, ``RED``)."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    return {"tf32_mma": len(re.findall(r"\bHMMA\.\S*TF32", out)),
            "cp_async": len(re.findall(r"\bLDGSTS\b", out)),
            "atomics": len(re.findall(r"\b(?:ATOMS?|ATOMG|RED)\b", out))}


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


def star3d64(x, wc, wn):
    """wc x[d,h,w] + wn (the sum of its six neighbours) with a constant-0
    boundary, in x's dtype (float64 here)."""
    import torch.nn.functional as F
    p = F.pad(x, (1, 1, 1, 1, 1, 1))
    nb = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1] + p[1:-1, :-2, 1:-1]
          + p[1:-1, 2:, 1:-1] + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    return wc * x + wn * nb


def star_oracle(kind, n, params):
    """A float64 oracle of a Fig.-19 kernel for ``Smoke.slab_within``: maps
    a zero-padded slab (``rows`` its rows' or planes' field indices) to the
    kernel's result, or, given the squared slab and ``sq``, to the sum of
    its squared terms. ``kind`` is ``diffusion2d`` (params: c0..c4),
    ``jacobi3d``, ``diffusion3d`` (params: alpha), ``star`` (the star5
    program: b's boundary stays 0) or ``chain`` (params: the coefficients of
    the two-iteration diffusion, each stage's outside zeroed)."""
    from repro_torch import programs
    diff = programs.DIFFUSION_OFFSETS

    def oracle(x, rows, sq):
        def w(v):
            return v * v if sq else v
        if kind == "diffusion2d":
            return stencil64(x, [w(c) for c in params], diff)
        if kind == "jacobi3d":
            return star3d64(x, w(1 / 7), w(1 / 7))
        if kind == "diffusion3d":
            alpha = params
            # the centre is two terms, a and -6 alpha a
            return star3d64(x, 1 + 36 * alpha * alpha if sq else
                            1 - 6 * alpha, w(alpha))
        if kind == "star":
            y = stencil64(x, [w(c) for c in (0.5,) + (0.125,) * 4], diff)
            y[(rows == 0) | (rows == n - 1)] = 0
            y[:, 0] = y[:, -1] = 0
            return y
        outside = (rows < 0) | (rows >= n)
        for _ in range(2):
            x = stencil64(x, [w(c) for c in params], diff)
            x[outside] = 0
        return x
    return oracle


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
    matmul_routes = hand_wrappers()["matmul"].routes
    matmul_routes.clear()
    for name in ("stencil2d", "stencil2d_chain"):
        hand_wrappers()[name].routes.clear()
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
        phase("stencil_fig19", smoke.stencil_fig19)
        phase("serve_starcoder2", smoke.serve_starcoder2)
        phase("serve_flash", smoke.serve_flash)
        phase("forward_rwkv6", smoke.forward_rwkv6)
        phase("serve_rwkv6", smoke.serve_rwkv6)
        phase("forward_gemma3", smoke.forward_gemma3)
    finally:
        cuda_backend.LAUNCH_OBSERVERS.remove(smoke.observe)
    launches = {**dict(hand_counts()),
                "grid_kernel": cuda_backend.run_grid_kernel.launches,
                "two_phase": cuda_backend.run_two_phase.launches}
    per_kernel = {**cuda_backend.run_grid_kernel.launches_by_name,
                  **cuda_backend.run_two_phase.launches_by_name}
    routes = dict(matmul_routes)
    stencil_routes = {name: dict(hand_wrappers()[name].routes)
                      for name in ("stencil2d", "stencil2d_chain")}
    emit({"phase": "main_path_launches", **launches,
          "per_kernel": per_kernel, "matmul_routes": routes,
          "stencil_routes": stencil_routes})
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    for r in ("wgmma", "fma"):
        check(routes.get(r, 0) > 0,
              f"the matmul {r} route was not launched on the main path")

    t0 = time.perf_counter()
    generated = smoke.measure_generated(per_kernel)
    attention = smoke.measure_attention(per_kernel)
    smoke.results["decode_attention"] = attention.pop("decode_attention")
    smoke.results["wkv_chunked"] = smoke.measure_wkv()
    smoke.results["flash_attention"] = smoke.measure_flash()
    generated.update(attention)
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
        for extra in ("device_ms", "library_device_ms", "ptx", "measured_on",
                      "load_route", "load_routes", "range_fault",
                      "shapes", "launches_per_step", "admission", "global",
                      "windowed_bf16", "bound_fma_ms", "x_parity", "sass"):
            if extra in r:
                row[extra] = r[extra]
        if name == "matmul":
            row["routes"] = routes
        if name in stencil_routes:
            row["load_routes"] = stencil_routes[name]
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
