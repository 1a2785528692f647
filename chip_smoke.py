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
attention kernel a layer; each bucket's step run eagerly once, then
captured as CUDA graphs and replayed — in fp32 (greedy streams
token-identical to the dense ``TransformerLM.decode_step`` loop), in bf16
held step by step against the torch-level step, and in bf16 timed; then
one bucket with the
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
attention (``attention_impl="naive"``). Over the same parameters gemma3-4b
is then served: a ``Scheduler`` answers serve_bench's 64 requests as for
starcoder2-3b (fp32 streams against the dense loop, bf16 held step by
step, bf16 timed, one ``flash`` bucket), and a second run passes the
window: 8 prompts of 1,040 tokens in 16-token prefill chunks, 24 new
tokens, model length 2,048, every decode step at bucket (8, 2,048) with
pos past the window, so the windowed layers' masks exclude rows; fp32
streams against the dense loop (which takes each whole prompt at once),
bf16 held step by step, and a ``flash`` bucket whose decode_attention
splits each (b, h)'s context into chunks. The launch counts of these
paths are read, and every kernel is then measured at their shapes (the
generated attention kernel and decode_attention at both of gemma3-4b's
served shapes too), which frees the operands kept for that.
Last, with gemma3-4b's weights freed and its counts read, the MoE family,
its launches counted from 0 on its own path: llama4-scout-17b-a16e
at full width and 4 of its 48 layers (d_model 5,120, 40 query and 8 KV
heads of 128, 16 experts of d_ff 8,192 at top-1 with a shared expert on
every layer, vocab 202,048; seeded random fp32 parameters):
``TransformerLM.forward`` on 2 x 2,048 tokens with
``attention_impl="chunked"`` (4 ``flash_attention`` launches at Hq 40,
Hkv 8, Dh 128) held to the naive forward, and the ``sort`` dispatch held to
the ``onehot`` one on layer 0's MoE input; then served as gemma3-4b is
(fp32 streams against the dense loop, bf16 held step by step over the
real vocab and every replay byte-identical to the eager step, bf16 timed,
one ``flash`` bucket; a row that the two bf16 runs route to other experts
is held at the router input of the first layer where they part), and
the three attention kernels timed at its shapes. Then, with
llama4-scout's weights freed, the hybrid and VLM families on a fourth path
of their own counts: jamba-1.5-large-398b at full width and 2 of its 72
layers (d_model 8,192, 64 query and 8 KV heads of 128, an attention layer
with the dense FFN of 24,576 and a Mamba layer, Din 16,384, N 16, d_conv
4, with 16 experts of 24,576 at top-2; vocab 65,536; 47.6 GB of seeded
fp32 weights): ``TransformerLM.forward`` on 1 x 2,048 tokens held to the
naive forward, the Mamba layer's chunked scan held to a float64 scan at
rtol/atol 2e-4 (and the scan with its state dropped halfway failing it),
then served as llama4-scout is, the fp32 run over the fp32 weights and
the bf16 runs over the weights cast once to bf16; phi-3-vision-4.2b at
full width and depth (32 layers, d_model 3,072, 32 heads of Dh 96, vocab
32,064): the forward on 2 x (576 stub embeddings + 1,472 text tokens),
only the text's logits back, held to the naive forward, and served; then
the three attention kernels timed at its shapes. Last, with phi-3's
weights freed, the enc-dec family on a fifth path of its own counts:
seamless-m4t-medium at full width and depth (12 encoder and 12 decoder
layers, d_model 1,024, 16 heads of 64, d_ff 4,096, vocab 256,206; seeded
random fp32 parameters): ``EncDecLM.forward`` on 4 x (1,024 frames + 512
tokens) with ``attention_impl="chunked"`` (36 ``flash_attention``
launches: 12 non-causal over the frames, 12 causal, 12 cross-attention
at Sq 512, Sk 1,024), held to the naive forward over the real vocab,
with the encoder made causal failing; then its own decoding API as the
reference's (``init_cache``, ``prefill_cache``, ``decode_step``) for 64
requests, each with its own 1,024 frames, a 16-token prompt and 23 greedy
steps: in fp32 every decoded position held to the naive full forward over
the frames and the tokens, the greedy picks to its argmax (a pick may
differ only where the forward's top-2 gap is under the limit), and a
decode whose self-attention cache is written one position late failing;
in bf16 (the config's activations and the reference's bf16 cache) held
to the bf16 naive forward at 4 bf16 ulps of the row's largest |logit|,
repeated byte for byte and timed; then ``flash_attention`` timed at the
forward's three shapes. Last, the training path, its launches counted
from 0 on its own: ``train_lm`` (``python -m repro_torch.examples.train_lm``'s
``Trainer`` on LM100M, 20 AdamW steps of 8 x 256 tokens, a checkpoint every
10; a second run stopped at step 10 and resumed by a new Trainer; a third
with ``attention_impl="chunked"``, 12 forward and 12 backward
``flash_attention`` launches a step), ``train_starcoder2`` (starcoder2-3b
at full width and depth on 1 x 4,096 tokens: one step's gradients in fp32
through the flash kernels, forward and backward, against the naive
attention, two planted faults, then 3 bf16 AdamW steps timed) and
``train_rwkv6`` (rwkv6-7b at full width on 4 of its 32 layers, the WKV
kernels against the plain WKV, one planted fault, 3 bf16 steps), then
``measure_train`` (the two backward kernels at the path's operands
against their plain versions, fp32 parity, times). A kernel's launches in
the last line are those of every path.
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
chunk, a chain of at most C / 32 fp32 products, inside the sqrt(C) term;
the hand kernel rescales once a step of 4 rows of a stream (2 at two
vectors a lane) and merges its streams and, for a split context, its
chunks once each, chains as short. Three planted faults must fail it:
the hand kernel run with pos + 1, whose mask admits one position that
holds nonzero K/V; the hand kernel built with its merge of a split context
one chunk short (``dropped_chunk_source``), at the long context; and the
generated row kernel with its loop range one row short (ending at
pos - 1), which never reads row pos though the mask admits it.

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
kernels must pass both. The WKV backward's control is its own source with
the hi x hi product alone (``tf32_once_source``), held to parity at the
training path's layer (``Smoke.wkv_bwd_row``). bf16 outputs take the worst-case limit alone:
their own rounding (one bf16 ulp, 2^16 eps32 of the value) is most of
both errors.

The training path. One step's gradients through the kernels are held,
leaf by leaf, to the same step's through the plain path (the naive einsum
attention, or the plain chunked WKV on the same CUDA tensors) from the same
weights and batch: max |g - g_plain| <= 2^-10 max |g_plain| of the leaf.
The two differ only by the mixing step's fp32 rounding (relative 1e-5 or
less, by the forward bounds above and the backward's below) carried back
through 30 layers (4 for rwkv6-7b); 2^-10 leaves two orders of magnitude
for its growth, while a gradient that is lost or misrouted moves a leaf by
its own size. Three planted faults must fail it: the attention output
detached from the graph (what the parent's kernel returned), a flash
backward that sums a KV head's dK and dV over only the first of its query
heads (``first_head_source``: at starcoder2-3b's 12 query heads a KV head
loses 11/12 of its gradient), and a WKV backward that carries the state's
gradient into the chunk before without the chunk's decay
(``undecayed_source``). A bf16 step's first loss is held to 2^-7 (one bf16
ulp at the bottom of a binade) of the fp32 step's on the same weights and
batch: a mean over 4,095 positions of bf16-rounded log-sum-exps. A resumed
LM100M run's losses are held to 1e-4 of the uninterrupted run's
(``examples/train_lm.py``'s own limit; a resume that replays exactly gives
0), the chunked run's losses and grad norms to 1e-3 of the naive run's,
relative.

The backward kernels against their plain versions (``bwd_within``):
|got - want| <= 1e-4 (max |want| + |want|) elementwise, plus one bf16 ulp of
|want| in bf16. Kernel and plain version sum dK and dV over up to Sq rows
and the query heads, and dQ over up to Sk keys, in fp32 chains of other
orders: eps32 sqrt(4,096 x 12) = 2.6e-5 of the sums' size. For dQ and dK
the limit adds 4 eps32 sqrt(Sk) max|dO| max|V| max|K| / sqrt(Dh): dS =
P (dP - D) cancels where a row admits few keys (a window of one: dS is 0
exactly, and both versions return rounding noise of that size). In fp32
both are held to parity as above (P = 16) against the float64 gradient,
the plain backward run in float64. Both backwards take three tf32 products
a product (as rows 12 and 13's forwards, each tile's products summed in
fresh accumulators); the flash backward takes expf, the WKV backward
log2f and ex2.approx (the WKV forward's).

The serving logits in bf16 are held against the torch-level step (the
interpreter rung: a whole-array PyTorch attention) on the same inputs,
to 4 bf16 ulps of the row's largest |logit|. The two steps round
activations to bf16 at the same places except inside attention, where
the two sum in different orders, so an attention output may land on the
neighbouring bf16 value in each of the 30 layers; those flips reach the
logits through the rest of the step. fp32 is where the step is held
exactly: there the greedy streams must equal the dense loop's token for
token. A replayed step is also held to the eager step on the same inputs
(the same kernels in the same order: byte-identical on the card).
"""
from __future__ import annotations

import contextlib
import ctypes
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
from typing import NamedTuple

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
    # the gradients have no TPU kernel: the reference differentiates its
    # jnp attention_chunked (src/repro/models/layers.py:154) and
    # _wkv_chunked (src/repro/models/blocks.py:312)
    "flash_attention_bwd": "src/repro/kernels/attention/kernel.py:69 "
                           "(its gradient; no TPU kernel)",
    "wkv_chunked_bwd": "src/repro/kernels/rwkv/kernel.py:69 "
                       "(its gradient; no TPU kernel)",
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
    "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "wkv_chunked_bwd": "src/repro_torch/csrc/wkv_bwd.cu",
}
#: the backward kernels, which only the training path launches
TRAIN_KERNELS = ("flash_attention_bwd", "wkv_chunked_bwd")

#: the serving step's per-layer attention kernels (``attn{li}_grid_tiled``,
#: one generated row kernel a layer, identical but for the layer) are
#: measured and reported as one row
ATTN_RE = re.compile(r"attn\d+_grid_tiled")
ATTN_KEY = "attn*_grid_tiled"
#: a serving step's inputs that are neither weights nor pages and states
STEP_INPUTS = ("tokens", "positions", "block_table")

#: bf16 serving logits are held against the torch-level step on the same
#: inputs to this many bf16 ulps of the row's largest |logit| (see the
#: module docstring)
BF16_TOL_ULPS = 4

#: positions in a WKV chunk, and the forward's fp32 logits held against the
#: same forward with the plain WKV to this share of the row's largest
#: |logit| (see the module docstring)
WKV_CHUNK = 16
FWD_LOGIT_TOL = 2.0 ** -12
#: the selective scan's rtol/atol against float64: the reference's
#: ``tests/test_wkv_ssm.py``
SSM_TOL = 2e-4
#: the training path's limits (see the module docstring): a gradient leaf
#: of the kernel path within TRAIN_GRAD_TOL of that leaf's largest |g| on
#: the plain path; a bf16 step's first loss within TRAIN_BF16_LOSS of the
#: fp32 loss on the same weights and batch; a resumed run's losses within
#: RESUME_LOSS_TOL of the uninterrupted run's (``examples/train_lm.py``'s
#: own limit); the chunked LM100M run's losses and grad norms within
#: CHUNKED_LM_TOL of the naive run's, relative; a backward kernel within
#: BWD_TOL of its plain version (see ``bwd_within``)
TRAIN_GRAD_TOL = 2.0 ** -10
TRAIN_BF16_LOSS = 2.0 ** -7
RESUME_LOSS_TOL = 1e-4
CHUNKED_LM_TOL = 1e-3
BWD_TOL = 1e-4
#: the norms' parameters, float32 whatever a config's ``param_dtype``
NORM_KEY = re.compile(r"(ln\d*|final)_(scale|bias)")

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


class Geometry(NamedTuple):
    """One serving run's shape: ``requests`` prompts of ``prompt`` tokens,
    ``new`` tokens each, ``page``-token pages, the model length, the
    scheduler's slots and its prefill chunk. (A NamedTuple: the tests load
    this file with ``importlib`` outside ``sys.modules``, where Python
    3.12.3's ``dataclass`` fails on string annotations.)"""
    requests: int
    prompt: int
    new: int
    page: int
    max_model_len: int
    slots: int
    prefill_chunk: int

    @property
    def n_pages(self) -> int:
        """serve_bench's page count: each request's worst case plus one,
        and the null page."""
        return self.requests * ((self.prompt + self.new) // self.page
                                + 1) + 1


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


#: the H100's L2 cache; a cold timing rotates over operand copies whose
#: bytes together exceed twice it (``cold_copies``)
L2_BYTES = 50 * 2 ** 20


def cold_copies(nbytes: int) -> int:
    """Copies of operands that read ``nbytes`` a call, at least two, of
    which all but one together exceed twice the L2: a call in a rotation
    over them finds its operands evicted by the calls since their last."""
    return 2 * L2_BYTES // max(1, nbytes) + 2


def dropped_chunk_source(text: str) -> str:
    """decode_attention's source with the merge of a split context one
    chunk short: the item that takes the last ticket merges chunks 0 ..
    n_used - 2 (a planted fault)."""
    bad, n = re.subn(r"(void merge_chunks\(const float\* first, int n_used,"
                     r"[^{]*\{)", r"\1\n  --n_used;", text)
    check(n == 1, f"decode_attention has {n} chunk merges, not 1")
    return bad


def first_head_source(text: str) -> str:
    """flash_attention_bwd.cu with the planted fault of the training path:
    a KV head's dK and dV summed over only the first of its query heads."""
    line = "for (int r = 0; r < rep; ++r) {"
    check(text.count(line) == 1, "first_head_source: the sum over the "
                                 "query heads was not found once")
    return text.replace(line, "for (int r = 0; r < 1; ++r) {")


def undecayed_source(text: str) -> str:
    """wkv_bwd.cu with the planted fault of the training path: the state's
    gradient carried into the span before without the span's decay (the
    reverse scan's G <- diag(A) G + W without diag(A))."""
    line = "gs = carry(a[j], gs, x[j]);"
    check(text.count(line) == 1, "undecayed_source: the carry of G was "
                                 "not found once")
    return text.replace(line, "gs = carry(1.0f, gs, x[j]);")


def tf32_once_source(text: str) -> str:
    """wkv_bwd.cu with one tf32 product where the kernel takes three (the
    hi x hi product alone: the control of the backward's fp32 parity)."""
    lines = ("  if (!kExactA) mma_tf32(small, alo, bh0, bh1);\n"
             "  if (!kExactB) mma_tf32(small, ahi, bl0, bl1);\n")
    check(text.count(lines) == 1, "tf32_once_source: the small products "
                                  "were not found once")
    return text.replace(lines, "")


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
        #: serve_bench's geometry (``requests`` set per run)
        self.serve_geo = Geometry(
            programs.SERVE_REQUESTS, programs.SERVE_PROMPT,
            programs.SERVE_NEW_TOKENS, programs.SERVE_PAGE_SIZE,
            programs.SERVE_MAX_MODEL_LEN, programs.SERVE_MAX_SLOTS,
            programs.SERVE_PROMPT)
        #: decode_attention's cases against its plain version and float64
        #: (name, B, C, H, Dh, window, ``attn_inputs``' pos mode; "narrow":
        #: a row 16-byte vectors do not divide, "sliced": a row of more
        #: than 64 16-byte vectors), and the cases timed beside the serving
        #: step's (pos = C - 1): a long context, and gemma3-4b's windowed
        #: layers GQA-repeated
        self.attn_cases = [
            ("odd", 3, 40, 5, 64, None, None),
            ("serving", 64, 48, 24, 128, None, None),
            ("long", 8, 4096, 24, 128, None, None),
            ("window", 4, 2048, 8, 256, 1024, None),
            ("mostly_masked", 64, 512, 24, 128, None, "masked"),
            ("pos_negative", 8, 1024, 8, 128, None, "negative"),
            ("pos_past_context", 8, 1024, 8, 128, None, "past"),
            ("window_past_context", 8, 1024, 8, 256, 512, "past"),
            ("narrow", 3, 300, 5, 61, 20, None),
            ("sliced", 2, 700, 2, 520, None, None)]
        self.attn_timed = [("long", 8, 4096, 24, 128, None),
                           ("windowed", 16, 2048, 8, 256, 1024)]
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
        #: gemma3-4b served over the forward's parameters (kept in
        #: ``gemma_state``): serve_bench's geometry, and a run whose decode
        #: steps pass the 1,024-token window (prompts of 1,040 tokens in
        #: 16-token prefill chunks, bucket (8, 2,048) at every step)
        self.gemma_state = None
        self.gemma_requests = programs.SERVE_REQUESTS
        self.gemma_window_geo = Geometry(8, 1040, 24, 16, 2048, 8, 16)
        #: while a gemma3-4b phase runs, its attention launches are kept
        #: apart from starcoder2-3b's: (tag, "windowed"/"global") -> the
        #: last launch, (tag, B, C) -> launches at that shape, tag -> the
        #: flash bucket's decode_attention launches and plan
        self.attn_tag = None
        self.attn_windows = []
        self.gemma_captured = {}
        self.gemma_launches = Counter()
        self.gemma_flash = {}
        #: the MoE family: llama4-scout-17b-a16e at full width and
        #: ``llama_layers`` of its 48 layers (``llama_config`` a ModelConfig
        #: overrides the arch's), forward on batch x seq tokens, served at
        #: serve_bench's geometry over the forward's parameters
        #: (``llama_state``); its attention launches go under the tag
        #: "llama4", its prefill operands into ``llama_flash_ops``
        self.llama_arch = "llama4-scout-17b-a16e"
        self.llama_config = None
        self.llama_layers = 4
        self.llama_batch, self.llama_seq = 2, 2048
        self.llama_requests = programs.SERVE_REQUESTS
        self.llama_state = None
        self.llama_flash_ops = {}
        #: the hybrid family: jamba-1.5-large-398b at full width and
        #: ``jamba_layers`` of its 72 layers (``jamba_config`` a ModelConfig
        #: overrides the arch's), forward on batch x seq tokens, served at
        #: serve_bench's geometry over the forward's parameters
        #: (``jamba_state``); its first Mamba layer's scan operands in
        #: ``ssm_ops``
        self.jamba_arch = "jamba-1.5-large-398b"
        self.jamba_config = None
        self.jamba_layers = 2
        self.jamba_batch, self.jamba_seq = 1, 2048
        self.jamba_requests = programs.SERVE_REQUESTS
        self.jamba_state = None
        self.jamba_flash_ops = {}
        self.ssm_ops = {}
        #: the VLM family: phi-3-vision-4.2b at full width and depth
        #: (``phi3_config`` a ModelConfig overrides the arch's), forward on
        #: batch x (its 576 stub embeddings + phi3_text tokens), served at
        #: serve_bench's geometry over the forward's parameters
        #: (``phi3_state``); its prefill operands in ``phi3_flash_ops``
        self.phi3_arch = "phi-3-vision-4.2b"
        self.phi3_config = None
        self.phi3_batch, self.phi3_text = 2, 1472
        self.phi3_requests = programs.SERVE_REQUESTS
        self.phi3_state = None
        self.phi3_flash_ops = {}
        #: the enc-dec family: seamless-m4t-medium at full width and depth
        #: (``seamless_config`` a ModelConfig overrides the arch's), forward
        #: on batch x (its 1,024 frames, seamless_text tokens), then its
        #: decoding API at serve_bench's geometry (``seamless_requests``
        #: requests, each with its own frames, a prompt, new tokens, a
        #: cache of ``seamless_max_seq`` positions) over the forward's
        #: parameters (``seamless_state``); the forward's first encoder,
        #: self- and cross-attention operands in ``seamless_flash_ops``
        self.seamless_arch = "seamless-m4t-medium"
        self.seamless_config = None
        self.seamless_batch, self.seamless_text = 4, 512
        self.seamless_requests = programs.SERVE_REQUESTS
        self.seamless_prompt = programs.SERVE_PROMPT
        self.seamless_new = programs.SERVE_NEW_TOKENS
        self.seamless_max_seq = 64
        self.seamless_state = None
        self.seamless_flash_ops = {}
        #: the training path: LM100M through the Trainer (``lm_config`` a
        #: ModelConfig overrides train_lm's), starcoder2-3b at full width
        #: and depth (``train_config`` overrides it) and rwkv6-7b at full
        #: width on ``train_rwkv_layers`` layers (``train_rwkv_config``),
        #: each on train_batch x train_seq tokens for ``train_steps`` timed
        #: bf16 steps; the backward kernels' first operands at each shape
        #: (``capture_bwd``) for ``measure_train``
        self.lm_config = None
        self.lm_batch, self.lm_seq, self.lm_steps = 8, 256, 20
        self.train_arch = "starcoder2-3b"
        self.train_config = None
        self.train_rwkv_config = None
        self.train_rwkv_layers = 4
        self.train_batch, self.train_seq = 1, 4096
        self.train_steps = 3
        self.bwd_ops = {}
        self.wkv_bwd_ops = {}
        self.attn_fns = set()   # the attention row kernels' Triton functions
        self.variants = {}      # library name -> its decode_attention entry
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

    @staticmethod
    def logit_x_limit(got, want, tol):
        """The largest |got - want| over ``tol`` times the row's largest
        |want|, in float32 on want's device, 1,024 rows at a time (a
        difference over a whole (rows, vocab) batch is GBs)."""
        g2 = got.reshape(-1, got.shape[-1])
        w2 = want.reshape(-1, want.shape[-1])
        ratio = 0.0
        for r0 in range(0, g2.shape[0], 1024):
            w = w2[r0:r0 + 1024].float()
            lim = tol * w.abs().amax(-1, keepdim=True)
            g = g2[r0:r0 + 1024].to(w.device).float()
            ratio = max(ratio, float(((g - w).abs() / lim).max()))
        return ratio

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
        """Every kernel, in parallel with a variant of decode_attention's
        library: its source with the planted merge fault."""
        from repro_torch.kernels import build
        from repro_torch.kernels.attention import kernel as attn
        source = build.CSRC / "decode_attention.cu"
        bad = build.build_dir() / "variants" / "decode_attention_drop.cu"
        bad.parent.mkdir(exist_ok=True)
        bad.write_text(dropped_chunk_source(source.read_text()))
        variants = {"decode_attention_drop": bad}
        for name, src, edit in (
                ("flash_attention_bwd_first_head", "flash_attention_bwd.cu",
                 first_head_source),
                ("wkv_bwd_undecayed", "wkv_bwd.cu", undecayed_source),
                ("wkv_bwd_tf32_once", "wkv_bwd.cu", tf32_once_source)):
            variants[name] = build.build_dir() / "variants" / f"{name}.cu"
            variants[name].write_text(edit((build.CSRC / src).read_text()))
        out = build.build_all(sources=variants)
        self.variants["decode_attention_drop"] = attn.entry(
            ctypes.CDLL(out["decode_attention_drop"]["library"]))
        for name in ("flash_attention_bwd_first_head", "wkv_bwd_undecayed",
                     "wkv_bwd_tf32_once"):
            self.variants[name] = ctypes.CDLL(out[name]["library"])
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
        return self.graph_ms([fn] * reps)

    def device_ms_cold(self, fns, reps=10):
        """``device_ms`` with the operands out of L2: the captured calls
        rotate over ``fns``, one closure a copy of the operands
        (``cold_copies`` of them), so that each call reads what the calls
        before it evicted; at least ``reps`` calls, whole rotations."""
        return self.graph_ms(list(fns) * -(-reps // len(fns)))

    def backward_device_ms(self, forward, inputs, grad, reps=10):
        """The card's own time of one autograd backward through
        ``forward(*inputs)`` for the output gradient ``grad``:
        ``device_ms`` of the forward and the backward captured together,
        less that of the forward alone. A backward runs on its forward's
        stream, so only the pair can be captured, each call on leaves of
        its own (detached views of ``inputs``: a leaf made on the default
        stream would tie the capture to it). torch.profiler, tried first,
        recorded none of the backward's kernels after the serving phases'
        captures."""
        torch = self.torch

        def run(backward):
            leaves = [x.detach().requires_grad_(True) for x in inputs]
            out = forward(*leaves)
            return torch.autograd.grad(out, leaves, grad) if backward \
                else out
        return self.device_ms(lambda: run(True), reps) - \
            self.device_ms(lambda: run(False), reps)

    def graph_ms(self, calls):
        """``device_ms`` of the sequence ``calls``, a call's mean."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for fn in dict.fromkeys(calls):
                fn()
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for fn in calls:
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
        return min(times) / len(calls)

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
    def attn_inputs(self, B, C, H, Dh, dtype, seed, pos_mode=None):
        """Seeded q, k, v and pos: pos uniform in [0, C), or by
        ``pos_mode`` in [0, C / 16) ("masked"), in [-C, -1] ("negative",
        nothing admitted) or in [C, 2 C) ("past", every row or, with a
        window, the window's part of the context)."""
        torch = self.torch
        q = self.randn(B, H, Dh, dtype=dtype, seed=seed)
        k = self.randn(B, C, H, Dh, dtype=dtype, seed=seed + 1)
        v = self.randn(B, C, H, Dh, dtype=dtype, seed=seed + 2)
        g = torch.Generator(device=self.dev).manual_seed(self.seed + seed)
        hi = max(1, C // 16) if pos_mode == "masked" else C
        pos = torch.randint(0, hi, (B,), generator=g, device=self.dev)
        pos = {"negative": -1 - pos, "past": C + pos}.get(pos_mode, pos)
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
        shapes, the serving shapes, a long context, a sliding window,
        mostly-masked buckets, pos < 0 (nothing admitted: the mean of V),
        pos >= C (every row, or a window's part), Dh 61 and Dh 520 (the
        kernel's narrow vectors and row slices), in fp32 and bf16;
        repeats byte-identical. Two planted faults must fail the
        tolerance: a mask that admits one unwritten position (the kernel
        run with pos + 1) at the serving shape, and the kernel built with
        its merge one chunk short at the long context, which the plan
        splits."""
        torch = self.torch
        bf, f32 = torch.bfloat16, torch.float32
        rows = []
        for i, (what, B, C, H, Dh, win, mode) in enumerate(self.attn_cases):
            for dt in (bf, f32):
                rows.append(self.attention_case(
                    what, B, C, H, Dh, win, mode, dt, 100 + 20 * i +
                    (dt == f32)))
        return rows

    def attention_case(self, what, B, C, H, Dh, win, mode, dt, seed):
        """One case of ``attention_vs_plain``, and its planted fault."""
        torch = self.torch
        from repro_torch.kernels.attention import (decode_attention,
                                                   decode_attention_ref)
        from repro_torch.kernels.attention import kernel as attn
        q, k, v, pos = self.attn_inputs(B, C, H, Dh, dt, seed, mode)
        got = decode_attention(q, k, v, pos, window=win)
        again = decode_attention(q, k, v, pos, window=win)
        plain = decode_attention_ref(q, k, v, pos, win)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"decode_attention {what}: repeat "
                                       f"runs differ")
        want, tmax, a = self.attn_terms(q, k, v, pos, win)
        out_rel = BF16_ULP if dt == torch.bfloat16 else 0.0
        name = f"decode_attention {what} B={B} C={C} H={H} Dh={Dh} " \
               f"window={win} {dt}"
        ok, err, _ = self.attn_within(got, plain.double(), tmax, a, C, Dh,
                                      2 * out_rel)
        check(ok, f"{name} vs plain: |got-want| up to {err:.3e}")
        ok, err64, ratio = self.attn_within(got, want, tmax, a, C, Dh,
                                            out_rel)
        check(ok, f"{name} vs float64: |got-want| up to {err64:.3e}")
        ok, _, _ = self.attn_within(plain, want, tmax, a, C, Dh, out_rel)
        check(ok, f"{name}: plain vs float64")
        plan = attn.plan(B, C, H, Dh, dt, win)
        row = {"kernel": "decode_attention", "case": what,
               "shape": [B, C, H, Dh], "window": win, "dtype": str(dt),
               "route": list(attn.route(q, k, v)), "plan": list(plan),
               "max_abs_err": err, "err_vs_f64": err64, "x_limit": ratio}
        fault = None
        if what == "serving" and dt == torch.bfloat16:
            # slot pos + 1 holds nonzero (random) K/V, never written by the
            # sequence: a mask that admits it must fail
            fault = ("the mask admits slot pos + 1",
                     decode_attention(q, k, v, pos + 1))
        if what == "long" and dt == torch.bfloat16:
            used = [len(attn.chunk_ranges(C, int(p), win, *plan)[0])
                    for p in pos.tolist()]
            check(max(used) > 1, f"{name}: no row takes two chunks {used}")
            fault = ("the merge one chunk short",
                     attn.run(self.variants["decode_attention_drop"], q, k,
                              v, pos, win))
        if fault is not None:
            ok, ferr, fratio = self.attn_within(fault[1], want, tmax, a, C,
                                                Dh, out_rel)
            check(not ok, f"planted fault decode_attention {what} with "
                          f"{fault[0]} passed the tolerance ({fratio:.3g} x)")
            self.faults.append({"fault": f"decode_attention {what}: "
                                         f"{fault[0]}", "max_abs_err": ferr,
                                "x_limit": fratio})
        return row

    def serving_model(self):
        """starcoder2-3b at full width and depth with seeded random weights
        from the port's init (fp32 parameters, as the config says), on
        the card, and the benchmark's prompts."""
        torch = self.torch
        if self.serve_state is not None:
            return self.serve_state
        from repro_torch.configs import get_config
        from repro_torch.models import TransformerLM
        cfg = self.serve_config or get_config(self.serve_arch)
        model = TransformerLM(cfg)
        t0 = time.perf_counter()
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        params = model.init(g)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = self.prompts(cfg.vocab, self.geometry(self.serve_requests))
        self.serve_state = (model, params, prompts, init_s)
        return self.serve_state

    def geometry(self, requests):
        """serve_bench's geometry with ``requests`` requests."""
        return self.serve_geo._replace(requests=requests)

    def prompts(self, vocab, geo):
        """``geo.requests`` seeded prompts of ``geo.prompt`` tokens."""
        torch = self.torch
        g = torch.Generator().manual_seed(self.seed)
        return torch.randint(0, vocab, (geo.requests, geo.prompt),
                             generator=g).tolist()

    def scheduler(self, model, params, geo, **kw):
        from repro_torch.serving import Scheduler
        return Scheduler(model, params, max_slots=geo.slots,
                         page_size=geo.page, n_pages=geo.n_pages,
                         max_model_len=geo.max_model_len,
                         prefill_chunk=geo.prefill_chunk, device=self.dev,
                         **kw)

    def checked(self, sched, compare, names, buckets=None):
        """Wrap the scheduler's compiler: every bucket compiles at the grid
        rung with ``names`` as its grid kernels (none of the attention
        scopes falling back) and is captured as a CUDA graph on its first
        step, and each step launches each of them once and no other (a
        replay counting what its capture launched); with ``compare``, the
        torch-level step (the interpreter rung) and the eager step (op by
        op, uncounted) run first on copies of the same inputs, the step's
        bf16 logits are held to the torch-level step's within the limit and
        to the eager step's within it too (``logit_ratio``, over the MoE
        routes the runs record; ``vs_eager`` counts the steps and those
        byte-identical), and the largest bucket's last step is kept in
        ``step_inputs``/``step_want`` (its logits and routes); ``buckets``
        (a Counter)
        counts the steps of each bucket; the attention kernels' launches of
        a gemma3-4b phase are counted by (tag, B, ctx). Returns the seconds
        each bucket took to compile and capture, a one-element list holding
        the worst ratio of the logits' error to its limit, ``vs_eager``, and
        the MoE routing's counts against the torch-level step
        (``routing_stats``)."""
        torch = self.torch
        from repro_torch.codegen import cuda_backend as cb
        comp = sched.compiler
        step_for = comp.step_for
        vocab = sched.model.cfg.vocab
        compile_s = {}
        worst = [0.0]
        vs_eager = {"steps": 0, "replays": 0, "byte_identical": 0,
                    "worst_x_limit": 0.0}
        routing = self.routing_stats()

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
                ref = keep = eager = None
                routes = {"eager": []}
                with self.moe_routes(compare) as rec:
                    if compare:
                        # the pages and states the step writes, and the
                        # host's per-step inputs (on the CPU the block
                        # table's tensor can share the scheduler's live
                        # array)
                        keep = {k: (v.clone() if k in step.donate_names or
                                    k in STEP_INPUTS else v)
                                for k, v in kwargs.items()}
                        ref = comp.fallback_for(B, ctx)(keep)["logits"]
                        routes["ref"] = rec.take()
                        replay = step.captured is not None
                        if replay:
                            with self.uncounted():
                                eager = step.eager({
                                    k: (keep[k].clone()
                                        if k in step.donate_names
                                        else keep[k])
                                    for k in step.arg_names})["logits"]
                            routes["eager"] = rec.take()
                    before = Counter(cb.run_grid_kernel.launches_by_name)
                    res = step(kwargs)
                    # a replay runs no Python: its routes are the eager
                    # step's, to which it is held byte for byte
                    routes["step"] = rec.take() or routes["eager"]
                moved = Counter(cb.run_grid_kernel.launches_by_name) - before
                check(moved == Counter(names), f"step launches {dict(moved)}")
                check(step.captured is not None,
                      f"bucket {(B, ctx)} was not captured")
                if self.attn_tag is not None:
                    self.gemma_launches[(self.attn_tag, B, ctx)] += sum(
                        n for k, n in moved.items() if ATTN_RE.fullmatch(k))
                if buckets is not None:
                    buckets[f"{B}x{ctx}"] += 1
                if compare:
                    for what, other, key in (
                            ("the torch-level step", ref, "ref"),
                            ("the eager step", eager, "eager")):
                        if other is None:
                            continue
                        ratio = self.logit_ratio(
                            res["logits"], other, vocab, routes["step"],
                            routes[key], routing if other is ref else None,
                            f"bucket {(B, ctx)} against {what}")
                        if other is ref:
                            worst[0] = max(worst[0], ratio)
                        else:
                            vs_eager["worst_x_limit"] = max(
                                vs_eager["worst_x_limit"], ratio)
                            vs_eager["byte_identical"] += int(torch.equal(
                                res["logits"], eager))
                    vs_eager["steps"] += 1
                    vs_eager["replays"] += int(eager is not None)
                    if self.step_inputs is None or \
                            ctx >= self.step_inputs[1]:
                        self.step_inputs = (B, ctx, keep)
                        self.step_want = (res["logits"], routes["step"])
                return res
            return _StepView(step, run)

        comp.step_for = wrapped_step_for
        return compile_s, worst, vs_eager, routing

    @contextlib.contextmanager
    def moe_routes(self, on=True):
        """While ``on``, every call of the MoE block that runs op by op (a
        stream capture records nothing) records its input rows (T, D), its
        router's probabilities (T, E) and its top-k experts, sorted (T, k),
        computed as the block computes them; ``take()`` returns the records
        in call order (a layer each) and clears them."""
        torch = self.torch
        from repro_torch.models import blocks, layers
        rec = _Records()
        block = blocks.moe_block

        def recorded(x, router_w, *args, **kw):
            if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
                xt = x.reshape(-1, x.shape[-1])
                probs = torch.softmax(torch.matmul(
                    xt.float(), router_w.float()), dim=-1)
                idx = layers._top_k(probs, kw["top_k"])[1]
                rec.append((xt.clone(), probs, idx.sort(-1).values))
            return block(x, router_w, *args, **kw)

        if on:
            blocks.moe_block = recorded
        try:
            yield rec
        finally:
            blocks.moe_block = block

    @staticmethod
    def routing_stats():
        """The counts ``logit_ratio`` gathers over a run."""
        return {"rows": 0, "rows_rerouted": 0,
                "worst_router_input_x_limit": 0.0,
                "largest_router_prob_gap": 0.0}

    def logit_ratio(self, got, want, vocab, got_routes=(), want_routes=(),
                    stats=None, what="logits"):
        """Hold bf16 logits ``got`` to ``want`` over the real vocab (the
        padded columns hold -1e30): BF16_TOL_ULPS ulps of the row's largest
        |logit|. With the MoE routes of both runs, a row whose top-k
        experts are the same in every layer is held so too; a row routed
        to other experts from some layer on is held at that layer's router
        input (the block's input row, to BF16_TOL_ULPS ulps of its largest
        entry): up to there the two runs differ by rounding alone, and a
        router near a tie turns that into another expert's output, which
        no logit limit bounds. ``stats`` gathers the rows, those rerouted,
        the worst router-input ratio and the largest gap between the two
        choices' router probabilities. Returns the worst ratio."""
        torch = self.torch
        g, w = (x[..., :vocab].double() for x in (got, want))
        lim = BF16_TOL_ULPS * BF16_ULP * w.abs().amax(-1)
        row_ratio = ((g - w).abs().amax(-1) / lim).reshape(-1)
        check(len(got_routes) == len(want_routes),
              f"{what}: {len(got_routes)} MoE layers recorded against "
              f"{len(want_routes)}")
        rerouted = torch.zeros_like(row_ratio, dtype=torch.bool)
        x_ratio = torch.zeros_like(row_ratio)
        gap = 0.0
        for (xg, pg, ig), (xw, pw, iw) in zip(got_routes, want_routes):
            check(xw.shape[0] == row_ratio.numel(),
                  f"{what}: {xw.shape[0]} routed rows for "
                  f"{row_ratio.numel()} logit rows")
            first = (ig != iw).any(-1) & ~rerouted
            xlim = BF16_TOL_ULPS * BF16_ULP * xw.double().abs().amax(-1)
            xr = (xg.double() - xw.double()).abs().amax(-1) / xlim
            x_ratio = torch.where(first, xr, x_ratio)
            if bool(first.any()):
                gap = max(gap, float(
                    (pw.gather(-1, iw).sum(-1) - pw.gather(-1, ig).sum(-1)
                     )[first].abs().max()))
            rerouted |= first
        ratio = float(torch.where(rerouted, x_ratio, row_ratio).max())
        n = int(rerouted.sum())
        check(bool(torch.isfinite(g).all()) and ratio <= 1,
              f"{what}: off by {ratio:.3g} x the limit ({n} of "
              f"{rerouted.numel()} rows rerouted; the logits of the others "
              f"{float(row_ratio.masked_fill(rerouted, 0).max()):.3g} x)")
        if stats is not None:
            stats["rows"] += rerouted.numel()
            stats["rows_rerouted"] += int(rerouted.sum())
            if bool(rerouted.any()):
                stats["worst_router_input_x_limit"] = max(
                    stats["worst_router_input_x_limit"],
                    float(x_ratio[rerouted].max()))
            stats["largest_router_prob_gap"] = max(
                stats["largest_router_prob_gap"], gap)
        return ratio

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

    def serve_runs(self, model, params, prompts, geo, timed=True,
                   bf16=None):
        """The Scheduler answers ``prompts`` at ``geo`` in fp32 (streams
        token-identical to the dense decode_step loop), in bf16 with every
        compiled step held against the torch-level step and every replay
        against the eager step on the same inputs and, with ``timed``, in
        bf16 timed; then ``profile_step`` on the largest bucket's last
        step. Every bucket's report lists one attn grid kernel per
        attention layer, each launched once a step, no fallback; every
        bucket is captured. ``bf16`` (a function of no argument returning a
        model and its parameters) replaces ``model`` and ``params`` after
        the fp32 run. ``part_seconds``: each part's wall time (the fp32 run
        with its dense loop, the checked and the timed bf16 runs, the
        profile), to say where the phase's time goes."""
        from repro_torch.models import TransformerLM
        from repro_torch.pipeline.cache import CompilationCache
        cfg = model.cfg
        names = [f"attn{li}_grid_tiled" for li in attention_layers(model)]
        new = geo.new
        buckets = Counter()
        out = {}
        parts = {}
        t0 = time.perf_counter()

        # 1. fp32: streams against the dense decode_step loop
        cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
        m32 = TransformerLM(cfg32)
        s32 = self.scheduler(m32, params, geo, cache_dtype="float32",
                             compile_cache=CompilationCache())
        c32, _, _, _ = self.checked(s32, False, names, buckets)
        for p in prompts:
            s32.submit(p, new)
        reqs = s32.run()
        self.finish(s32, reqs, len(prompts), new)
        margins = []
        dense = self.dense_greedy(m32, params, prompts, new, margins)
        same = sum(r.tokens_out == d for r, d in zip(reqs, dense))
        check(same == len(reqs), f"fp32 streams: {same} of {len(reqs)} "
                                 f"equal the dense decode_step loop; the "
                                 f"first to differ: "
                                 f"{self.diverged(reqs, dense, margins)}")
        out["fp32"] = {"streams_equal_dense": same,
                       "compile_seconds": c32,
                       "decode_steps": s32.n_decode_steps,
                       "least_top2_margin": min(min(m) for m in margins),
                       "slow_steps": s32.stats()["watchdog_events"]}
        del s32, reqs, dense, m32
        self.release()
        if bf16 is not None:
            model, params = bf16()
        parts["fp32"], t0 = time.perf_counter() - t0, time.perf_counter()

        # 2. bf16, each step held against the torch-level step
        cc = CompilationCache()
        sb = self.scheduler(model, params, geo, compile_cache=cc)
        self.step_inputs = None
        cbf, worst, vs_eager, routing = self.checked(sb, True, names,
                                                     buckets)
        for p in prompts:
            sb.submit(p, new)
        self.finish(sb, sb.run(), len(prompts), new)
        check(vs_eager["replays"] > 0, "no step of the bf16 run replayed")
        out["bf16_checked"] = {"compile_seconds": cbf,
                               "logits_x_limit": worst[0],
                               "captured_vs_eager": vs_eager,
                               "moe_routing": routing,
                               "decode_steps": sb.n_decode_steps,
                               "slow_steps": sb.stats()["watchdog_events"]}
        del sb
        self.release()
        parts["bf16_checked"], t0 = time.perf_counter() - t0, \
            time.perf_counter()

        # 3. bf16 timed (the buckets compiled above: cache hits), and the
        # step's profile
        st = self.scheduler(model, params, geo, compile_cache=cc)
        self.checked(st, False, names, buckets)
        if timed:
            out["bf16_timed"] = self.timed(st, prompts, new)
        parts["bf16_timed"], t0 = time.perf_counter() - t0, \
            time.perf_counter()
        out["step_profile"] = self.profile_step(
            st.compiler, plain=(model, params) if timed else None)
        parts["profile"] = time.perf_counter() - t0
        out["buckets"] = dict(buckets)
        out["part_seconds"] = parts
        return out

    def release(self):
        """Free what a finished scheduler held: its steps' graphs and graph
        pool sit in reference cycles until the collector runs."""
        gc.collect()
        self.torch.cuda.empty_cache()

    def serve_starcoder2(self):
        """The Scheduler answers the benchmark's 64 requests three times
        (``serve_runs``): fp32, bf16 checked, bf16 timed."""
        model, params, prompts, init_s = self.serving_model()
        cfg = model.cfg
        self.attn_layers = cfg.n_layers
        out = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "d_model": cfg.d_model, "param_init_seconds": init_s,
               "n_params": sum(p.numel() for p in _leaves(params))}
        out.update(self.serve_runs(model, params, prompts,
                                   self.geometry(len(prompts))))
        return out

    def profile_step(self, compiler, steps=3, attention=True, plain=None):
        """Where one decode step's time goes, eager and captured side by
        side: the largest bucket's step run ``steps`` times on the
        scheduler's inputs, op by op (``CompiledDecodeStep.eager``) and as
        its CUDA graph replayed, each under torch.profiler — wall time a
        step (host clock, synchronised), device busy time (the sum of the
        card's kernel times), the idle share, kernels a step and the device
        kernels by time —; with ``plain`` (the
        model and its parameters), the plain decode_step loop at the
        bucket's batch on a dense cache of the model length; with
        ``attention``, the attention row kernels' time and, timed on their
        own at the step's shapes, the casts of the weights and the page
        gathers. Only the captured runs of the bucket count as launches of
        the main path (the scheduler ran that step; the rest compares)."""
        B, ctx, kwargs = self.step_inputs
        step = compiler.step_for(B, ctx)
        out = {"bucket": [B, ctx],
               "captured": self.step_runs(step, kwargs, steps)}
        with self.uncounted():
            out["eager"] = self.step_runs(step, kwargs, steps, eager=True)
            out["eager_over_captured_wall"] = \
                out["eager"]["wall_ms"] / out["captured"]["wall_ms"]
            if plain is not None:
                out["plain_loop"] = self.plain_loop_runs(*plain, B, steps)
            if attention:
                cap = out["captured"]
                attn_ms = sum(t for n, t in cap.pop("by_name").items()
                              if n.startswith(tuple(self.attn_fns))) / 1e3
                cap["attention_kernels_ms"] = attn_ms / steps
                cap["attention_share_of_busy"] = attn_ms / steps / \
                    cap["device_busy_ms"] if cap["device_busy_ms"] else None
                out.update(self.step_parts(compiler, kwargs, ctx))
        for k in ("eager", "captured"):
            out[k].pop("by_name", None)
        return out

    @contextlib.contextmanager
    def uncounted(self):
        """Launches in the duration are comparisons, not the main path's:
        every wrapper's count is put back after it."""
        from repro_torch.serving import graphs
        snap = graphs.counts_snapshot()
        try:
            yield
        finally:
            graphs.restore_counts(snap)

    def step_runs(self, step, kwargs, steps, eager=False):
        """``step`` run ``steps`` + 1 times on copies of ``kwargs``' pages
        and states (the first unprofiled, as are ``steps`` more for the
        wall time), then ``steps`` times under torch.profiler: wall ms a
        step (median), device busy ms, idle share, kernels a step, the top
        device kernels. A captured step is captured first if it was not."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        names = list(step.arg_names)
        pages = {k: kwargs[k] for k in names if k in step.donate_names}

        def fresh():
            kw = {k: kwargs[k] for k in names}
            kw.update({k: v.clone() for k, v in pages.items()})
            return kw

        call = step.eager if eager else step
        if not eager and step.captured is None:
            step(fresh())

        def run(kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        plain = [run(fresh()) for _ in range(steps + 1)][1:]
        inputs = [fresh() for _ in range(steps)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for kw in inputs:
                run(kw)
        del inputs
        return self.profiled(prof, statistics.median(plain) * 1e3, steps)

    @staticmethod
    def profiled(prof, wall_ms, steps):
        """The card's own kernel events of ``prof`` (not the CPU ops that
        launched them), a step's share of them."""
        kernels = [e for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        by_name, calls = Counter(), Counter()
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
        busy_ms = sum(by_name.values()) / 1e3 / steps
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
                "kernels_per_step": len(kernels) / steps,
                "top_device_kernels": [
                    {"name": n[:80], "ms_per_step": t / 1e3 / steps,
                     "calls_per_step": calls[n] / steps}
                    for n, t in by_name.most_common(8)],
                "by_name": by_name}

    def plain_loop_runs(self, model, params, B, steps):
        """The plain decode_step loop (serve_bench's baseline) at batch
        ``B``: a dense bf16 cache of the model length, a 16-token prompt,
        then ``steps`` + 1 decode steps timed and ``steps`` profiled."""
        torch = self.torch
        from repro_torch import programs
        geo = self.serve_geo
        with torch.inference_mode():
            cache = model.init_cache(B, geo.max_model_len,
                                     dtype=torch.bfloat16, device=self.dev)
            toks = torch.randint(0, model.cfg.vocab,
                                 (B, programs.SERVE_PROMPT),
                                 generator=torch.Generator(self.dev)
                                 .manual_seed(self.seed), device=self.dev,
                                 dtype=torch.int32)
            logits, cache = model.decode_step(params, cache, toks)
            toks = logits[:, -1:].argmax(-1).to(torch.int32)
            state = [cache, toks]

            def one():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, state[0] = model.decode_step(params, state[0], state[1])
                state[1] = lg.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            walls = [one() for _ in range(steps + 1)][1:]
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    one()
        out = self.profiled(prof, statistics.median(walls) * 1e3, steps)
        out.pop("by_name")
        out["batch"] = B
        out["tokens_per_s"] = B / (out["wall_ms"] / 1e3)
        return out

    def step_parts(self, compiler, kwargs, ctx):
        """Two parts of a decode step timed on their own, by their device
        time (``device_ms``) at the step's shapes: the casts of the weight
        matrices to the activation dtype (every one, once, as a step's
        tasklets cast them), and the page gathers (one layer's K and V
        gathered and GQA-expanded, as ``gather{li}`` does, times the
        attention layers)."""
        torch = self.torch
        cfg = compiler.model.cfg
        adt = getattr(torch, cfg.activation_dtype)
        mats = [w for w in compiler.flat_weights.values() if w.dim() >= 2]
        bt = kwargs["block_table"].long()
        H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kp, vp = kwargs["kp0"], kwargs["vp0"]
        n_attn = sum(1 for k in kwargs if k.startswith("kp"))

        def casts():
            for w in mats:
                w.to(adt)

        def gather():
            for pages in (kp, vp):
                c = pages[bt].reshape(-1, ctx, Hkv, dh)
                c = c[:, :, :, None, :].expand(
                    c.shape[0], ctx, Hkv, H // Hkv, dh).reshape(
                    c.shape[0], ctx, H, dh)
                c.to(adt)

        return {"casts_ms": self.device_ms(casts, reps=3),
                "cast_bytes": sum(w.numel() * (w.element_size() + 2)
                                  for w in mats),
                "gather_ms": n_attn * self.device_ms(gather)}

    def dense_greedy(self, model, params, prompts, new, margins=None):
        """Greedy decode through TransformerLM.decode_step on a dense fp32
        cache: the whole batch's prompts, then one token a step; with
        ``margins`` (a list), each step's top-2 logit margin of every
        stream appended to it."""
        torch = self.torch
        B = len(prompts)
        toks = torch.as_tensor(prompts, dtype=torch.int32, device=self.dev)
        cache = model.init_cache(B, toks.shape[1] + new, dtype=torch.float32,
                                 device=self.dev)

        def pick(lg):
            if margins is not None:
                top = lg.topk(2, dim=-1).values
                margins.append((top[:, 0] - top[:, 1]).tolist())
            return lg.argmax(-1).tolist()

        logits, cache = model.decode_step(params, cache, toks)
        streams = [[t] for t in pick(logits[:, -1])]
        del logits
        for _ in range(new - 1):
            last = torch.as_tensor([[s[-1]] for s in streams],
                                   dtype=torch.int32, device=self.dev)
            logits, cache = model.decode_step(params, cache, last)
            for s, t in zip(streams, pick(logits[:, 0])):
                s.append(t)
        return streams

    @staticmethod
    def diverged(reqs, dense, margins):
        """The first stream that leaves the dense loop's: its request, the
        step, and the dense loop's top-2 logit margin at that step."""
        for i, (r, d) in enumerate(zip(reqs, dense)):
            if r.tokens_out != d:
                step = next(j for j, (a, b) in enumerate(
                    zip(r.tokens_out, d)) if a != b)
                return {"rid": r.rid, "step": step,
                        "dense_top2_margin": margins[step][i]}
        return None

    def serve_flash(self):
        """One bucket of starcoder2-3b compiled with the hand kernel's level
        (``flash_bucket``)."""
        from repro_torch import programs
        model, params, _, _ = self.serving_model()
        return self.flash_bucket(model, params, programs.SERVE_PAGE_SIZE)

    def flash_bucket(self, model, params, page_size):
        """The largest bucket's kept step compiled with the hand kernel's
        level (``expansion_level="flash"``) and run twice on the same
        inputs (not donated): the first call runs op by op and captures the
        step, the second replays it; each launches decode_attention once
        an attention layer (the replay by its capture's count), the
        replay's logits equal the first call's within the bf16 tolerance,
        and both equal the generated-kernel step's within it
        (``logit_ratio`` over the MoE routes of the first call and of the
        kept step)."""
        torch = self.torch
        from repro_torch.kernels.attention import decode_attention
        from repro_torch.pipeline.cache import CompilationCache
        from repro_torch.serving import DecodeStepCompiler
        B, ctx, kwargs = self.step_inputs
        n_pages = kwargs["kp0"].shape[0]
        comp = DecodeStepCompiler(
            model, params, page_size=page_size,
            n_pages=n_pages, cache=CompilationCache(), donate=False,
            device=self.dev, expansion_level="flash")
        t0 = time.perf_counter()
        step = comp.step_for(B, ctx)
        compile_s = time.perf_counter() - t0
        check(step.report["grid_kernels"] == [],
              f"flash step grid kernels {step.report['grid_kernels']}")
        out = {"bucket": [B, ctx], "compile_seconds": compile_s}
        got, routes = {}, {}
        for call in ("eager", "captured"):
            before = decode_attention.launches
            with self.moe_routes(call == "eager") as rec:
                got[call] = step(kwargs)["logits"]
            routes[call] = rec.take()
            torch.cuda.synchronize()
            n = decode_attention.launches - before
            n_attn = len(attention_layers(model))
            check(n == n_attn,
                  f"decode_attention launched {n} times in the {call} "
                  f"step, not {n_attn}")
            out[f"{call}_decode_attention_launches"] = n
        check(step.captured is not None, "the flash step was not captured")

        vocab = model.cfg.vocab
        want, want_routes = self.step_want
        out["moe_routing"] = self.routing_stats()
        # the replay is held to the eager call on every row, and takes its
        # routes against the grid step
        out["logits_x_limit"] = max(
            self.logit_ratio(g, want, vocab, routes["eager"], want_routes,
                             out["moe_routing"],
                             f"the flash step's {call} call against the "
                             f"grid step")
            for call, g in got.items())
        out["captured_vs_eager_x_limit"] = self.logit_ratio(
            got["captured"], got["eager"], vocab, what="the captured flash "
                                                      "step against its "
                                                      "eager call")
        out["captured_byte_identical"] = bool(torch.equal(got["captured"],
                                                          got["eager"]))
        check(out["logits_x_limit"] <= 1,
              f"flash step logits off the grid step by "
              f"{out['logits_x_limit']:.3g} x the limit")
        check(out["captured_vs_eager_x_limit"] <= 1,
              f"the captured flash step off the eager one by "
              f"{out['captured_vs_eager_x_limit']:.3g} x the limit")
        return out

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
            compile_s, worst, vs_eager, _ = self.checked(sched, compare,
                                                         [])
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
                check(vs_eager["replays"] > 0,
                      f"{label}: no step replayed")
                res["logits_x_limit"] = worst[0]
                res["captured_vs_eager"] = vs_eager
            out[label] = res
            return reqs

        # 1. fp32: streams against the model's decode_step loop
        m32 = TransformerLM(dataclasses.replace(cfg,
                                                activation_dtype="float32"))
        geo = self.geometry(len(prompts))
        s32 = self.scheduler(m32, params, geo, cache_dtype="float32",
                             compile_cache=CompilationCache())
        reqs = served(s32, "fp32", capture="admission")
        dense = self.dense_greedy(m32, params, prompts, new)
        same = sum(r.tokens_out == d for r, d in zip(reqs, dense))
        check(same == len(reqs), f"fp32 streams: {same} of {len(reqs)} "
                                 f"equal the decode_step loop")
        out["fp32"]["streams_equal_dense"] = same
        del s32, reqs, dense
        self.release()

        # 2. bf16, each step held against the torch-level step
        cc = CompilationCache()
        self.step_inputs = None
        sb = self.scheduler(model, params, geo, compile_cache=cc)
        served(sb, "bf16_checked", compare=True)
        del sb
        self.release()

        # 3. bf16 timed (the buckets compiled above: cache hits)
        st = self.scheduler(model, params, geo, compile_cache=cc)
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

    def sdpa(self, sq, sk, causal, window, q_offset):
        """PyTorch's scaled_dot_product_attention with ``flash_mask``'s mask,
        a function of (q, k, v) in its (B, H, S, Dh) layout: by
        ``is_causal`` where the mask is the plain causal one (Sq = Sk, no
        window or offset) or none, so that SDPA may take its fused
        backends, which a boolean mask rules out; by the mask otherwise."""
        import torch.nn.functional as F
        if window is None and (not causal or (q_offset == 0 and sq == sk)):
            return lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=bool(causal))
        mask = self.flash_mask(sq, sk, causal, window, q_offset)
        return lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)

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
    def capture_flash(self, ops=None, kind=None):
        """Route the model's chunked attention (``blocks.attention_chunked``)
        through a function that counts its calls by kind (windowed and
        global, unless ``kind(q, k, causal, window)`` names it), keeps
        the first of each kind's operands in ``ops`` (``flash_ops`` unless
        given), and calls the real one, which launches the kernel."""
        from repro_torch.models import blocks, layers
        ops = self.flash_ops if ops is None else ops

        def fn(q, k, v, *, causal=True, window=None, q_offset=0, bk=1024):
            key = kind(q, k, causal, window) if kind else \
                "global" if window is None else "windowed"
            self.flash_calls[key] += 1
            ops.setdefault(key, (q, k, v, dict(
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
        ratio = self.logit_x_limit(got, want, FWD_LOGIT_TOL)
        check(ratio <= 1, f"chunked forward logits off the naive forward by "
                          f"{ratio:.3g} x the limit")
        max_logit = float(want.abs().max())
        del got, want
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        profile = self.profile_forward(chunked, params, {"tokens": toks},
                                       chunked_s)
        # the serving phases take the same parameters
        self.gemma_state = params
        del params, toks
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

    def profile_forward(self, model, params, batch, wall_s):
        """Where the chunked forward's time goes: one more forward under
        torch.profiler (its own flash_attention launches) — the card's
        busy time (the sum of its kernel times), the idle share against the
        unprofiled forward's wall time, the flash kernel's and the GEMMs'
        (every kernel whose name holds "gemm") shares and the device kernels
        by time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.forward(params, batch)
            torch.cuda.synchronize()
        by_name, calls = Counter(), Counter()
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                by_name[e.name] += e.time_range.elapsed_us()
                calls[e.name] += 1
        busy_ms = sum(by_name.values()) / 1e3
        flash_ms = sum(t for n, t in by_name.items()
                       if "flash_attention_kernel" in n) / 1e3
        gemm_ms = sum(t for n, t in by_name.items()
                      if "gemm" in n.lower()) / 1e3
        return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
                "device_idle_share": max(0.0, 1 - busy_ms / (wall_s * 1e3)),
                "flash_attention_ms": flash_ms,
                "flash_attention_share":
                    flash_ms / busy_ms if busy_ms else None,
                "gemm_ms": gemm_ms,
                "gemm_share": gemm_ms / busy_ms if busy_ms else None,
                "kernels": sum(calls.values()),
                "top_device_kernels": [
                    {"name": n[:80], "ms": t / 1e3, "calls": calls[n]}
                    for n, t in by_name.most_common(6)]}

    def measure_flash(self):
        """flash_attention at the path's own operands (the forward's first
        windowed and first global layer, fp32, and the windowed layer's
        operands in bf16): the float64 check and, in fp32, parity; ms,
        device_ms, plain_ms, library_ms (scaled_dot_product_attention with
        the same mask on GQA-repeated K/V, ``sdpa``) and the bound: 4 Dh flops
        per admitted (q, k) pair over the route's peak (fp32: three tf32
        products on the tensor cores; bf16: the bf16 tensor-core peak), or
        q, k, v and out once over the memory rate, whichever is larger. An
        fp32 row also gives the bound at the FMA peak (``bound_fma_ms``, the
        bound of PRs 17-20). ``sass`` counts the kernel library's tf32 MMAs,
        cp.async copies and atomics."""
        torch = self.torch
        rows = self.flash_rows(
            (key, self.flash_ops[src], dtype)
            for key, src, dtype in (("windowed", "windowed", torch.float32),
                                    ("global", "global", torch.float32),
                                    ("windowed_bf16", "windowed",
                                     torch.bfloat16)))
        sass = sass_counts("flash_attention")
        check(sass["tf32_mma"] > 0 and sass["cp_async"] > 0 and
              sass["atomics"] == 0,
              f"flash_attention's library: {sass} (tensor-core MMAs and "
              f"cp.async expected, no atomics)")
        row = dict(rows["windowed"], sass=sass)
        row["global"] = rows["global"]
        row["windowed_bf16"] = rows["windowed_bf16"]
        return row

    def flash_rows(self, cases):
        """``measure_flash``'s row for each (key, (q, k, v, kwargs), dtype)
        of ``cases``, by key."""
        torch = self.torch
        from repro_torch.kernels.attention import (flash_attention,
                                                   flash_attention_ref)
        rows = {}
        for key, (q, k, v, kw), dtype in cases:
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
            pairs = int(self.flash_mask(Sq, Sk, **kw).sum())
            qt = q.transpose(1, 2)
            kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
                      for x in (k, v))
            library = self.sdpa(Sq, Sk, **kw)

            def sdpa():
                return library(qt, kt, vt)

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
                "shapes": f"B={B}, S={Sq}"
                          f"{'' if Sk == Sq else f', Sk={Sk}'}, Hq={Hq}, "
                          f"Hkv={Hkv}, Dh={Dh}, "
                          f"causal={kw['causal']}, window={kw['window']}, "
                          f"{q.dtype}"}
            if not bf16:
                fma_ms = max(t_bytes, n_ops / FP32_FLOP_PER_S * 1e3)
                rows[key]["bound_fma_ms"] = fma_ms
                rows[key]["bound_fma_share"] = fma_ms / device_ms
            del q, k, v, qt, kt, vt, library
        return rows

    # -- gemma3-4b served: the windowed decode step ------------------------
    def served_model(self, cfg, params):
        """The model of ``cfg`` (bf16 activations, as published) over the
        parameters its forward phase drew; each layer's window goes to
        ``attn_windows`` for ``observe``."""
        from repro_torch.models import TransformerLM
        model = TransformerLM(cfg)
        self.attn_windows = [sp.window for sp in model.layer_specs]
        return model, params

    @contextlib.contextmanager
    def attn_tagged(self, tag):
        """Keep the attention launches of the duration under ``tag``
        (``observe``), apart from starcoder2-3b's."""
        self.attn_tag = tag
        try:
            yield
        finally:
            self.attn_tag = None

    def serve_gemma3(self):
        """gemma3-4b at full width and depth (34 layers, 29 with the
        1,024-token window, Dh 256, 8 query heads GQA-gathered from 4,
        vocab 262,144) answers serve_bench's 64 requests as
        serve_starcoder2 answers them (``serve_runs``: fp32 streams equal
        to the dense loop, bf16 held step by step, bf16 timed, the step's
        profile; 34 attn kernels a bucket, each launched once a step), over
        ``forward_gemma3``'s parameters; then one ``flash`` bucket on the
        largest bucket's kept step: 34 decode_attention launches, logits
        within the bf16 limit of the grid step."""
        from repro_torch.kernels.attention import decode_attention
        model, params = self.served_model(self.gemma_cfg(),
                                          self.gemma_state)
        cfg = model.cfg
        geo = self.geometry(self.gemma_requests)
        prompts = self.prompts(cfg.vocab, geo)
        out = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "windowed_layers": sum(w is not None
                                      for w in self.attn_windows),
               "geometry": geo._asdict()}
        with self.attn_tagged("serve"):
            out.update(self.serve_runs(model, params, prompts, geo))
        before = decode_attention.launches
        out["flash"] = self.flash_bucket(model, params, geo.page)
        self.gemma_flash["serve"] = {
            "launches": decode_attention.launches - before}
        self.step_inputs = self.step_want = None
        return out

    def serve_gemma3_window(self):
        """gemma3-4b served past its window: 8 prompts of 1,040 tokens
        prefilled in 16-token chunks, 24 new tokens each, model length
        2,048, 8 slots. Every decode step runs at bucket (8, 2,048)
        (``Scheduler._buckets``) and the last one's pos is past the window,
        so the windowed layers' masks exclude rows. fp32: 8 of 8 streams
        equal the dense loop, which takes each whole prompt at once; bf16:
        each step held to the torch-level step; the step's profile; then a
        ``flash`` bucket at (8, 2,048), where B H = 64 < 1,056 splits each
        (b, h)'s context into chunks merged after its ticket."""
        torch = self.torch
        from repro_torch.kernels.attention import decode_attention
        from repro_torch.kernels.attention import kernel as attn
        model, params = self.served_model(self.gemma_cfg(),
                                          self.gemma_state)
        cfg = model.cfg
        geo = self.gemma_window_geo
        prompts = self.prompts(cfg.vocab, geo)
        out = {"arch": cfg.name, "window": cfg.window,
               "geometry": geo._asdict()}
        with self.attn_tagged("window"):
            out.update(self.serve_runs(model, params, prompts, geo,
                                       timed=False))
        bucket = f"{geo.slots}x{geo.max_model_len}"
        check(bucket in out["buckets"], f"bucket {bucket} not reached: "
                                        f"{out['buckets']}")
        B, ctx, kwargs = self.step_inputs
        pos = kwargs["positions"]
        check(int(pos.min()) >= cfg.window,
              f"the last step's pos {pos.tolist()} does not pass the "
              f"{cfg.window}-token window")
        out["last_step"] = {"bucket": [B, ctx], "pos": pos.tolist(),
                            "windowed_rows_admitted": cfg.window,
                            "global_rows_admitted": int(pos.max()) + 1}
        plans = {kind: list(attn.plan(B, ctx, cfg.n_heads, cfg.head_dim,
                                      torch.bfloat16, w))
                 for kind, w in (("windowed", cfg.window), ("global", None))}
        check(plans["windowed"][1] > 1 and plans["global"][1] > 1,
              f"decode_attention at {(B, ctx)} does not split: {plans}")
        before = decode_attention.launches
        out["flash"] = self.flash_bucket(model, params, geo.page)
        out["flash"]["plans"] = plans
        self.gemma_flash["window"] = {
            "launches": decode_attention.launches - before, "plans": plans}
        self.step_inputs = self.step_want = None
        return out

    @staticmethod
    def attn_rows(pos, C, window):
        """K/V rows the masked attention reads, summed over the batch: j
        with max(0, pos - window + 1) <= j <= min(pos, C - 1)."""
        p = pos.long()
        lo = (p - window + 1).clamp(min=0) if window else 0 * p
        return int((p.clamp(max=C - 1) - lo + 1).clamp(min=0).sum())

    def attn_bound(self, q, pos, k, window):
        """(K/V rows the mask admits, bytes, operations, bound_ms,
        bound_by) of one decode attention call on this run's pos: q, pos
        and out once, and the admitted K and V rows."""
        B, C, H, Dh = k.shape
        rows_kv = self.attn_rows(pos, C, window)
        nbytes = 2 * q.numel() * q.element_size() + \
            pos.numel() * pos.element_size() + \
            2 * rows_kv * H * Dh * k.element_size()
        ops = 4 * rows_kv * H * Dh
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOP_PER_S * 1e3
        return rows_kv, nbytes, ops, max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"

    def decode_timed(self, what, q, k, v, pos, window):
        """decode_attention's device time warm (``device_ms``) and cold
        (``device_ms_cold``) at one case, beside its bound, SDPA's (the
        same boolean mask), in turns: this, this, SDPA."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.attention import decode_attention
        q, k, v = (t.contiguous() for t in (q, k, v))
        pos = pos.to(torch.int32).contiguous()
        B, C, H, Dh = k.shape
        rows_kv, nbytes, _, bound, _ = self.attn_bound(q, pos, k, window)
        want, tmax, a = self.attn_terms(q, k, v, pos, window)
        out_rel = BF16_ULP if q.dtype == torch.bfloat16 else 0.0
        ok, err, ratio = self.attn_within(
            decode_attention(q, k, v, pos, window=window), want, tmax, a, C,
            Dh, out_rel)
        check(ok, f"decode_attention {what}: {err:.3e} against float64")
        del want, tmax, a
        read = nbytes - 2 * q.numel() * q.element_size()
        copies = [(q, k, v, pos)] + [
            tuple(t.clone() for t in (q, k, v, pos))
            for _ in range(cold_copies(read) - 1)]
        j = torch.arange(C, device=self.dev)
        kinds = {"this": lambda c: (lambda: decode_attention(
            *c, window=window))}

        def sdpa(c):
            qc, kc, vc, pc = c
            mask = j[None, :] <= pc.long()[:, None]
            if window:
                mask &= j[None, :] > pc.long()[:, None] - window
            mask = mask[:, None, None, :]
            kt, vt, q4 = kc.transpose(1, 2), vc.transpose(1, 2), qc[:, :, None]
            return lambda: F.scaled_dot_product_attention(q4, kt, vt,
                                                          attn_mask=mask)
        kinds["sdpa"] = sdpa
        times = {}
        for kind in ("this", "this", "sdpa"):
            fns = [kinds[kind](c) for c in copies]
            t = times.setdefault(kind, {"device_ms": [],
                                        "device_ms_cold": []})
            t["device_ms"].append(self.device_ms(fns[0]))
            t["device_ms_cold"].append(self.device_ms_cold(fns))
        del copies
        mine = times["this"]
        row = {"case": what, "shape": [B, C, H, Dh], "window": window,
               "dtype": str(q.dtype), "rows_kv": rows_kv,
               "cold_copies": cold_copies(read), "bytes": nbytes,
               "bound_ms": bound, "max_abs_err": err, "x_limit": ratio,
               "device_ms": mine["device_ms"],
               "device_ms_cold": mine["device_ms_cold"],
               "share_of_bound": bound / statistics.mean(mine["device_ms"]),
               "share_of_bound_cold": bound / statistics.mean(
                   mine["device_ms_cold"]),
               "library_device_ms": times["sdpa"]["device_ms"][0],
               "library_device_ms_cold": times["sdpa"]["device_ms_cold"][0]}
        return row

    def measure_attention(self, launches):
        """decode_attention and the generated attention row kernel at the
        serving shapes (the operands the main path gave the generated
        kernel): ms, device_ms, device_ms_cold (the operands out of L2),
        plain_ms, library_ms (scaled_dot_product_attention with the same
        boolean mask) and the byte bound; decode_attention also at a long
        context and at gemma3-4b's windowed layers (pos = C - 1), as the
        row's ``timed`` list."""
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

        outs = fresh()
        ptx = self.ptx_loads(cuda_backend.launch_kernel(
            kernel.desc, kernel.source, ins, outs))
        (oname,) = outs
        grid = self.grid_timed("serving", kernel, program, values, current,
                               None)
        want, tmax, a = self.attn_terms(q, k, v, pos, None)
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
        del want, tmax, a
        j = torch.arange(C, device=self.dev)
        mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
        kt, vt, q4 = k.transpose(1, 2), v.transpose(1, 2), q[:, :, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask)

        lib, lib_device = self.time_ms(sdpa), self.device_ms(sdpa)
        # the function needs only the K/V rows its mask admits (this run's
        # pos): q, pos and out once, and 2 x those rows of K and V
        rows_kv, nbytes, ops, bound, bound_by = (
            grid[key] for key in ("rows_kv", "bytes", "ops", "bound_ms",
                                  "bound_by"))
        shape = (f"B={B}, C={C}, H={H}, Dh={Dh}, {q.dtype}, "
                 f"{rows_kv} of {B * C} K/V rows unmasked")
        timed = [self.decode_timed("serving", q, k, v, pos, None)]
        for what, b_, c_, h_, d_, win in self.attn_timed:
            qx, kx, vx, _ = self.attn_inputs(b_, c_, h_, d_, torch.bfloat16,
                                             700 + c_)
            px = torch.full((b_,), c_ - 1, dtype=torch.int32,
                            device=self.dev)
            timed.append(self.decode_timed(what, qx, kx, vx, px, win))
            del qx, kx, vx
        serving = timed[0]
        rows = {
            "decode_attention": {
                "max_abs_err": herr, "x_limit": hratio,
                "ms": self.time_ms(lambda: decode_attention(q, k, v, pos)),
                "device_ms": statistics.mean(serving["device_ms"]),
                "device_ms_cold": statistics.mean(serving["device_ms_cold"]),
                "share_of_bound_cold": serving["share_of_bound_cold"],
                "plain_ms": self.time_ms(
                    lambda: decode_attention_ref(q, k, v, pos)),
                "library_ms": lib, "library_device_ms": lib_device,
                "library_device_ms_cold": serving["library_device_ms_cold"],
                "bytes": nbytes, "ops": ops, "bound_ms": bound,
                "bound_by": bound_by,
                "timed": timed,
                "launches_per_step": self.attn_layers,
                "shapes": shape},
            f"grid_kernel:{ATTN_KEY}": {
                "emitter": "grid_kernel", "max_abs_err": grid["max_abs_err"],
                "x_limit": grid["x_limit"],
                "ms": self.time_ms(lambda: cuda_backend.launch_kernel(
                    kernel.desc, kernel.source, ins, outs)),
                "device_ms": grid["device_ms"],
                "device_ms_cold": grid["device_ms_cold"],
                "share_of_bound_cold": grid["share_of_bound_cold"],
                "plain_ms": self.time_ms(plain_grid, reps=3, warmup=1),
                "library_ms": lib, "library_device_ms": lib_device,
                "library_device_ms_cold": serving["library_device_ms_cold"],
                "bytes": nbytes, "ops": ops, "bound_ms": bound,
                "bound_by": bound_by, "ptx": ptx,
                "range_fault": {"max_abs_err": ferr, "x_limit": fratio},
                "launches": sum(n for name, n in launches.items()
                                if ATTN_RE.fullmatch(name)),
                "launches_per_step": self.attn_layers,
                "shapes": shape}}
        return rows


    def grid_timed(self, what, kernel, program, values, current, window):
        """The generated attention row kernel at one case: checked against
        float64, a repeat byte-identical, its device time warm
        (``device_ms``) and cold (``device_ms_cold``) beside its bound."""
        torch = self.torch
        from repro_torch.codegen import cuda_backend
        by_conn = {es.conn: values[es.data] for es in program.spec.inputs}
        q, k, v, pos = (by_conn[c] for c in ("q", "k", "v", "pos"))
        B, C, H, Dh = k.shape
        ins = {c: (t.reshape(1) if t.dim() == 0 else t).contiguous()
               for c, t in values.items()}

        def fresh():
            return {c: t.clone() for c, t in current.items()}

        def launch(inputs, outs):
            return cuda_backend.launch_kernel(kernel.desc, kernel.source,
                                              inputs, outs)

        want, tmax, a = self.attn_terms(q, k, v, pos, window)
        outs, again = fresh(), fresh()
        launch(ins, outs)
        launch(ins, again)
        (oname,) = outs
        check(torch.equal(outs[oname], again[oname]),
              f"{ATTN_KEY} {what}: repeat runs differ")
        ok, err, ratio = self.attn_within(outs[oname], want, tmax, a, C, Dh,
                                          BF16_ULP)
        check(ok, f"{ATTN_KEY} {what} vs float64: {err:.3e}")
        del want, tmax, a, again
        rows_kv, nbytes, ops, bound, bound_by = self.attn_bound(q, pos, k,
                                                                window)
        n_copies = cold_copies(nbytes - 2 * q.numel() * q.element_size())
        copies = [ins] + [{c: t.clone() for c, t in ins.items()}
                          for _ in range(n_copies - 1)]
        cold = self.device_ms_cold(
            [functools.partial(launch, c, fresh()) for c in copies])
        del copies
        warm = self.device_ms(lambda: launch(ins, outs))
        return {"case": what, "shape": [B, C, H, Dh], "window": window,
                "dtype": str(q.dtype), "pos": sorted(set(pos.tolist())),
                "rows_kv": rows_kv, "bytes": nbytes, "ops": ops,
                "bound_ms": bound, "bound_by": bound_by,
                "max_abs_err": err, "x_limit": ratio,
                "device_ms": warm, "device_ms_cold": cold,
                "share_of_bound_cold": bound / cold}

    def measure_gemma_attention(self):
        """The generated attention row kernel and decode_attention at
        gemma3-4b's two served shapes in bf16: the serving bucket (B 64,
        C 64, H 8, Dh 256) on the served step's own operands (pos 38), and
        the window run's bucket (B 8, C 2,048, window 1,024) on seeded
        operands at pos = C - 1 (1,024 rows admitted a (b, h), as at the
        served pos past the window); both the windowed layers' kernels.
        Each with its device time warm and cold, its bound (the bytes of
        the admitted K/V rows), its launches on the main path at that
        shape, and SDPA's device time with the same boolean mask
        (``library_ms``, warm; ``library_device_ms_cold``)."""
        torch = self.torch
        window = self.gemma_cfg().window
        rows = {"attn": [], "decode": []}
        for tag in ("serve", "window"):
            kernel, program, values, current = \
                self.gemma_captured[(tag, "windowed")]
            data = {es.conn: es.data for es in program.spec.inputs}
            values = dict(values)
            B, C, H, Dh = values[data["k"]].shape
            if tag == "window":
                q, k, v, _ = self.attn_inputs(B, C, H, Dh, torch.bfloat16,
                                              900 + C)
                pos = torch.full((B,), C - 1, dtype=torch.int32,
                                 device=self.dev)
                values.update({data["q"]: q, data["k"]: k, data["v"]: v,
                               data["pos"]: pos})
            q, k, v, pos = (values[data[c]] for c in ("q", "k", "v", "pos"))
            what = f"gemma3-4b {tag} bucket"
            d = self.decode_timed(what, q, k, v, pos, window)
            d.update(launches=self.gemma_flash[tag]["launches"],
                     library_ms=d["library_device_ms"],
                     pos=sorted(set(pos.tolist())))
            g = self.grid_timed(what, kernel, program, values, current,
                                window)
            g.update(launches=self.gemma_launches[(tag, B, C)],
                     library_ms=d["library_device_ms"],
                     library_device_ms_cold=d["library_device_ms_cold"])
            rows["decode"].append(d)
            rows["attn"].append(g)
            del q, k, v, values
        return rows

    # -- the MoE family: llama4-scout-17b-a16e -----------------------------
    def llama_cfg(self):
        """llama4-scout-17b-a16e as published, cut to ``llama_layers``
        layers (``llama_config`` replaces it whole)."""
        from repro_torch.configs import get_config
        if self.llama_config is not None:
            return self.llama_config
        return dataclasses.replace(get_config(self.llama_arch),
                                   n_layers=self.llama_layers)

    def drop_kept(self):
        """Drop the operands the earlier paths kept for their measurements
        (~16 GB: the generated kernels' last launches, the WKV, flash and
        gemma3-4b attention operands, gemver's inputs) once those are
        measured, before llama4-scout's weights (43.5 GB at 4 layers)."""
        for kept in (self.captured, self.gemma_captured, self.wkv_ops,
                     self.flash_ops):
            kept.clear()
        self.gemver_inputs = None
        self.free_gemma3()

    def free_gemma3(self):
        """Drop gemma3-4b's weights (17 GB in fp32) and its kept step before
        llama4-scout's (43.5 GB at 4 layers); the serving runs' cycles hold
        them until the collector runs."""
        self.gemma_state = None
        self.step_inputs = self.step_want = None
        gc.collect()
        self.torch.cuda.empty_cache()

    def forward_llama4(self):
        """TransformerLM.forward at llama4-scout's full width and
        ``llama_layers`` layers on batch x seq tokens, fp32 activations,
        attention_impl="chunked": flash_attention launches once a layer, at
        Hq 40, Hkv 8, Dh 128, and the logits stay within 2^-12 of the row's
        largest |logit| of the naive forward. Every layer's FFN is the MoE
        block with the config's onehot dispatch in eval mode (capacity = T:
        16 experts over 4,096 slots each); on layer 0's MoE input the sort
        dispatch gives the onehot one's output within the reference's
        rtol/atol 2e-4 and its aux loss within rtol 1e-5; then one profiled
        forward."""
        torch = self.torch
        from repro_torch.kernels.attention import flash_attention
        from repro_torch.models import TransformerLM, blocks, layers
        self.free_gemma3()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cfg = self.llama_cfg()
        B, S = self.llama_batch, self.llama_seq
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
        g = torch.Generator().manual_seed(self.seed + 3)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=g).to(self.dev)
        self.flash_calls.clear()
        self.llama_flash_ops.clear()
        moe_in = []

        def recorded(*args, **kw):
            if not moe_in:
                moe_in.append((args, kw))
            return layers.moe_block(*args, **kw)

        before = flash_attention.launches
        blocks.moe_block = recorded
        try:
            with self.capture_flash(self.llama_flash_ops):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, aux = chunked.forward(params, {"tokens": toks})
                torch.cuda.synchronize()
                chunked_s = time.perf_counter() - t0
        finally:
            blocks.moe_block = layers.moe_block
        n = flash_attention.launches - before
        check(n == cfg.n_layers, f"forward launched flash_attention {n} "
                                 f"times, not {cfg.n_layers}")
        calls = dict(self.flash_calls)
        check(calls == {"global": cfg.n_layers},
              f"forward's chunked attention calls {calls}")
        q, k, _, _ = self.llama_flash_ops["global"]
        heads = [q.shape[2], k.shape[2], q.shape[3]]
        check(heads == [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
              f"flash_attention's heads (Hq, Hkv, Dh) {heads}")
        del q, k
        check(tuple(got.shape) == (B, S, chunked.vocab_padded),
              f"forward logits {tuple(got.shape)}")
        got = got[..., :cfg.vocab]
        check(bool(torch.isfinite(got).all()), "forward: non-finite logits")
        check(bool(torch.isfinite(aux)) and float(aux) > 0,
              f"forward's aux loss {float(aux)}")
        # the logits (3.3 GB) wait on the host while the naive forward runs
        # beside what the earlier phases keep for the measurements
        got = got.cpu()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, naive_aux = naive.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t0
        check(flash_attention.launches - before == n,
              "the naive forward launched flash_attention")
        want = want[..., :cfg.vocab]
        ratio = self.logit_x_limit(got, want, FWD_LOGIT_TOL)
        check(ratio <= 1, f"chunked forward logits off the naive forward by "
                          f"{ratio:.3g} x the limit")
        max_logit = float(want.abs().max())
        del got, want
        # the two dispatches on layer 0's MoE input (eval mode: capacity T)
        (args, kw), = moe_in
        del moe_in
        runs = {}
        for name in ("onehot", "sort"):
            def fn(name=name):
                return layers.moe_block(*args, **dict(kw, dispatch=name))
            runs[name] = fn() + (self.time_ms(fn, reps=3, warmup=1),)
        (out1, aux1, ms1), (out2, aux2, ms2) = runs["onehot"], runs["sort"]
        sort_ratio = float(((out2 - out1).abs() /
                            (2e-4 + 2e-4 * out1.abs())).max())
        aux_rel = abs(float(aux2) - float(aux1)) / abs(float(aux1))
        check(sort_ratio <= 1 and aux_rel <= 1e-5,
              f"sort dispatch off onehot by {sort_ratio:.3g} x rtol/atol "
              f"2e-4, aux by {aux_rel:.3g} relative")
        dispatch = {"tokens": int(args[0].shape[0] * args[0].shape[1]),
                    "x_limit": sort_ratio, "aux_rel_err": aux_rel,
                    "onehot_ms": ms1, "sort_ms": ms2,
                    "max_abs_out": float(out1.abs().max())}
        del args, kw, runs, out1, out2
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        profile = self.profile_forward(chunked, params, {"tokens": toks},
                                       chunked_s)
        # the serving phase takes the same parameters
        self.llama_state = params
        del params, toks
        torch.cuda.empty_cache()
        m = cfg.moe
        return {"arch": cfg.name, "n_layers": cfg.n_layers,
                "n_layers_published": 48, "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
                "experts": {"n": m.n_experts, "top_k": m.top_k,
                            "d_ff": m.d_ff_expert,
                            "shared": m.shared_expert},
                "tokens": [B, S], "param_init_seconds": init_s,
                "n_params": n_params,
                "forward_seconds": {"chunked": chunked_s, "naive": naive_s},
                "flash_attention_launches": n, "attention_calls": calls,
                "logits_x_limit": ratio, "max_abs_logit": max_logit,
                "aux": {"chunked": float(aux), "naive": float(naive_aux)},
                "sort_vs_onehot": dispatch,
                "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9,
                "profile": profile}

    def serve_llama4(self):
        """llama4-scout at full width and ``llama_layers`` layers answers
        serve_bench's 64 requests as serve_gemma3 does (``serve_runs``:
        fp32 streams equal to the dense loop, bf16 held step by step, bf16
        timed, the step's profile), over ``forward_llama4``'s parameters;
        every replayed bf16 step is byte-identical to the eager one; then
        one ``flash`` bucket (decode_attention at H 40 from Hkv 8, each
        launched once a layer) within the bf16 limit of the grid step. The
        MoE FFN runs in the step with capacity B (eval mode), its expert
        weights cast to bf16 each step as the reference's ``astype``."""
        torch = self.torch
        from repro_torch.kernels.attention import decode_attention
        self.release()
        model, params = self.served_model(self.llama_cfg(),
                                          self.llama_state)
        cfg = model.cfg
        geo = self.geometry(self.llama_requests)
        prompts = self.prompts(cfg.vocab, geo)
        out = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "n_layers_published": 48, "geometry": geo._asdict()}
        with self.attn_tagged("llama4"):
            out.update(self.serve_runs(model, params, prompts, geo))
        vs = out["bf16_checked"]["captured_vs_eager"]
        check(vs["byte_identical"] == vs["replays"],
              f"replayed bf16 steps: {vs['byte_identical']} of "
              f"{vs['replays']} byte-identical to the eager step")
        before = decode_attention.launches
        out["flash"] = self.flash_bucket(model, params, geo.page)
        self.gemma_flash["llama4"] = {
            "launches": decode_attention.launches - before}
        torch.cuda.synchronize()
        # from the timed run's start (``timed`` resets the peak) to here
        out["peak_mem_gb_from_timed"] = \
            torch.cuda.max_memory_allocated() / 1e9
        self.step_inputs = self.step_want = None
        self.llama_state = None
        return out

    def measure_llama_attention(self):
        """The generated attention row kernel and decode_attention at
        llama4-scout's served bucket in bf16 (B 64, C 64, H 40 gathered
        from 8 KV heads, Dh 128) on the served step's own operands, as
        ``measure_gemma_attention`` measures gemma3-4b's; and
        flash_attention at the forward's layer-0 operands (B 2, S 2,048,
        Hq 40, Hkv 8, Dh 128, causal) in fp32 and bf16, as
        ``measure_flash`` measures gemma3-4b's."""
        torch = self.torch
        kernel, program, values, current = \
            self.gemma_captured[("llama4", "global")]
        data = {es.conn: es.data for es in program.spec.inputs}
        q, k, v, pos = (values[data[c]] for c in ("q", "k", "v", "pos"))
        B, C, H, Dh = k.shape
        what = "llama4-scout serve bucket"
        d = self.decode_timed(what, q, k, v, pos, None)
        d.update(launches=self.gemma_flash["llama4"]["launches"],
                 library_ms=d["library_device_ms"],
                 pos=sorted(set(pos.tolist())))
        g = self.grid_timed(what, kernel, program, values, current, None)
        g.update(launches=self.gemma_launches[("llama4", B, C)],
                 library_ms=d["library_device_ms"],
                 library_device_ms_cold=d["library_device_ms_cold"])
        ops = self.llama_flash_ops["global"]
        flash = self.flash_rows((("global", ops, torch.float32),
                                 ("global_bf16", ops, torch.bfloat16)))
        return {"decode": d, "attn": g, "flash": flash}

    # -- the hybrid family: jamba-1.5-large-398b ---------------------------
    def jamba_cfg(self):
        """jamba-1.5-large-398b as published, cut to ``jamba_layers``
        layers (``jamba_config`` replaces it whole)."""
        from repro_torch.configs import get_config
        if self.jamba_config is not None:
            return self.jamba_config
        return dataclasses.replace(get_config(self.jamba_arch),
                                   n_layers=self.jamba_layers)

    def free_llama4(self):
        """Drop what llama4-scout's path and measurements kept (its weights,
        its prefill and served attention operands) before jamba's weights
        (47.6 GB at 2 layers)."""
        self.llama_state = None
        self.llama_flash_ops.clear()
        self.gemma_captured.clear()
        self.step_inputs = self.step_want = None
        gc.collect()
        self.torch.cuda.empty_cache()

    def forward_jamba(self):
        """TransformerLM.forward at jamba-1.5-large-398b's full width and
        ``jamba_layers`` layers on batch x seq tokens, fp32 activations,
        attention_impl="chunked". At 2 layers, layer 0 is attention
        (flash_attention once, Hq 64, Hkv 8, Dh 128) with the dense FFN and
        layer 1 is Mamba (Din 16,384, N 16, d_conv 4) with the MoE FFN (16
        experts of d_ff 24,576, top-2, eval capacity T), so all four block
        kinds run. The logits stay within 2^-12 of the row's largest
        |logit| of the naive forward; the first Mamba layer's chunked scan
        (its operands kept as the forward calls it) within rtol/atol 2e-4
        of a float64 step-by-step scan (``ssm_check``); then one profiled
        forward."""
        torch = self.torch
        from repro_torch.kernels.attention import flash_attention
        from repro_torch.models import TransformerLM, blocks
        self.free_llama4()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cfg = self.jamba_cfg()
        B, S = self.jamba_batch, self.jamba_seq
        chunked = TransformerLM(dataclasses.replace(
            cfg, attention_impl="chunked", activation_dtype="float32"))
        naive = TransformerLM(dataclasses.replace(
            cfg, attention_impl="naive", activation_dtype="float32"))
        kinds = [(sp.kind, sp.is_moe) for sp in chunked.layer_specs]
        check({k for k, _ in kinds} == {"attn", "mamba"} and
              {m for _, m in kinds} == {True, False},
              f"jamba's layers {kinds} miss a block kind")
        t0 = time.perf_counter()
        params = chunked.init(torch.Generator(device=self.dev).manual_seed(
            self.seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in _leaves(params))
        g = torch.Generator().manual_seed(self.seed + 4)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=g).to(self.dev)
        self.flash_calls.clear()
        self.jamba_flash_ops.clear()
        self.ssm_ops.clear()
        scan = blocks._ssm_scan_chunked

        def recorded(u, ldA, dBu, C, state0, **kw):
            y, last = scan(u, ldA, dBu, C, state0, **kw)
            if not self.ssm_ops:
                self.ssm_ops.update(ldA=ldA, dBu=dBu, C=C, state0=state0,
                                    y=y, state=last)
            return y, last

        n_attn = len(attention_layers(chunked))
        before = flash_attention.launches
        blocks._ssm_scan_chunked = recorded
        try:
            with self.capture_flash(self.jamba_flash_ops):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, aux = chunked.forward(params, {"tokens": toks})
                torch.cuda.synchronize()
                chunked_s = time.perf_counter() - t0
        finally:
            blocks._ssm_scan_chunked = scan
        n = flash_attention.launches - before
        check(n == n_attn, f"forward launched flash_attention {n} times, "
                           f"not {n_attn}")
        check(bool(self.ssm_ops), "the forward took no chunked scan")
        q, k, _, _ = self.jamba_flash_ops["global"]
        heads = [q.shape[2], k.shape[2], q.shape[3]]
        check(heads == [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
              f"flash_attention's heads (Hq, Hkv, Dh) {heads}")
        del q, k
        check(tuple(got.shape) == (B, S, chunked.vocab_padded),
              f"forward logits {tuple(got.shape)}")
        got = got[..., :cfg.vocab]
        check(bool(torch.isfinite(got).all()), "forward: non-finite logits")
        check(bool(torch.isfinite(aux)) and float(aux) > 0,
              f"forward's aux loss {float(aux)}")
        got = got.cpu()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, naive_aux = naive.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t0
        check(flash_attention.launches - before == n,
              "the naive forward launched flash_attention")
        want = want[..., :cfg.vocab]
        ratio = self.logit_x_limit(got, want, FWD_LOGIT_TOL)
        check(ratio <= 1, f"chunked forward logits off the naive forward by "
                          f"{ratio:.3g} x the limit")
        max_logit = float(want.abs().max())
        del got, want
        ssm = self.ssm_check()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        profile = self.profile_forward(chunked, params, {"tokens": toks},
                                       chunked_s)
        # the serving phase takes the same parameters
        self.jamba_state = params
        del params, toks
        torch.cuda.empty_cache()
        m = cfg.moe
        return {"arch": cfg.name, "n_layers": cfg.n_layers,
                "n_layers_published": 72, "d_model": cfg.d_model,
                "layers": [list(kd) for kd in kinds],
                "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
                "mamba": {"d_inner": cfg.expand * cfg.d_model,
                          "d_state": cfg.d_state, "d_conv": cfg.d_conv},
                "experts": {"n": m.n_experts, "top_k": m.top_k,
                            "d_ff": m.d_ff_expert},
                "tokens": [B, S], "param_init_seconds": init_s,
                "n_params": n_params,
                "forward_seconds": {"chunked": chunked_s, "naive": naive_s},
                "flash_attention_launches": n,
                "logits_x_limit": ratio, "max_abs_logit": max_logit,
                "aux": {"chunked": float(aux), "naive": float(naive_aux)},
                "ssm_scan": ssm,
                "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9,
                "profile": profile}

    def ssm_check(self):
        """The chunked scan the forward ran (``ssm_ops``: its (B, S, Din, N)
        log decays and inputs, its C, its zero start state, its y and last
        state) against a float64 scan over time on the same operands, each
        element within SSM_TOL + SSM_TOL |want| (the reference's
        ``tests/test_wkv_ssm.py``); and, as a control, the same chunked scan
        with its carried state dropped at the middle chunk, which must fail
        that limit. Frees the operands."""
        torch = self.torch
        from repro_torch.models import blocks
        ops = self.ssm_ops
        ldA, dBu, C, state0 = (ops[k] for k in ("ldA", "dBu", "C", "state0"))
        Bsz, S, Din, N = ldA.shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = state0.double()
        ys = []
        for t in range(S):
            state = torch.exp(ldA[:, t].double()) * state + dBu[:, t].double()
            ys.append((state * C[:, t, None, :].double()).sum(-1))
        want = torch.stack(ys, 1)
        del ys
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0

        def x_limit(y, last):
            return max(float(((a.double() - w).abs() /
                              (SSM_TOL + SSM_TOL * w.abs())).max())
                       for a, w in ((y, want), (last, state)))

        ratio = x_limit(ops["y"], ops["state"])
        check(ratio <= 1, f"the chunked scan off float64 by {ratio:.3g} x "
                          f"rtol/atol {SSM_TOL}")
        half = S // 2 // blocks.SSM_CHUNK * blocks.SSM_CHUNK
        ya, _ = blocks._ssm_scan_chunked(ldA[:, :half, :, 0], ldA[:, :half],
                                         dBu[:, :half], C[:, :half], state0)
        yb, lb = blocks._ssm_scan_chunked(
            ldA[:, half:, :, 0], ldA[:, half:], dBu[:, half:], C[:, half:],
            torch.zeros_like(state0))
        fault = x_limit(torch.cat([ya, yb], 1), lb)
        check(fault > 1, f"the chunked scan without its state carried past "
                         f"position {half} passed the limit ({fault:.3g} x)")
        self.faults.append({"fault": f"ssm scan state dropped at {half}",
                            "x_limit": fault})
        out = {"shape": [Bsz, S, Din, N], "x_limit": ratio,
               "max_abs_err": float((ops["y"].double() - want).abs().max()),
               "max_abs_y": float(want.abs().max()),
               "float64_scan_seconds": ref_s,
               "state_dropped_x_limit": fault}
        ops.clear()
        return out

    def cast_params(self, tree, dtype):
        """Cast ``tree``'s parameters to ``dtype`` in place, one at a time
        (each fp32 tensor freed as its copy is made), all but the norms'
        scales and biases, which an init makes in float32 whatever its
        ``param_dtype``."""
        if isinstance(tree, list):
            for v in tree:
                self.cast_params(v, dtype)
            return
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                self.cast_params(v, dtype)
            elif not NORM_KEY.fullmatch(k):
                tree[k] = v.to(dtype)

    def serve_jamba(self):
        """jamba at full width and ``jamba_layers`` layers answers
        serve_bench's 64 requests (``serve_runs``): fp32 streams equal to
        the dense decode_step loop over ``forward_jamba``'s fp32 weights;
        then the weights cast to bf16 in place (``param_dtype="bfloat16"``,
        a field of the reference's config) for the bf16 runs, since the
        fp32 experts (38.7 GB) do not fit beside their bf16 copies in a
        captured step's pool and in the eager steps it is held to: each
        step held to the torch-level step over the real vocab (a row the
        two route to other experts held at its router input), every
        replay byte-identical to the eager step, bf16 timed, the step's
        profile; then one ``flash`` bucket (decode_attention at the
        attention layer). Each Mamba layer is a tasklet of the step that
        reads and writes its slots' conv and ssm rows; each prompt of 16
        is prefilled as one chunk, the chunked scan."""
        torch = self.torch
        from repro_torch.kernels.attention import decode_attention
        from repro_torch.models import TransformerLM
        from repro_torch.serving import state_specs
        self.release()
        params = self.jamba_state
        served, _ = self.served_model(self.jamba_cfg(), params)
        cfg = served.cfg
        geo = self.geometry(self.jamba_requests)
        prompts = self.prompts(cfg.vocab, geo)
        specs = state_specs(served)
        out = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "n_layers_published": 72, "geometry": geo._asdict(),
               "state_rows": sorted(specs),
               "state_mb_per_slot": sum(
                   math.prod(shape) * 4 for _, shape, _ in specs.values())
               / 1e6}
        # the model of the bf16 runs and the flash bucket
        model = TransformerLM(dataclasses.replace(cfg,
                                                  param_dtype="bfloat16"))

        def bf16():
            self.cast_params(params, torch.bfloat16)
            self.release()
            return model, params
        with self.attn_tagged("jamba"):
            out.update(self.serve_runs(served, params, prompts, geo,
                                       bf16=bf16))
        vs = out["bf16_checked"]["captured_vs_eager"]
        check(vs["byte_identical"] == vs["replays"],
              f"replayed bf16 steps: {vs['byte_identical']} of "
              f"{vs['replays']} byte-identical to the eager step")
        before = decode_attention.launches
        out["flash"] = self.flash_bucket(model, params, geo.page)
        out["flash"]["decode_attention_launches"] = \
            decode_attention.launches - before
        torch.cuda.synchronize()
        out["peak_mem_gb_from_timed"] = \
            torch.cuda.max_memory_allocated() / 1e9
        self.step_inputs = self.step_want = None
        self.jamba_state = None
        return out

    # -- the VLM family: phi-3-vision-4.2b ---------------------------------
    def phi3_cfg(self):
        from repro_torch.configs import get_config
        return self.phi3_config or get_config(self.phi3_arch)

    def free_jamba(self):
        """Drop jamba's weights (23.8 GB in bf16 after its serving runs) and
        what its path kept before phi-3-vision's (15.3 GB in fp32)."""
        self.jamba_state = None
        self.jamba_flash_ops.clear()
        self.ssm_ops.clear()
        self.gemma_captured.clear()
        self.step_inputs = self.step_want = None
        gc.collect()
        self.torch.cuda.empty_cache()

    def forward_phi3(self):
        """TransformerLM.forward at phi-3-vision-4.2b's full width and depth
        (32 layers, d_model 3,072, 32 heads of Dh 96, d_ff 8,192, vocab
        32,064 padded to 32,256), fp32 activations,
        attention_impl="chunked", on batch x (576 stub embeddings +
        ``phi3_text`` tokens): ``stub_proj`` projects the seeded N(0, 1)
        embeddings (as the reference's ``example_batch`` draws them) in
        front of the text, flash_attention launches once a layer at Dh 96
        over all the positions, and only the text positions' logits come
        back, within 2^-12 of the row's largest |logit| of the naive
        forward and outside it without the stub; then one profiled
        forward."""
        torch = self.torch
        from repro_torch.kernels.attention import flash_attention
        from repro_torch.models import TransformerLM
        self.free_jamba()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cfg = self.phi3_cfg()
        B, T = self.phi3_batch, self.phi3_text
        n_stub = cfg.n_stub_tokens
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
        g = torch.Generator().manual_seed(self.seed + 5)
        toks = torch.randint(0, cfg.vocab, (B, T), generator=g).to(self.dev)
        batch = {"tokens": toks,
                 "stub_embeds": self.randn(B, n_stub, cfg.d_model, seed=5)}
        self.flash_calls.clear()
        self.phi3_flash_ops.clear()
        before = flash_attention.launches
        with self.capture_flash(self.phi3_flash_ops):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _ = chunked.forward(params, batch)
            torch.cuda.synchronize()
            chunked_s = time.perf_counter() - t0
        n = flash_attention.launches - before
        check(n == cfg.n_layers, f"forward launched flash_attention {n} "
                                 f"times, not {cfg.n_layers}")
        calls = dict(self.flash_calls)
        check(calls == {"global": cfg.n_layers},
              f"forward's chunked attention calls {calls}")
        q, k, _, _ = self.phi3_flash_ops["global"]
        heads = [q.shape[1], q.shape[2], k.shape[2], q.shape[3]]
        check(heads == [n_stub + T, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim],
              f"flash_attention's (S, Hq, Hkv, Dh) {heads}")
        del q, k
        check(tuple(got.shape) == (B, T, chunked.vocab_padded),
              f"forward logits {tuple(got.shape)}: not the text positions")
        got = got[..., :cfg.vocab]
        check(bool(torch.isfinite(got).all()), "forward: non-finite logits")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = naive.forward(params, batch)
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t0
        check(flash_attention.launches - before == n,
              "the naive forward launched flash_attention")
        want = want[..., :cfg.vocab]
        ratio = self.logit_x_limit(got, want, FWD_LOGIT_TOL)
        check(ratio <= 1, f"chunked forward logits off the naive forward by "
                          f"{ratio:.3g} x the limit")
        del got
        with self.uncounted():
            text, _ = chunked.forward(params, {"tokens": toks})
        text_ratio = self.logit_x_limit(text[..., :cfg.vocab], want,
                                        FWD_LOGIT_TOL)
        check(text_ratio > 1, f"the text alone gives the stub forward's "
                              f"logits ({text_ratio:.3g} x the limit)")
        max_logit = float(want.abs().max())
        del text, want
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        profile = self.profile_forward(chunked, params, batch, chunked_s)
        self.phi3_state = params
        del params, batch, toks
        torch.cuda.empty_cache()
        return {"arch": cfg.name, "n_layers": cfg.n_layers,
                "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
                "vocab": [cfg.vocab, chunked.vocab_padded],
                "positions": [B, n_stub, T], "param_init_seconds": init_s,
                "n_params": n_params,
                "forward_seconds": {"chunked": chunked_s, "naive": naive_s},
                "flash_attention_launches": n,
                "logits_x_limit": ratio, "max_abs_logit": max_logit,
                "text_only_x_limit": text_ratio,
                "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9,
                "profile": profile}

    def serve_phi3(self):
        """phi-3-vision at full width and depth answers serve_bench's 64
        text requests as serve_llama4 does (``serve_runs``: fp32 streams
        equal to the dense loop, bf16 held step by step, every replay
        byte-identical to the eager step, bf16 timed, the step's profile;
        32 attn kernels a bucket at Dh 96), over ``forward_phi3``'s
        parameters; then one ``flash`` bucket (32 decode_attention
        launches, 192-byte bf16 rows)."""
        torch = self.torch
        from repro_torch.kernels.attention import decode_attention
        self.release()
        model, params = self.served_model(self.phi3_cfg(), self.phi3_state)
        cfg = model.cfg
        geo = self.geometry(self.phi3_requests)
        prompts = self.prompts(cfg.vocab, geo)
        out = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "head_dim": cfg.head_dim, "geometry": geo._asdict()}
        with self.attn_tagged("phi3"):
            out.update(self.serve_runs(model, params, prompts, geo))
        vs = out["bf16_checked"]["captured_vs_eager"]
        check(vs["byte_identical"] == vs["replays"],
              f"replayed bf16 steps: {vs['byte_identical']} of "
              f"{vs['replays']} byte-identical to the eager step")
        before = decode_attention.launches
        out["flash"] = self.flash_bucket(model, params, geo.page)
        self.gemma_flash["phi3"] = {
            "launches": decode_attention.launches - before}
        torch.cuda.synchronize()
        out["peak_mem_gb_from_timed"] = \
            torch.cuda.max_memory_allocated() / 1e9
        self.step_inputs = self.step_want = None
        self.phi3_state = None
        return out

    def measure_phi3_attention(self):
        """The generated attention row kernel and decode_attention at
        phi-3-vision's served bucket in bf16 (B 64, C 64, H 32, Dh 96) on
        the served step's own operands, as ``measure_llama_attention``
        measures llama4-scout's; and flash_attention at the forward's
        layer-0 operands (B 2, S 2,048 = 576 stub + 1,472 text, H 32,
        Dh 96, causal) in fp32 and bf16."""
        torch = self.torch
        kernel, program, values, current = \
            self.gemma_captured[("phi3", "global")]
        data = {es.conn: es.data for es in program.spec.inputs}
        q, k, v, pos = (values[data[c]] for c in ("q", "k", "v", "pos"))
        B, C, H, Dh = k.shape
        what = "phi-3-vision serve bucket"
        d = self.decode_timed(what, q, k, v, pos, None)
        d.update(launches=self.gemma_flash["phi3"]["launches"],
                 library_ms=d["library_device_ms"],
                 pos=sorted(set(pos.tolist())))
        g = self.grid_timed(what, kernel, program, values, current, None)
        g.update(launches=self.gemma_launches[("phi3", B, C)],
                 library_ms=d["library_device_ms"],
                 library_device_ms_cold=d["library_device_ms_cold"])
        ops = self.phi3_flash_ops["global"]
        flash = self.flash_rows((("global", ops, torch.float32),
                                 ("global_bf16", ops, torch.bfloat16)))
        self.phi3_flash_ops.clear()
        self.gemma_captured.clear()
        return {"decode": d, "attn": g, "flash": flash}

    # -- the enc-dec family: seamless-m4t-medium ---------------------------
    def seamless_cfg(self):
        from repro_torch.configs import get_config
        return self.seamless_config or get_config(self.seamless_arch)

    @staticmethod
    def seamless_kind(q, k, causal, window):
        """An enc-dec chunked attention call's kind: the decoder's causal
        self-attention, or a non-causal one, the encoder's (as many queries
        as frames) or the decoder's cross-attention over the frames."""
        if causal:
            return "self"
        return "encoder" if q.shape[1] == k.shape[1] else "cross"

    @contextlib.contextmanager
    def causal_encoder(self):
        """A planted fault: the encoder's self-attention (the model's only
        non-causal attention that projects its own K/V) made causal."""
        from repro_torch.models import blocks
        real = blocks.attn_apply

        def fn(cfg, p, x, *, causal=True, kv_override=None, **kw):
            return real(cfg, p, x, causal=causal or kv_override is None,
                        kv_override=kv_override, **kw)
        blocks.attn_apply = fn
        try:
            yield
        finally:
            blocks.attn_apply = real

    @contextlib.contextmanager
    def late_cache(self):
        """A planted fault: every self-attention cache write lands one
        position late (the step's own K/V masked out, a zero row in its
        place)."""
        from repro_torch.models import blocks
        real = blocks._update_slice
        blocks._update_slice = lambda cache, new, pos: real(cache, new,
                                                            pos + 1)
        try:
            yield
        finally:
            blocks._update_slice = real

    def forward_seamless(self):
        """EncDecLM.forward at seamless-m4t-medium's full width and depth
        (12 encoder and 12 decoder layers, d_model 1,024, 16 heads of 64,
        d_ff 4,096, gelu, layernorm, vocab 256,206 padded to 256,256),
        fp32 activations, attention_impl="chunked", on batch x (1,024
        frames drawn N(0, 1), as the reference's ``example_batch`` draws
        them, + ``seamless_text`` tokens): flash_attention launches once an
        encoder layer (non-causal, frames x frames) and twice a decoder
        layer (causal self-attention; non-causal cross-attention, text x
        frames), and the logits over the real vocab stay within 2^-12 of
        the row's largest |logit| of the naive forward; the forward with
        the encoder's attention made causal (a planted fault) does not.
        Then one profiled forward."""
        torch = self.torch
        from repro_torch.kernels.attention import flash_attention
        from repro_torch.models import EncDecLM
        self.phi3_state = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cfg = self.seamless_cfg()
        B, T = self.seamless_batch, self.seamless_text
        n_frames, n_enc, L = cfg.n_stub_tokens, cfg.n_encoder_layers, \
            cfg.n_layers
        check(T != n_frames, "the text must differ in length from the "
                             "frames (seamless_kind tells them apart)")
        chunked = EncDecLM(dataclasses.replace(
            cfg, attention_impl="chunked", activation_dtype="float32"))
        naive = EncDecLM(dataclasses.replace(
            cfg, attention_impl="naive", activation_dtype="float32"))
        t0 = time.perf_counter()
        params = chunked.init(torch.Generator(device=self.dev).manual_seed(
            self.seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in _leaves(params))
        g = torch.Generator().manual_seed(self.seed + 7)
        toks = torch.randint(0, cfg.vocab, (B, T), generator=g).to(self.dev)
        batch = {"tokens": toks,
                 "frames": self.randn(B, n_frames, cfg.d_model, seed=7)}
        self.flash_calls.clear()
        self.seamless_flash_ops.clear()
        before = flash_attention.launches
        with self.capture_flash(self.seamless_flash_ops, self.seamless_kind):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _ = chunked.forward(params, batch)
            torch.cuda.synchronize()
            chunked_s = time.perf_counter() - t0
        n = flash_attention.launches - before
        check(n == n_enc + 2 * L, f"forward launched flash_attention {n} "
                                  f"times, not {n_enc + 2 * L}")
        calls = dict(self.flash_calls)
        check(calls == {"encoder": n_enc, "self": L, "cross": L},
              f"forward's chunked attention calls {calls}")
        hq = [cfg.n_heads, cfg.head_dim]
        hkv = [cfg.n_kv_heads, cfg.head_dim]
        shapes = {key: [list(op[0].shape), list(op[1].shape), op[3]["causal"]]
                  for key, op in self.seamless_flash_ops.items()}
        check(shapes == {"encoder": [[B, n_frames, *hq], [B, n_frames, *hkv],
                                     False],
                         "self": [[B, T, *hq], [B, T, *hkv], True],
                         "cross": [[B, T, *hq], [B, n_frames, *hkv], False]},
              f"flash_attention's (q, k, causal) by kind: {shapes}")
        check(tuple(got.shape) == (B, T, chunked.vocab_padded),
              f"forward logits {tuple(got.shape)}")
        check(bool((got[..., cfg.vocab:] == -1e30).all()),
              "forward: the padded vocab columns are not -1e30")
        got = got[..., :cfg.vocab]
        check(bool(torch.isfinite(got).all()), "forward: non-finite logits")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = naive.forward(params, batch)
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t0
        check(flash_attention.launches - before == n,
              "the naive forward launched flash_attention")
        want = want[..., :cfg.vocab]
        ratio = self.logit_x_limit(got, want, FWD_LOGIT_TOL)
        check(ratio <= 1, f"chunked forward logits off the naive forward by "
                          f"{ratio:.3g} x the limit")
        del got
        with self.uncounted(), self.causal_encoder():
            bad, _ = chunked.forward(params, batch)
        fault = self.logit_x_limit(bad[..., :cfg.vocab], want, FWD_LOGIT_TOL)
        del bad
        check(fault > 1, f"planted fault: the forward with a causal encoder "
                         f"passed the limit ({fault:.3g} x)")
        self.faults.append({"fault": "seamless forward, the encoder's "
                                     "attention causal", "x_limit": fault})
        max_logit = float(want.abs().max())
        del want
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        profile = self.profile_forward(chunked, params, batch, chunked_s)
        self.seamless_state = params
        del params, batch, toks
        torch.cuda.empty_cache()
        return {"arch": cfg.name, "layers": [n_enc, L],
                "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
                "vocab": [cfg.vocab, chunked.vocab_padded],
                "positions": [B, n_frames, T], "param_init_seconds": init_s,
                "n_params": n_params, "config_n_params": cfg.n_params(),
                "forward_seconds": {"chunked": chunked_s, "naive": naive_s},
                "flash_attention_launches": n, "attention_calls": calls,
                "logits_x_limit": ratio, "max_abs_logit": max_logit,
                "causal_encoder_x_limit": fault,
                "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9,
                "profile": profile}

    def seamless_decode(self, model, params, frames, prompts, dtype,
                        feed=None, profiler=None):
        """The reference's decoding API: init_cache(R, seamless_max_seq)
        in ``dtype``, prefill_cache over ``frames``, one decode_step on the
        prompts (R, P), then ``seamless_new`` - 1 single-token steps, each
        fed the last step's greedy pick over the real vocab (or, with
        ``feed`` (R, P + new - 1), its next token). Returns the picks
        (R, new), every decoded position's logits over the real vocab
        (R, P + new - 1, vocab) and the seconds of the prefill, the prompt
        step and the single-token steps (under ``profiler``, a
        torch.profiler context, if given)."""
        torch = self.torch
        V, new = model.cfg.vocab, self.seamless_new
        R, P = prompts.shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = model.init_cache(R, self.seamless_max_seq, dtype=dtype,
                                 device=self.dev)
        cache = model.prefill_cache(params, cache, frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, prompts)
        logits = torch.empty((R, P + new - 1, V), dtype=lg.dtype,
                             device=lg.device)
        logits[:, :P] = lg[..., :V]
        del lg
        picks = [logits[:, P - 1].argmax(-1)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with profiler or contextlib.nullcontext():
            for i in range(1, new):
                tok = picks[-1] if feed is None else feed[:, P + i - 1]
                lg, cache = model.decode_step(params, cache, tok[:, None])
                logits[:, P + i - 1] = lg[:, 0, :V]
                del lg
                picks.append(logits[:, P + i - 1].argmax(-1))
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        check(int(cache["pos"]) == P + new - 1,
              f"the cache's pos {cache['pos']} after {new} steps")
        return torch.stack(picks, 1), logits, {
            "prefill": t1 - t0, "prompt_step": t2 - t1, "steps": t3 - t2}

    def decode_seamless(self):
        """seamless-m4t-medium decoding through its own API at serve_bench's
        geometry over ``forward_seamless``'s parameters:
        ``seamless_requests`` requests, each with its own frames (N(0, 1)),
        a prompt of ``seamless_prompt`` tokens and ``seamless_new`` greedy
        tokens (``seamless_decode``: prefill_cache runs the encoder at
        batch R, one non-causal flash_attention launch a layer; the prompt
        step one cross-attention launch a decoder layer; single-token steps
        the einsum attention, as the reference's decode). fp32 (fp32 cache):
        every decoded position's logits within 2^-12 of the row's largest
        |logit| of the naive full forward over the frames and the prompt +
        generated tokens (real vocab), the greedy picks that forward's
        argmax except where its top-2 gap is under that limit (counted),
        and the loop whose self-attention cache is written one position
        late (a planted fault, fed the same tokens) outside the limit.
        bf16 (the config's activations, the reference's default bf16
        cache): the logits within 4 bf16 ulps of the row's largest |logit|
        of the bf16 naive forward over its own tokens, a repeat
        byte-identical and timed, then the single-token steps profiled."""
        torch = self.torch
        from repro_torch.kernels.attention import flash_attention
        from repro_torch.models import EncDecLM
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cfg = self.seamless_cfg()
        params = self.seamless_state
        R, P, new = self.seamless_requests, self.seamless_prompt, \
            self.seamless_new
        V, n_enc, L = cfg.vocab, cfg.n_encoder_layers, cfg.n_layers
        g = torch.Generator().manual_seed(self.seed + 8)
        prompts = torch.randint(0, V, (R, P), generator=g).to(self.dev)
        frames = self.randn(R, cfg.n_stub_tokens, cfg.d_model, seed=8)

        def model(impl, dtype=None):
            return EncDecLM(dataclasses.replace(
                cfg, attention_impl=impl,
                activation_dtype=dtype or cfg.activation_dtype))

        def held(m, gen):
            """The full forward over the frames, the prompts and the
            decoded tokens but the last: (those tokens, its logits over
            the real vocab)."""
            seq = torch.cat([prompts, gen[:, :-1]], 1)
            want, _ = m.forward(params, {"tokens": seq, "frames": frames})
            return seq, want[..., :V]

        out = {"arch": cfg.name, "requests": R, "prompt": P, "new": new,
               "max_seq": self.seamless_max_seq}
        # fp32, fp32 cache
        before = flash_attention.launches
        gen, dec, secs = self.seamless_decode(model("chunked", "float32"),
                                              params, frames, prompts,
                                              torch.float32)
        n = flash_attention.launches - before
        check(n == n_enc + L, f"fp32 decode launched flash_attention {n} "
                              f"times, not {n_enc} (prefill_cache) + {L} "
                              f"(the prompt step)")
        seq, want = held(model("naive", "float32"), gen)
        check(flash_attention.launches - before == n,
              "the naive forward launched flash_attention")
        ratio = self.logit_x_limit(dec, want, FWD_LOGIT_TOL)
        check(ratio <= 1, f"fp32 cached decode off the naive forward by "
                          f"{ratio:.3g} x the limit")
        w = want[:, P - 1:]
        differ = gen != w.argmax(-1)
        top2 = w.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        near = gap < FWD_LOGIT_TOL * w.abs().amax(-1)
        check(not bool((differ & ~near).any()),
              "fp32 greedy picks differ from the forward's argmax where its "
              "top-2 gap is over the limit")
        out["fp32"] = {"flash_attention_launches": n,
                       "logits_x_limit": ratio,
                       "picks_differing": int(differ.sum()),
                       "picks_near_tie": int(near.sum()),
                       "least_top2_gap": float(gap.min()),
                       "seconds": secs}
        del dec, w, top2, gap
        with self.uncounted(), self.late_cache():
            _, bad, _ = self.seamless_decode(model("chunked", "float32"),
                                             params, frames, prompts,
                                             torch.float32, feed=seq)
        fault = self.logit_x_limit(bad, want, FWD_LOGIT_TOL)
        del bad, want
        check(fault > 1, f"planted fault: the decode with its cache written "
                         f"one position late passed the limit "
                         f"({fault:.3g} x)")
        self.faults.append({"fault": "seamless decode, the self-attention "
                                     "cache written one position late",
                            "x_limit": fault})
        out["fp32"]["late_cache_x_limit"] = fault
        torch.cuda.empty_cache()

        # bf16 activations, bf16 cache
        m16 = model("chunked")
        gen16, dec16, _ = self.seamless_decode(m16, params, frames, prompts,
                                               torch.bfloat16)
        _, want16 = held(model("naive"), gen16)
        tol16 = BF16_TOL_ULPS * BF16_ULP
        ratio16 = self.logit_x_limit(dec16, want16, tol16)
        agree = float((gen16 == want16[:, P - 1:].argmax(-1)).float().mean())
        del want16
        check(ratio16 <= 1, f"bf16 cached decode off the bf16 naive forward "
                            f"by {ratio16:.3g} x the limit")
        gen_b, dec_b, timed = self.seamless_decode(m16, params, frames,
                                                   prompts, torch.bfloat16)
        same = torch.equal(gen_b, gen16) and torch.equal(dec_b, dec16)
        check(same, "the bf16 decode's repeat is not byte-identical")
        del dec16, dec_b
        # the single-token steps of one more run under the profiler
        steps_prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.seamless_decode(m16, params, frames, prompts, torch.bfloat16,
                             profiler=steps_prof)
        busy = Counter()
        for e in steps_prof.events():
            if str(e.device_type).endswith("CUDA"):
                busy[e.name] += e.time_range.elapsed_us()
        step_wall = timed["steps"] / (new - 1)
        step_busy = sum(busy.values()) / 1e3 / (new - 1)
        out["bf16"] = {
            "logits_x_limit": ratio16, "picks_equal_forward_argmax": agree,
            "repeat_byte_identical": same,
            "prefill_cache_seconds": timed["prefill"],
            "prompt_step_seconds": timed["prompt_step"],
            "decode_tokens_per_s": R * new / (timed["prompt_step"]
                                              + timed["steps"]),
            "step_wall_ms": step_wall * 1e3,
            "step_device_busy_ms": step_busy,
            "step_device_idle_share": max(0.0, 1 - step_busy
                                          / (step_wall * 1e3)),
            "step_top_device_kernels": [
                {"name": k[:80], "ms_per_step": t / 1e3 / (new - 1)}
                for k, t in busy.most_common(5)]}
        torch.cuda.synchronize()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        self.seamless_state = None
        del params, frames, prompts
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def measure_seamless_attention(self):
        """flash_attention at seamless-m4t-medium's three forward shapes, on
        the forward's layer-0 operands (``measure_flash``'s row each): the
        encoder's (B 4, 1,024 x 1,024 frames, H 16, Dh 64, non-causal),
        the cross-attention's (B 4, 512 text x 1,024 frames, non-causal)
        and the decoder's self-attention (B 4, 512, causal), in fp32 and
        bf16."""
        torch = self.torch
        ops = self.seamless_flash_ops
        rows = self.flash_rows(
            (f"{kind}{suffix}", ops[kind], dtype)
            for suffix, dtype in (("", torch.float32),
                                  ("_bf16", torch.bfloat16))
            for kind in ("encoder", "cross", "self"))
        ops.clear()
        return rows

    # -- phase 8 ---------------------------------------------------------
    # -- the training path ---------------------------------------------------
    @staticmethod
    def grad_x_limit(got, want, tol):
        """(worst ratio, its leaf's index): over the gradient leaves, the
        largest |got - want| over ``tol`` times the leaf's largest
        |want|."""
        worst, at = 0.0, None
        for i, (g, w) in enumerate(zip(got, want)):
            scale = float(w.abs().max())
            err = float((g.float() - w.float()).abs().max())
            ratio = err / (tol * scale) if scale > 0 else \
                (0.0 if err == 0 else math.inf)
            if not math.isfinite(float(g.float().abs().max())):
                ratio = math.inf
            if ratio > worst or at is None:
                worst, at = max(worst, ratio), i
        return worst, at

    def loss_and_grads(self, model, params, batch):
        """The model's loss and the gradient of every parameter leaf
        (``torch.autograd.grad``, as ``make_train_step`` takes them; zeros
        for a leaf the loss does not reach), and the seconds that took."""
        torch = self.torch
        from repro_torch.optim import tree_leaves
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(params, batch)
        # a leaf the loss does not reach (a planted fault) gets zeros, which
        # the comparison then holds to the plain path's gradient
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        torch.cuda.synchronize()
        return float(loss.detach()), grads, time.perf_counter() - t0

    @contextlib.contextmanager
    def capture_bwd(self, tag):
        """Keep the first operands each backward kernel's wrapper gets at
        each dtype (under ``tag``) for ``measure_train``: the wrappers are
        called through ``_Recorded``, which keeps their counts."""
        from repro_torch.kernels.attention import flash
        from repro_torch.kernels.rwkv import kernel as wkv
        real_f, real_w = flash.flash_attention_bwd, wkv.wkv_chunked_bwd

        def bare(*ts):
            # detached: a saved operand's graph reaches back to the
            # parameters and would keep them alive
            return tuple(None if t is None else t.detach() for t in ts)

        def f(q, k, v, out, lse, dout, **kw):
            self.bwd_ops.setdefault((tag, q.dtype), bare(q, k, v, dout) + ({
                n: kw[n] for n in ("causal", "window", "q_offset")},))

        def w(r, k, v, w_, u, state0, dout, dstate=None):
            self.wkv_bwd_ops.setdefault(tag, bare(r, k, v, w_, u, state0,
                                                  dout, dstate))
        flash.flash_attention_bwd = _Recorded(real_f, f)
        wkv.wkv_chunked_bwd = _Recorded(real_w, w)
        try:
            yield
        finally:
            flash.flash_attention_bwd, wkv.wkv_chunked_bwd = real_f, real_w

    @contextlib.contextmanager
    def detached_attention(self):
        """The planted fault of the parent: the chunked attention's output
        carries no gradient (the kernel's bare forward)."""
        from repro_torch.models import blocks, layers

        def fn(*args, **kw):
            return layers.attention_chunked(*args, **kw).detach()
        blocks.attention_chunked = fn
        try:
            yield
        finally:
            blocks.attention_chunked = layers.attention_chunked

    @contextlib.contextmanager
    def variant_library(self, name, variant):
        """Route the backward kernel ``name``'s calls to the library built
        from a planted-fault source (``build``'s ``variants``)."""
        from repro_torch.kernels.attention import flash
        from repro_torch.kernels.rwkv import kernel as wkv
        mod = {"wkv_bwd": wkv, "flash_attention_bwd": flash}[name]
        lib = self.variants[variant]
        real = mod._bwd_entry
        mod._bwd_entry = lambda: mod.bwd_entry(lib)
        try:
            yield
        finally:
            mod._bwd_entry = real

    def profile_train_step(self, step, state, batch, wall_s):
        """Where a train step's time goes: one more step under
        torch.profiler — the card's busy time (its kernels' sum), the idle
        share against ``wall_s`` (the unprofiled steps' mean), and the
        shares of the GEMMs (kernels named "gemm"), the flash forward, the
        flash backward and the WKV kernels. Returns (the new state, the
        profile)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, m = step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
        by_name = Counter()
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                by_name[e.name] += e.time_range.elapsed_us()
        busy = sum(by_name.values()) / 1e3

        def share(*keys):
            ms = sum(t for n, t in by_name.items()
                     if any(k in n for k in keys)) / 1e3
            return {"ms": ms, "share": ms / busy if busy else None}
        return state, {
            "wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / (wall_s * 1e3)),
            # cuBLAS's kernels: "...gemm..." and, for bf16 on Hopper,
            # "nvjet_..."
            "gemm": share("gemm", "Gemm", "GEMM", "nvjet"),
            "flash_forward": share("flash_attention_kernel"),
            "flash_backward": share("flash_bwd_dkdv", "flash_bwd_dq",
                                    "flash_bwd_rowdot", "flash_bwd_reduce"),
            "wkv_forward": share("wkv_chunked_kernel"),
            # the five launches wkv_bwd_{spans,scan,keys,values,du}
            "wkv_backward": share("wkv_bwd_"),
            "top_device_kernels": [{"name": n[:80], "ms": t / 1e3}
                                   for n, t in by_name.most_common(6)]}

    def train_lm(self):
        """``repro_torch.examples.train_lm``'s main path through the
        ``Trainer``: LM100M (12 layers x d 640, 10 heads of 64, d_ff 2,560,
        vocab 32,768, tied, fp32), AdamW, batch x seq tokens, 20 steps,
        a checkpoint every 10. A second run in a fresh directory stops at
        step 10 and a new Trainer resumes it to 20: its first logged step
        is 10 and its losses are within RESUME_LOSS_TOL of the whole run's
        (bitwise equality reported). A third run with
        attention_impl="chunked": 12 forward and 12 backward
        flash_attention launches a step at Dh 64, its losses and grad norms
        within CHUNKED_LM_TOL of the naive run's, relative."""
        import shutil
        import tempfile
        torch = self.torch
        from repro_torch.data import make_global_batch
        from repro_torch.examples.train_lm import LM100M
        from repro_torch.kernels.attention import (flash_attention,
                                                   flash_attention_bwd)
        from repro_torch.runtime import Trainer, TrainerConfig
        gc.collect()
        torch.cuda.empty_cache()
        cfg = self.lm_config or LM100M
        B, S, n = self.lm_batch, self.lm_seq, self.lm_steps
        root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))

        def trainer(name, steps, c=cfg):
            return Trainer(c, None, TrainerConfig(
                steps=steps, checkpoint_every=n // 2,
                ckpt_dir=None if name is None else str(root / name)),
                seq_len=S, global_batch=B)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            whole = trainer("whole", n).run()
            whole_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            trainer("cut", n // 2).run()
            resumed = trainer("cut", n).run()
            check(resumed["log"][0]["step"] == n // 2,
                  f"the resumed run started at step "
                  f"{resumed['log'][0]['step']}, not {n // 2}")
            a = [m["loss"] for m in whole["log"][n // 2:]]
            b = [m["loss"] for m in resumed["log"]]
            check(len(a) == len(b), "the resumed run's steps")
            resume_diff = max(abs(x - y) for x, y in zip(a, b))
            check(resume_diff < RESUME_LOSS_TOL,
                  f"the resumed losses differ by {resume_diff:.3g}")
            counts, last = [], [flash_attention.launches,
                                flash_attention_bwd.launches]

            def on_step(step, metrics):
                now = [flash_attention.launches, flash_attention_bwd.launches]
                counts.append((now[0] - last[0], now[1] - last[1]))
                last[:] = now
            chunked_cfg = dataclasses.replace(cfg, attention_impl="chunked")
            tc = trainer(None, n, chunked_cfg)
            with self.capture_bwd("lm100m"):
                chunked = tc.run(on_step)
            want = (cfg.n_layers, cfg.n_layers)
            check(all(c == want for c in counts),
                  f"chunked steps launched flash_attention (forward, "
                  f"backward) {sorted(set(counts))}, not {want} a step")
            q = self.bwd_ops[("lm100m", torch.float32)][0]
            check(q.shape[-1] == cfg.head_dim,
                  f"flash_attention_bwd took heads of {q.shape[-1]}")
            worst = 0.0
            for x, y in zip(chunked["log"], whole["log"]):
                for key in ("loss", "grad_norm"):
                    worst = max(worst, abs(x[key] - y[key]) / abs(y[key]))
            check(worst <= CHUNKED_LM_TOL,
                  f"chunked LM100M off the naive run by {worst:.3g}")
            steps_s = [m["s"] for m in whole["log"]]
            mean_s = statistics.mean(steps_s[1:])
            batch = {k: torch.as_tensor(v, device=self.dev) for k, v in
                     make_global_batch(tc.data_cfg, n, cfg).items()}
            _, prof = self.profile_train_step(
                tc.step_fn, chunked["state"], batch,
                statistics.mean(m["s"] for m in chunked["log"][1:]))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        return {"arch": cfg.name, "n_params": cfg.n_params(),
                "tokens": [B, S], "steps": n,
                "losses": [whole["log"][0]["loss"], whole["log"][-1]["loss"]],
                "run_seconds": whole_s, "mean_step_seconds": mean_s,
                "first_step_seconds": steps_s[0],
                "chunked_mean_step_seconds": statistics.mean(
                    m["s"] for m in chunked["log"][1:]),
                "resume": {"first_step": resumed["log"][0]["step"],
                           "max_loss_diff": resume_diff,
                           "bitwise_equal": a == b},
                "chunked": {"flash_launches_a_step": list(want),
                            "head_dim": cfg.head_dim,
                            "max_rel_diff": worst, "profile": prof},
                "peak_mem_gb": peak / 1e9}

    def train_full(self, tag, cfg, model_kw, plain, faults):
        """One model's training phase (``train_starcoder2``,
        ``train_rwkv6``): (a) in fp32 activations one step's gradients of
        the kernel path (``make_train_step``'s remat) against the plain path
        (``plain``: a context that routes the mixing step to its plain
        version on the same CUDA tensors) from the same weights and batch,
        every leaf within TRAIN_GRAD_TOL, the planted ``faults`` (name ->
        context) outside it; (b) in the config's own bf16 activations,
        ``train_steps`` AdamW steps of ``make_train_step`` from the same
        weights, timed: losses and grad norms finite, the first loss within
        TRAIN_BF16_LOSS of (a)'s, then one more step profiled."""
        torch = self.torch
        from repro_torch.data import DataConfig, make_global_batch
        from repro_torch.launch import make_train_step
        from repro_torch.models import TransformerLM
        from repro_torch.optim import tree_leaves
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        B, S = self.train_batch, self.train_seq
        data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                          seed=self.seed)

        def batch_at(step):
            return {k: torch.as_tensor(v, device=self.dev) for k, v in
                    make_global_batch(data, step, cfg).items()}
        f32 = dataclasses.replace(cfg, activation_dtype="float32", **model_kw)
        model = TransformerLM(f32, remat=True)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=self.dev).manual_seed(
            self.seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tree_leaves(params))
        batch = batch_at(0)
        before = hand_counts()
        with self.capture_bwd(tag):
            loss_k, g_k, kernel_s = self.loss_and_grads(model, params, batch)
        moved = dict(hand_counts() - before)
        with plain():
            loss_p, g_p, plain_s = self.loss_and_grads(model, params, batch)
        check(not (hand_counts() - before - Counter(moved)),
              f"the plain path launched {dict(hand_counts() - before)}")
        ratio, at = self.grad_x_limit(g_k, g_p, TRAIN_GRAD_TOL)
        check(ratio <= 1, f"{tag}: the kernel path's gradients off the plain "
                          f"path's by {ratio:.3g} x the limit (leaf {at})")
        del g_k
        planted = {}
        for name, ctx in faults.items():
            with ctx():
                _, g_bad, _ = self.loss_and_grads(model, params, batch)
            bad, at_bad = self.grad_x_limit(g_bad, g_p, TRAIN_GRAD_TOL)
            del g_bad
            check(bad > 1, f"planted fault {name} passed the gradient limit "
                           f"({bad:.3g} x)")
            planted[name] = bad
            self.faults.append({"fault": name, "x_limit": bad,
                                "leaf": at_bad})
        del g_p
        gc.collect()
        torch.cuda.synchronize()
        peak_a = torch.cuda.max_memory_allocated()
        # (b) the config's own activations, AdamW, timed steps
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, _, opt = make_train_step(dataclasses.replace(cfg, **model_kw),
                                       remat=True)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        del params
        log = []
        for i in range(self.train_steps):
            b = batch_at(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            log.append({"loss": loss, "grad_norm": gnorm,
                        "s": time.perf_counter() - t0})
            check(math.isfinite(loss) and math.isfinite(gnorm),
                  f"{tag}: bf16 step {i}: loss {loss}, grad norm {gnorm}")
        rel = abs(log[0]["loss"] - loss_k) / abs(loss_k)
        check(rel <= TRAIN_BF16_LOSS, f"{tag}: the bf16 step's loss "
                                      f"{log[0]['loss']} off the fp32 "
                                      f"{loss_k} by {rel:.3g}")
        mean_s = statistics.mean(m["s"] for m in log[1:]) if len(log) > 1 \
            else log[0]["s"]
        state, prof = self.profile_train_step(step, state,
                                              batch_at(len(log)), mean_s)
        torch.cuda.synchronize()
        peak_b = torch.cuda.max_memory_allocated()
        del state, step, opt, model
        gc.collect()
        torch.cuda.empty_cache()
        return {"arch": cfg.name, "n_layers": cfg.n_layers,
                "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads,
                                                  cfg.head_dim],
                "tokens": [B, S], "n_params": n_params,
                "param_init_seconds": init_s, "held_before_gb": held / 1e9,
                "fp32": {"launches": moved, "loss": loss_k,
                         "plain_loss": loss_p, "grads_x_limit": ratio,
                         "worst_leaf": at, "planted_x_limit": planted,
                         "seconds": {"kernel": kernel_s, "plain": plain_s},
                         "peak_mem_gb": peak_a / 1e9},
                "bf16": {"steps": log, "mean_step_seconds": mean_s,
                         "first_loss_rel_to_fp32": rel, "profile": prof,
                         "peak_mem_gb": peak_b / 1e9}}

    def train_starcoder2(self):
        """starcoder2-3b at full width and depth (30 layers, d 3,072, 24
        query and 2 KV heads of 128, d_ff 12,288, vocab 49,152;
        3,180,331,008 parameters) on B x S tokens (the reference's
        ``train_4k``): ``train_full`` with attention_impl="chunked" against
        "naive"; (a)'s chunked step launches flash_attention 60 times (30
        of them remat's recompute) and its backward 30; planted: the
        parent's detached attention output, and a backward that sums a KV
        head's dK/dV over only the first of its query heads."""
        from repro_torch.configs import get_config
        cfg = self.train_config or get_config(self.train_arch)
        if self.train_config is None:
            check(cfg.n_params() == 3_180_331_008,
                  f"starcoder2-3b's n_params {cfg.n_params()}")

        @contextlib.contextmanager
        def naive():
            from repro_torch.models import blocks, layers

            def fn(q, k, v, *, causal=True, window=None, q_offset=0,
                   bk=1024):
                return layers.attention_xla(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset)
            blocks.attention_chunked = fn
            try:
                yield
            finally:
                blocks.attention_chunked = layers.attention_chunked
        out = self.train_full(
            "starcoder2", cfg, {"attention_impl": "chunked"}, naive,
            {"detached_attention_output": self.detached_attention,
             "bwd_first_query_head_only": functools.partial(
                 self.variant_library, "flash_attention_bwd",
                 "flash_attention_bwd_first_head")})
        L = cfg.n_layers
        got = out["fp32"]["launches"]
        check(got == {"flash_attention": 2 * L, "flash_attention_bwd": L},
              f"starcoder2-3b's chunked step launched {got}, not "
              f"{2 * L} forward and {L} backward flash_attention")
        return out

    def train_rwkv6(self):
        """rwkv6-7b at full width on ``train_rwkv_layers`` of its 32 layers
        (d 4,096, 64 heads of 64, d_ff 14,336, vocab 65,536; cut in depth
        only because AdamW's state for 7B parameters does not fit 80 GB)
        on B x S tokens: ``train_full`` with the WKV kernels against the
        plain chunked WKV called on the same CUDA tensors; (a)'s step
        launches wkv_chunked twice a layer (remat's recompute) and its
        backward once; planted: the state's gradient carried from chunk to
        chunk without the chunk's decay."""
        from repro_torch.configs import get_config
        from repro_torch.kernels.rwkv import wkv_chunked_ref
        cfg = self.train_rwkv_config or dataclasses.replace(
            get_config(self.rwkv_arch), n_layers=self.train_rwkv_layers)

        @contextlib.contextmanager
        def plain_wkv():
            from repro_torch.models import blocks
            real = blocks._wkv_chunked
            blocks._wkv_chunked = wkv_chunked_ref
            try:
                yield
            finally:
                blocks._wkv_chunked = real
        out = self.train_full(
            "rwkv6", cfg, {}, plain_wkv,
            {"wkv_bwd_undecayed_carry": functools.partial(
                self.variant_library, "wkv_bwd", "wkv_bwd_undecayed")})
        L = cfg.n_layers
        got = out["fp32"]["launches"]
        check(got == {"wkv_chunked": 2 * L, "wkv_chunked_bwd": L},
              f"rwkv6-7b's step launched {got}, not {2 * L} forward and "
              f"{L} backward wkv_chunked")
        return out

    def bwd_within(self, got, want, floor=0.0, out_rel=0.0):
        """(ok, max error, worst ratio): a backward kernel's result against
        its plain version, |got - want| <= BWD_TOL (max |want| + |want|) +
        floor + out_rel |want| elementwise (``floor``: dS's rounding where
        it cancels, see ``measure_train``)."""
        torch = self.torch
        got, want = got.double(), want.double()
        scale = float(want.abs().max())
        limit = BWD_TOL * (scale + want.abs()) + floor + out_rel * want.abs()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and not bool((err > limit).any())
        return ok, float(err.max()), float((err / (limit + 1e-300)).max())

    def flash_bwd_held(self, what, got, plain, q, k, v, do):
        """(worst ratio, max error) of flash_attention_bwd's (dq, dk, dv)
        ``got`` against its plain version's ``plain`` under ``bwd_within``:
        dq and dk with a floor for dS's rounding where a row's terms cancel
        (4 fp32 ulps of sqrt(Sk) max|dO| max|V| max|K| / sqrt(Dh)), and in
        bf16 a bf16 ulp of each element besides (the outputs' rounding).
        Fails the run where one is off."""
        torch = self.torch
        Sk, Dh = k.shape[1], q.shape[3]
        floor = 4 * EPS32 * math.sqrt(Sk) * float(
            do.abs().max() * v.abs().max() * k.abs().max()) / math.sqrt(Dh)
        out_rel = BF16_ULP if q.dtype == torch.bfloat16 else 0.0
        worst, err = 0.0, 0.0
        for name, g, p, f in zip(("dq", "dk", "dv"), got, plain,
                                 (floor, floor, 0.0)):
            ok, e, r = self.bwd_within(g, p, f, out_rel)
            check(ok, f"flash_attention_bwd {name} at {what}: {r:.3g} x "
                      f"its limit against the plain version")
            worst, err = max(worst, r), max(err, e)
        return worst, err

    def flash_bwd_library(self, q, k, v, do, causal=True, window=None,
                          q_offset=0):
        """PyTorch's scaled_dot_product_attention backward (the call
        ``sdpa`` picks) through autograd on the GQA-repeated heads, at
        flash_attention_bwd's operands (B, S, H, Dh): (ms of one call by
        CUDA events, ``time_ms``; its device time, ``backward_device_ms``).
        """
        torch = self.torch
        Hq, Hkv = q.shape[2], k.shape[2]
        forward = self.sdpa(q.shape[1], k.shape[1], causal, window, q_offset)
        qt = q.transpose(1, 2).detach().requires_grad_(True)
        kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
                  .detach().requires_grad_(True) for x in (k, v))
        out = forward(qt, kt, vt)
        dot = do.transpose(1, 2)
        ms = self.time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
        return ms, self.backward_device_ms(forward, (qt, kt, vt), dot)

    def wkv_bwd_row(self, r, k, v, w, u, s0, do, ds):
        """``wkv_chunked_bwd``'s row at the training path's operands (fp32)
        and, under "bf16", at the same operands cast to bf16 (u, state0 and
        dstate stay fp32): each gradient held to its plain version
        (``bwd_within``; in bf16 one bf16 ulp of each element besides) and,
        in fp32, to fp32 parity against the float64 gradient; in fp32 the
        control (``tf32_once_source``: one tf32 product where the kernel
        takes three) must fail parity by CONTROL_MARGIN. The bound: 2 (5 +
        3/16) hd^2 + 160 hd flops a position and head over the 3xTF32 peak
        (``bound_fma_ms``: the FMA peak), or r, k, v, w, dout in and dr,
        dk, dv, dw out at the operands' size over the memory rate."""
        torch = self.torch
        from repro_torch.kernels.rwkv import (wkv_chunked_bwd,
                                              wkv_chunked_bwd_ref)
        names = ("dr", "dk", "dv", "dw", "du")
        rows = {}
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            rr, kk, vv, ww, dd = (x.to(dt) for x in (r, k, v, w, do))
            ops = (rr, kk, vv, ww, u, s0, dd, ds)
            got = wkv_chunked_bwd(*ops)
            plain = wkv_chunked_bwd_ref(*ops)
            worst, err, par, ctrl = 0.0, 0.0, None, None
            for name, g, p in zip(names, got, plain):
                out_rel = BF16_ULP if bf16 and name != "du" else 0.0
                ok, e, ratio = self.bwd_within(g, p, 0.0, out_rel)
                check(ok, f"wkv_chunked_bwd {name} ({dt}): {ratio:.3g} x its "
                          f"limit against the plain version")
                worst, err = max(worst, ratio), max(err, e)
            if not bf16:
                want = wkv_chunked_bwd_ref(
                    *(None if x is None else x.double() for x in ops))
                par = 0.0
                for name, g, p, wt in zip(names, got, plain, want):
                    ok, pr = parity(g, p, wt)
                    check(ok, f"wkv_chunked_bwd {name}: fp32 parity {pr:.3g} "
                              f"x")
                    par = max(par, pr)
                with self.variant_library("wkv_bwd", "wkv_bwd_tf32_once"):
                    once = wkv_chunked_bwd(*ops)
                ctrl = max(parity(g, p, wt)[1]
                           for g, p, wt in zip(once, plain, want))
                check(ctrl >= CONTROL_MARGIN,
                      f"control wkv_chunked_bwd: one tf32 product failed "
                      f"fp32 parity by only {ctrl:.3g} x")
                self.faults.append({
                    "fault": "wkv_chunked_bwd at rwkv6-7b's layer: one tf32 "
                             "product each (control)", "x_parity": ctrl})
                del want, once
            del got, plain
            B, S, H, hd = rr.shape
            nbytes = 9 * rr.numel() * rr.element_size() + 2 * u.numel() * 4
            n_ops = B * S * H * (2 * (5 + 3 / WKV_CHUNK) * hd * hd
                                 + 10 * WKV_CHUNK * hd)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / TF32X3_FLOP_PER_S * 1e3

            def kernel():
                return wkv_chunked_bwd(*ops)
            device_ms = self.device_ms(kernel)
            rows[dt] = {
                "max_abs_err": err, "x_limit": worst, "x_parity": par,
                "ms": self.time_ms(kernel), "device_ms": device_ms,
                "plain_ms": self.time_ms(lambda: wkv_chunked_bwd_ref(*ops)),
                "library_ms": None, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": max(t_bytes, t_ops) / device_ms,
                "bound_fma_ms": max(t_bytes,
                                    n_ops / FP32_FLOP_PER_S * 1e3),
                "bytes": nbytes, "ops": n_ops, "control_x_parity": ctrl,
                "shapes": f"B={B}, S={S}, H={H}, hd={hd}, {dt}, "
                          f"no state0"}
            del rr, kk, vv, ww, dd, ops
        return dict(rows[torch.float32], bf16=rows[torch.bfloat16])

    def measure_train(self):
        """The backward kernels at the training path's operands: each held
        to its plain version (``bwd_within``) and, in fp32, to fp32 parity
        against the float64 gradient (its plain version in float64); ms,
        device_ms, plain_ms, the bound and library_ms.
        ``flash_attention_bwd`` at LM100M's layer (B 8, S 256, H 10, Dh
        64) and starcoder2-3b's (B 1, S 4,096, Hq 24, Hkv 2, Dh 128), both
        causal, in fp32 and bf16 (the fp32 operands cast, the forward
        rerun for out and lse): 10 Dh flops a pair a head (S, dP, dV, dQ,
        dK) over the route's peak (3xTF32 for fp32, as row 12; the FMA
        peak as ``bound_fma_ms``) or q, k, v, out, dout, lse and the three
        gradients once over the memory rate; library_ms and
        library_device_ms: ``flash_bwd_library``.
        ``wkv_chunked_bwd`` at rwkv6-7b's layer (B 1, S 4,096, H 64, hd
        64) in fp32 and bf16: ``wkv_bwd_row``; no library call."""
        torch = self.torch
        from repro_torch.kernels.attention import (flash,
                                                   flash_attention_bwd,
                                                   flash_attention_bwd_ref,
                                                   flash_attention_ref)
        rows = {}
        for tag in ("starcoder2", "lm100m"):
            q0, k0, v0, do0, kw = self.bwd_ops[(tag, torch.float32)]
            for dtype in (torch.float32, torch.bfloat16):
                key = tag + ("_bf16" if dtype == torch.bfloat16 else "")
                q, k, v, do = (x.to(dtype) for x in (q0, k0, v0, do0))
                out, lse = flash._forward(q, k, v, kw["causal"],
                                          kw["window"], kw["q_offset"], True)
                B, Sq, Hq, Dh = q.shape
                Sk, Hkv = k.shape[1], k.shape[2]
                got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
                plain = flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
                bf16 = dtype == torch.bfloat16
                worst, err = self.flash_bwd_held(key, got, plain, q, k, v,
                                                 do)
                par = None
                if not bf16:
                    o64, l64 = flash_attention_ref(
                        *(x.double() for x in (q, k, v)), **kw,
                        return_lse=True)
                    want = flash_attention_bwd_ref(
                        q.double(), k.double(), v.double(), o64, l64,
                        do.double(), **kw)
                    del o64, l64
                    par = 0.0
                    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain,
                                             want):
                        ok, r = parity(g, p, w)
                        check(ok, f"flash_attention_bwd {name} at {key}: "
                                  f"fp32 parity {r:.3g} x")
                        par = max(par, r)
                    del want
                del got, plain
                pairs = int(self.flash_mask(Sq, Sk, kw["causal"],
                                            kw["window"],
                                            kw["q_offset"]).sum())

                def kernel():
                    return flash_attention_bwd(q, k, v, out, lse, do, **kw)
                es = q.element_size()
                nbytes = 4 * q.numel() * es + 4 * k.numel() * es + \
                    lse.numel() * 4
                n_ops = 10 * Dh * pairs * B * Hq
                peak = BF16_TENSOR_FLOP_PER_S if bf16 else TF32X3_FLOP_PER_S
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = n_ops / peak * 1e3
                device_ms = self.device_ms(kernel)
                library_ms, library_device_ms = self.flash_bwd_library(
                    q, k, v, do, **kw)
                rows[key] = {
                    "max_abs_err": err, "x_limit": worst, "x_parity": par,
                    "ms": self.time_ms(kernel), "device_ms": device_ms,
                    "plain_ms": self.time_ms(lambda: flash_attention_bwd_ref(
                        q, k, v, out, lse, do, **kw)),
                    "library_ms": library_ms,
                    "library_device_ms": library_device_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bound_share": max(t_bytes, t_ops) / device_ms,
                    "bytes": nbytes, "ops": n_ops, "admitted_pairs": pairs,
                    "shapes": f"B={B}, S={Sq}, Hq={Hq}, Hkv={Hkv}, Dh={Dh}, "
                              f"causal={kw['causal']}, "
                              f"window={kw['window']}, {dtype}"}
                if not bf16:
                    fma = max(t_bytes, n_ops / FP32_FLOP_PER_S * 1e3)
                    rows[key]["bound_fma_ms"] = fma
                del q, k, v, do, out, lse
        flash_row = dict(rows.pop("starcoder2"), **{"train_shapes": rows})
        wkv_row = self.wkv_bwd_row(*self.wkv_bwd_ops["rwkv6"])
        self.bwd_ops.clear()
        self.wkv_bwd_ops.clear()
        return {"flash_attention_bwd": flash_row, "wkv_chunked_bwd": wkv_row}

    def observe(self, kernel, program, values, current):
        """Launch observer: keep each generated kernel's operands from the
        main path, to check and time the kernel after it (one entry for
        the serving step's per-layer attention kernels, which differ only
        in their layer; gemma3-4b's and llama4-scout's under their tag, by
        the layer's kind in ``attn_windows``).
        A step captured as a CUDA graph calls it at capture, with the
        graph's operands, which every replay refills; ``checked`` counts
        the launches."""
        name = kernel.desc.name
        if ATTN_RE.fullmatch(name):
            self.attn_fns.add(kernel.desc.fn)
            if self.attn_tag is not None:
                li = int(name[len("attn"):-len("_grid_tiled")])
                kind = "global" if self.attn_windows[li] is None \
                    else "windowed"
                self.gemma_captured[(self.attn_tag, kind)] = (
                    kernel, program, dict(values), dict(current))
                return
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


class _Records(list):
    def take(self):
        out = list(self)
        self.clear()
        return out


class _Recorded:
    """A wrapper called through ``fn``, its arguments shown to ``record``
    first; its ``launches`` is ``fn``'s own (the wrapper counts through its
    module's name, which this stands in for)."""

    def __init__(self, fn, record):
        self.fn, self.record = fn, record

    def __call__(self, *args, **kw):
        self.record(*args, **kw)
        return self.fn(*args, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


class _StepView:
    """A compiled step whose call goes through ``run`` (the smoke's checks)
    and whose attributes are the step's."""

    def __init__(self, step, run):
        self._step, self._run = step, run

    def __call__(self, kwargs):
        return self._run(kwargs)

    def __getattr__(self, name):
        return getattr(self._step, name)


def attention_layers(model):
    """The flat indices of a model's attention layers (its Mamba and RWKV
    layers run as tasklets of the served step)."""
    return [li for li, sp in enumerate(model.layer_specs)
            if sp.kind == "attn"]


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
                "wkv_chunked", "flash_attention") + TRAIN_KERNELS


def hand_wrappers():
    from repro_torch.kernels.attention import (decode_attention,
                                               flash_attention,
                                               flash_attention_bwd)
    from repro_torch.kernels.axpydot import axpydot
    from repro_torch.kernels.dot import dot
    from repro_torch.kernels.gemm import matmul
    from repro_torch.kernels.rwkv import wkv_chunked, wkv_chunked_bwd
    from repro_torch.kernels import stencil
    return {"dot": dot, "axpydot": axpydot, "matmul": matmul,
            "stencil2d": stencil.stencil2d,
            "stencil2d_chain": stencil.stencil2d_chain,
            "diffusion2d": stencil.diffusion2d, "jacobi3d": stencil.jacobi3d,
            "diffusion3d": stencil.diffusion3d,
            "decode_attention": decode_attention,
            "wkv_chunked": wkv_chunked, "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "wkv_chunked_bwd": wkv_chunked_bwd}


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

    def drive(phases):
        """One path of the main path: every launch count from 0, its
        phases, the counts read just after its last phase."""
        for wrapper in hand_wrappers().values():
            wrapper.launches = 0
        for name in ("matmul", "stencil2d", "stencil2d_chain"):
            hand_wrappers()[name].routes.clear()
        cuda_backend.reset_launch_counts()
        cuda_backend.LAUNCH_OBSERVERS.append(smoke.observe)
        try:
            for name, fn in phases:
                phase(name, fn)
        finally:
            cuda_backend.LAUNCH_OBSERVERS.remove(smoke.observe)
        return ({**dict(hand_counts()),
                 "grid_kernel": cuda_backend.run_grid_kernel.launches,
                 "two_phase": cuda_backend.run_two_phase.launches},
                {**cuda_backend.run_grid_kernel.launches_by_name,
                 **cuda_backend.run_two_phase.launches_by_name},
                dict(hand_wrappers()["matmul"].routes),
                {name: dict(hand_wrappers()[name].routes)
                 for name in ("stencil2d", "stencil2d_chain")})

    # the earlier slices' paths, then their measurements, which free what
    # they kept before llama4-scout's weights come on the card
    launches, per_kernel, routes, stencil_routes = drive([
        ("quickstart", smoke.quickstart),
        ("axpydot_paper", smoke.axpydot_paper),
        ("axpydot_grid_ladder", smoke.axpydot_grid_ladder),
        ("gemver", smoke.gemver),
        ("two_phase_rowsum", smoke.rowsum),
        ("lenet_paper", smoke.lenet_paper),
        ("convblock", smoke.convblock),
        ("gemm_program", smoke.gemm_program),
        ("stencilflow_paper", smoke.stencilflow_paper),
        ("jacobi_chain", smoke.jacobi_chain),
        ("star", smoke.star),
        ("stencil_fig19", smoke.stencil_fig19),
        ("serve_starcoder2", smoke.serve_starcoder2),
        ("serve_flash", smoke.serve_flash),
        ("forward_rwkv6", smoke.forward_rwkv6),
        ("serve_rwkv6", smoke.serve_rwkv6),
        ("forward_gemma3", smoke.forward_gemma3),
        ("serve_gemma3", smoke.serve_gemma3),
        ("serve_gemma3_window", smoke.serve_gemma3_window)])
    emit({"phase": "main_path_launches", **launches,
          "per_kernel": per_kernel, "matmul_routes": routes,
          "stencil_routes": stencil_routes})
    for k, n in launches.items():
        check(n > 0 or k in TRAIN_KERNELS,
              f"kernel {k} was not launched on the main path")
    for r in ("wgmma", "fma"):
        check(routes.get(r, 0) > 0,
              f"the matmul {r} route was not launched on the main path")

    # the served phases' schedulers and their graph pools sit in reference
    # cycles: free them before the measurements
    smoke.release()
    t0 = time.perf_counter()
    generated = smoke.measure_generated(per_kernel)
    attention = smoke.measure_attention(per_kernel)
    smoke.results["decode_attention"] = attention.pop("decode_attention")
    smoke.results["wkv_chunked"] = smoke.measure_wkv()
    smoke.results["flash_attention"] = smoke.measure_flash()
    gemma = smoke.measure_gemma_attention()
    smoke.results["decode_attention"]["gemma3"] = gemma["decode"]
    attention[f"grid_kernel:{ATTN_KEY}"]["gemma3"] = gemma["attn"]
    generated.update(attention)
    emit({"phase": "measure", "seconds": round(time.perf_counter() - t0, 3),
          "x_limit": {k: r["x_limit"] for k, r in generated.items()},
          "planted_faults": smoke.faults})
    smoke.drop_kept()

    # the MoE family's path
    moe, moe_per_kernel, _, _ = drive([
        ("forward_llama4", smoke.forward_llama4),
        ("serve_llama4", smoke.serve_llama4)])
    emit({"phase": "llama4_path_launches", **moe,
          "per_kernel": moe_per_kernel})
    for k in ("flash_attention", "decode_attention", "grid_kernel"):
        check(moe[k] > 0, f"kernel {k} was not launched on the llama4 path")
    smoke.release()
    t0 = time.perf_counter()
    llama = smoke.measure_llama_attention()
    smoke.results["decode_attention"]["llama4"] = llama["decode"]
    attention[f"grid_kernel:{ATTN_KEY}"]["llama4"] = llama["attn"]
    smoke.results["flash_attention"]["llama4"] = llama["flash"]
    emit({"phase": "measure_llama4",
          "seconds": round(time.perf_counter() - t0, 3)})

    # the hybrid and VLM families' path
    hv, hv_per_kernel, _, _ = drive([
        ("forward_jamba", smoke.forward_jamba),
        ("serve_jamba", smoke.serve_jamba),
        ("forward_phi3", smoke.forward_phi3),
        ("serve_phi3", smoke.serve_phi3)])
    emit({"phase": "hybrid_vlm_path_launches", **hv,
          "per_kernel": hv_per_kernel})
    for k in ("flash_attention", "decode_attention", "grid_kernel"):
        check(hv[k] > 0,
              f"kernel {k} was not launched on the jamba/phi-3 path")
    smoke.release()
    t0 = time.perf_counter()
    phi3 = smoke.measure_phi3_attention()
    smoke.results["decode_attention"]["phi3"] = phi3["decode"]
    attention[f"grid_kernel:{ATTN_KEY}"]["phi3"] = phi3["attn"]
    smoke.results["flash_attention"]["phi3"] = phi3["flash"]
    emit({"phase": "measure_phi3",
          "seconds": round(time.perf_counter() - t0, 3)})

    # the enc-dec family's path
    ed, ed_per_kernel, _, _ = drive([
        ("forward_seamless", smoke.forward_seamless),
        ("decode_seamless", smoke.decode_seamless)])
    emit({"phase": "encdec_path_launches", **ed,
          "per_kernel": ed_per_kernel})
    check(ed["flash_attention"] > 0,
          "kernel flash_attention was not launched on the seamless path")
    smoke.release()
    t0 = time.perf_counter()
    smoke.results["flash_attention"]["seamless"] = \
        smoke.measure_seamless_attention()
    emit({"phase": "measure_seamless",
          "seconds": round(time.perf_counter() - t0, 3)})
    # the training path
    tr, tr_per_kernel, _, _ = drive([
        ("train_lm", smoke.train_lm),
        ("train_starcoder2", smoke.train_starcoder2),
        ("train_rwkv6", smoke.train_rwkv6)])
    emit({"phase": "train_path_launches", **tr,
          "per_kernel": tr_per_kernel})
    for k in ("flash_attention", "wkv_chunked") + TRAIN_KERNELS:
        check(tr[k] > 0, f"kernel {k} was not launched on the training path")
    smoke.release()
    t0 = time.perf_counter()
    smoke.results.update(smoke.measure_train())
    emit({"phase": "measure_train",
          "seconds": round(time.perf_counter() - t0, 3)})
    # a row's launches: every path's
    for path, per_kernel in ((moe, moe_per_kernel), (hv, hv_per_kernel),
                             (ed, ed_per_kernel), (tr, tr_per_kernel)):
        for k, n in path.items():
            launches[k] += n
        attention[f"grid_kernel:{ATTN_KEY}"]["launches"] += sum(
            n for k, n in per_kernel.items() if ATTN_RE.fullmatch(k))

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
        for extra in ("device_ms", "device_ms_cold", "share_of_bound_cold",
                      "library_device_ms", "library_device_ms_cold",
                      "timed", "ptx", "measured_on",
                      "load_route", "load_routes", "range_fault",
                      "shapes", "launches_per_step", "admission", "global",
                      "windowed_bf16", "bound_fma_ms", "x_parity", "sass",
                      "gemma3", "llama4", "phi3", "seamless",
                      "train_shapes", "bf16", "x_limit",
                      "control_x_parity"):
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
