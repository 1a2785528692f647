"""Serving throughput on the port: the compiled decode step against the
plain ``decode_step`` loop. It reports what ``benchmarks/serve_bench.py``
reports, under the same names and in the same order.

For each arch the baseline decodes against the full dense ``max_model_len``
cache through the port's ``TransformerLM.decode_step``, eager under
``torch.inference_mode()`` and synchronised. The reference runs
``jax.jit(model.decode_step)``; the port has no counterpart of that
compiler, so its baseline is the plain loop. The compiled path runs the
:mod:`repro_torch.serving` scheduler: paged KV cache, (B, ctx)
shape-bucketed SDFG steps with each layer's attention lowered to a
generated Triton grid kernel, pages written in place, and contexts bounded
by the live sequences instead of the model limit.

Entries (tokens/sec, higher is better):
  ``serve_<arch>_b<B>_baseline_tps`` / ``serve_<arch>_b<B>_compiled_tps``
with p50/p99 per-token decode latency and the grid-kernel count as
extras, then the dtype-aware row (``serve_starcoder2_3b_b64_bf16_tps``, or
``..._b16_f32_tps`` when small) and ``serve_starcoder2_3b_faulted_tps``
(one injected step exception, a page-pressure window, one NaN-logits step;
faulted throughput within 1.5x of the fault-free run). Every assertion of
the reference is kept as written, on every device: at batch >= 64 the
compiled path beats the baseline for starcoder2-3b and gemma3-4b and
converts at least one grid kernel; the dtype row converts one; the faulted
run preempts at least once, re-runs at least one step on the fallback rung
and stays within its 1.5x budget. The compiled-against-baseline claim is
checked after the last row, so that a run in which it fails still reports
every row (the harness then writes no record).

The two rates of a batch are taken as the reference takes them: the
baseline's over its whole timed window, the compiled path's as B over its
median steady step, which a step that stalls (a bucket compiled mid-run)
does not move. Each compiled row therefore also carries ``wall_tps``, its
tokens over the scheduler run's whole wall time, prefill and compiles
included, the measure the faulted row uses.

At full size every arch runs at its published width and depth with the
reference's full geometry (batches 1, 8, 64, 256; 24 new tokens; model
length 512): ``reduced()`` is the reference's cut for the CPU
(``configs/base.py``, "Miniature same-family config for CPU smoke tests"),
as ``stencil_bench`` runs the paper's domains. ``small=True`` is the
reference's small run: ``reduced()`` configs, batches 1 and 8, 8 new
tokens, model length 128, the fp32 row at B = 16, and the same numpy
prompts (``RandomState(0)`` and ``RandomState(1)``, drawn in the
reference's order). Weights are the port's seeded init; each arch's are
freed before the next one's are drawn.

The sharded rows need the sharded decode step (ROADMAP step 10c):
the run prints one line saying so and reports no row for them.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only serve \
        [--small] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import List

import numpy as np
import torch

from ..configs import get_config
from ..models import TransformerLM
from ..pipeline.stages import resolve_device
from ..serving import FaultInjector, Scheduler, ServeFaultPlan

ARCHS = ("starcoder2-3b", "gemma3-4b", "rwkv6-7b")
PROMPT, NEW = 16, 24
PAGE = 16
#: compiled must beat baseline at these batches (attention configs only;
#: rwkv has no attention, so the paged-context win does not apply)
ASSERT_BATCHES = (64, 256)
ASSERT_ARCHS = ("starcoder2-3b", "gemma3-4b")
#: the reference's seed for the weights (``jax.random.PRNGKey(0)``)
SEED = 0


def _slug(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _config(arch: str, small: bool):
    cfg = get_config(arch)
    return cfg.reduced() if small else cfg


def _init(model, device: torch.device):
    return model.init(torch.Generator(device=device).manual_seed(SEED))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device: torch.device):
    """Drop what the last arch left: schedulers and compiled steps form
    reference cycles that hold the weights until the collector runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def baseline(model, params, prompts, new_tokens: int, max_model_len: int,
             device, cache_dtype=torch.bfloat16):
    """(tokens/sec, greedy streams) of the plain loop: ``decode_step`` on a
    dense ``max_model_len`` cache, the prompts at once, one warm-up decode
    step, then ``new_tokens`` timed steps. A stream is the prompt's first
    ``new_tokens`` greedy tokens."""
    B = prompts.shape[0]
    with torch.inference_mode():
        cache = model.init_cache(B, max_model_len, dtype=cache_dtype,
                                 device=device)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                               device=device)
        logits, cache = model.decode_step(params, cache, toks)
        toks = logits[:, -1:].argmax(-1).to(torch.int32)
        out = [toks]
        logits, cache = model.decode_step(params, cache, toks)  # warm-up
        toks = logits.argmax(-1).to(torch.int32)
        out.append(toks)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(new_tokens):
            logits, cache = model.decode_step(params, cache, toks)
            toks = logits.argmax(-1).to(torch.int32)
            out.append(toks)
        _sync(device)
        dt = time.perf_counter() - t0
    streams = torch.cat(out, 1)[:, :new_tokens].tolist()
    return B * new_tokens / dt, streams


def compiled_run(model, params, prompts, new_tokens: int, max_model_len: int,
                 device, **sched_kw):
    """(tokens/sec, p50 ms, p99 ms, report, streams, wall tokens/sec) of
    one scheduler run: tokens/sec is B over the median steady-state step,
    wall tokens/sec all tokens over the run's wall time."""
    B = prompts.shape[0]
    n_pages = B * ((PROMPT + new_tokens) // PAGE + 1) + 1
    sched = Scheduler(model, params, max_slots=B, page_size=PAGE,
                      n_pages=n_pages, max_model_len=max_model_len,
                      prefill_chunk=PROMPT, device=device, **sched_kw)
    for b in range(B):
        sched.submit(list(map(int, prompts[b])), new_tokens)
    t0 = time.perf_counter()
    reqs = sched.run()
    wall = time.perf_counter() - t0
    sched.check_invariants()
    # steady state: drop the prefill token and the compile-warmup steps
    steady: List[float] = []
    for r in reqs:
        steady.extend(r.token_times[3:])
    if not steady:
        steady = [t for r in reqs for t in r.token_times[1:]]
    med = float(np.median(steady))
    report = sched.compiler._steps[max(sched.compiler._steps)].report
    return (B / med, float(np.percentile(steady, 50) * 1e3),
            float(np.percentile(steady, 99) * 1e3), report,
            [list(r.tokens_out) for r in reqs],
            sum(len(r.tokens_out) for r in reqs) / wall)


def _grid_derived(report) -> str:
    conv = report.get("grid_converted") or []
    if not conv:
        return "grid_kernels=0"
    shape = conv[0].get("block_shape")
    return f"grid_kernels={len(conv)} blocks={shape}"


def run(report, small: bool = False, device=None):
    dev = resolve_device(device)
    new_tokens = 8 if small else NEW
    max_model_len = 128 if small else 512
    batches = (1, 8) if small else (1, 8, 64, 256)
    rng = np.random.RandomState(0)

    results = {}
    for arch in ARCHS:
        cfg = _config(arch, small)
        model = TransformerLM(cfg)
        params = _init(model, dev)
        prompts_all = rng.randint(0, cfg.vocab, size=(max(batches), PROMPT))
        for B in batches:
            prompts = prompts_all[:B]
            base, _ = baseline(model, params, prompts, new_tokens,
                               max_model_len, dev)
            tps, p50, p99, rep, _, wall_tps = compiled_run(
                model, params, prompts, new_tokens, max_model_len, dev)
            nk = len(rep.get("grid_kernels", []))
            slug = _slug(arch)
            report(f"serve_{slug}_b{B}_baseline_tps", base,
                   derived=f"dense ctx={max_model_len}", backend="cuda")
            report(f"serve_{slug}_b{B}_compiled_tps", tps,
                   derived=_grid_derived(rep), backend="cuda",
                   p50_ms=p50, p99_ms=p99, grid_kernels=nk,
                   wall_tps=wall_tps)
            results[(arch, B)] = (base, tps, nk)
        del model, params
        _free(dev)

    dtype_row(report, small, rng, new_tokens, max_model_len, dev)
    faulted_row(report, small, new_tokens, max_model_len, dev)
    print("serve: the sharded rows (serve_starcoder2_3b_sharded_tps, "
          "serve_starcoder2_3b_shrink_recovery_tps) wait for the sharded "
          "decode step (ROADMAP step 10c)")

    for arch in ASSERT_ARCHS:
        for B in ASSERT_BATCHES:
            if (arch, B) not in results:
                continue
            base, tps, nk = results[(arch, B)]
            assert tps > base, (
                f"{arch} b{B}: compiled {tps:.0f} tok/s does not beat "
                f"baseline {base:.0f} tok/s")
            assert nk >= 1, (
                f"{arch} b{B}: compiled step converted no grid kernels")


def dtype_row(report, small: bool, rng, new_tokens: int, max_model_len: int,
              device):
    """The per-dtype sublane row: grid blocks sized by element width, not
    the calibrated crossover table."""
    arch = "starcoder2-3b"
    cfg = _config(arch, small)
    if small:  # fp32 -> 8-row sublanes: converts already at B=16
        cfg = dataclasses.replace(cfg, activation_dtype="float32")
        B, tag = 16, "f32"
    else:      # bf16 -> 16-row sublanes
        B, tag = 64, "bf16"
    model = TransformerLM(cfg)
    params = _init(model, device)
    prompts = rng.randint(0, cfg.vocab, size=(B, PROMPT))
    tps, p50, p99, rep, _, wall_tps = compiled_run(
        model, params, prompts, new_tokens, max_model_len, device,
        dtype_aware_sublanes=True)
    nk = len(rep.get("grid_kernels", []))
    assert nk >= 1, f"dtype-aware {tag} row converted no grid kernels"
    report(f"serve_{_slug(arch)}_b{B}_{tag}_tps", tps,
           derived=_grid_derived(rep), backend="cuda",
           p50_ms=p50, p99_ms=p99, grid_kernels=nk, wall_tps=wall_tps)
    del model, params
    _free(device)


def faulted_row(report, small: bool, new_tokens: int, max_model_len: int,
                device):
    """Recovery overhead: the combined fault plan vs fault-free at the same
    batch, wall-clock tokens/sec over the whole run."""
    arch = "starcoder2-3b"
    B = 8 if small else 64
    cfg = _config(arch, small)
    model = TransformerLM(cfg)
    params = _init(model, device)
    rng = np.random.RandomState(1)
    # staggered one-page prompts: lanes cross their first page boundary
    # at different steps, so the pressure window hits a live crossing
    plens = rng.randint(8, PAGE + 1, size=B)
    prompts = [list(map(int, rng.randint(0, cfg.vocab, size=p)))
               for p in plens]
    n_pages = B * ((PAGE + new_tokens) // PAGE + 1) + 1

    def one(injector=None):
        sched = Scheduler(model, params, max_slots=B, page_size=PAGE,
                          n_pages=n_pages, max_model_len=max_model_len,
                          prefill_chunk=PAGE, injector=injector,
                          device=device)
        if injector is not None:
            # compile time is a one-off; the row measures steady-state
            # recovery overhead, so warm the fallback rung off-clock
            for ctx in (2 * PAGE, 4 * PAGE):
                if ctx <= max_model_len:
                    sched.compiler.fallback_for(B, ctx)
        for p in prompts:
            sched.submit(p, new_tokens)
        t0 = time.perf_counter()
        reqs = sched.run()
        wall = time.perf_counter() - t0
        sched.check_invariants()
        total = sum(len(r.tokens_out) for r in reqs)
        return total / wall, sched

    clean_tps, _ = one()
    plan = ServeFaultPlan(step_exception_at=1, page_pressure_at=2,
                          page_pressure_release_at=6, nan_logits_at=4)
    tps, sched = one(FaultInjector(plan))
    st = sched.stats()
    assert st["preemptions"] >= 1, "pressure window caused no preemption"
    assert st["fallback_steps"] >= 1, "no fallback re-run happened"
    assert all(r.finish_reason == "max_tokens" for r in sched.finished)
    overhead = clean_tps / tps
    assert overhead <= 1.5, (
        f"faulted run {tps:.0f} tok/s is {overhead:.2f}x slower than "
        f"fault-free {clean_tps:.0f} tok/s (budget 1.5x)")
    report(f"serve_{_slug(arch)}_faulted_tps", tps, backend="cuda",
           derived=(f"preemptions={st['preemptions']} "
                    f"fallback_steps={st['fallback_steps']}"),
           fault_free_tps=clean_tps, overhead=overhead, batch=B,
           preemptions=st["preemptions"],
           fallback_steps=st["fallback_steps"])
    del model, params, sched
    _free(device)


if __name__ == "__main__":
    import sys

    from .run import main
    raise SystemExit(main(["--only", "serve"] + sys.argv[1:]))
