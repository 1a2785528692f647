"""Serving example on the port: continuous batching over the compiled decode
step, the counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        [--arch starcoder2-3b] [--small] [--faults] [--snapshot-at N] \
        [--device cpu]

It serves the arch's reduced config, as the reference does. Requests with
mixed prompt/output lengths stream through the
:class:`repro_torch.serving.Scheduler`: chunked prefill, paged KV cache
with a per-slot block table, and one (B, ctx)-bucketed SDFG-compiled
decode step per iteration, each layer's attention a generated grid kernel
inside it (its plain block program on the CPU). It prints per-request
latency, the compiled-step report (grid kernels against fallbacks) and
the compilation-cache hit rate.

Fault-tolerance modes:

* ``--faults`` arms a :class:`repro_torch.serving.ServeFaultPlan` combining
  a step exception, forced page pressure (>= 1 preemption) and a NaN
  logits step, then asserts every request finished with a typed reason
  and that the greedy token streams are byte-identical to a fault-free
  run.
* ``--snapshot-at N`` snapshots mid-decode after N steps, restores into
  a fresh scheduler, and asserts the resumed streams match.
* ``--small`` shrinks everything for a quick run.

``--cluster-sim`` and ``--shrink-at N`` (the decode step sharded across
simulated hosts, with a live mesh shrink after N steps) need the sharded
decode step (ShardMapPass), which the port does not have yet: either flag
raises ``NotImplementedError``, as ``n_shards > 1`` does everywhere in
:mod:`repro_torch.serving`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import TransformerLM
from repro_torch.pipeline.cache import COMPILATION_CACHE
from repro_torch.pipeline.stages import resolve_device
from repro_torch.serving import FaultInjector, Scheduler, ServeFaultPlan

#: the seed of the weights (the reference's ``jax.random.PRNGKey(0)``)
SEED = 0


def build(args, model, params, injector=None):
    n_pages = args.slots * (args.max_model_len // args.page_size) + 1
    return Scheduler(model, params, max_slots=args.slots,
                     page_size=args.page_size, n_pages=n_pages,
                     max_model_len=args.max_model_len,
                     cache_dtype=args.cache_dtype, injector=injector,
                     device=args.device)


def submit_all(sched, cfg, args):
    rng = np.random.default_rng(0)
    for _ in range(args.requests):  # mixed lengths: continuous batching
        plen = int(rng.integers(4, min(32, args.max_model_len // 2)))
        new = int(rng.integers(4, args.tokens + 1))
        sched.submit(list(rng.integers(0, cfg.vocab, plen)), new)


def streams(reqs):
    return {r.rid: list(r.tokens_out) for r in reqs}


def run_cluster_sim(args, model, params):
    """The sharded decode step across 2 simulated hosts: raises until the
    sharded step is ported."""
    Scheduler(model, params, max_slots=4, page_size=4, n_pages=16,
              max_model_len=16, prefill_chunk=4, cache_dtype="float32",
              n_shards=2, device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24,
                    help="max new tokens per request")
    ap.add_argument("--max-model-len", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--cache-dtype", default="bfloat16")
    ap.add_argument("--small", action="store_true",
                    help="a quick run (fewer slots/requests/tokens)")
    ap.add_argument("--faults", action="store_true",
                    help="inject exception+pressure+NaN; assert recovery")
    ap.add_argument("--snapshot-at", type=int, default=None, metavar="N",
                    help="snapshot after N steps, restore, assert "
                         "token-exact resume")
    ap.add_argument("--cluster-sim", action="store_true",
                    help="shard the decode step across 2 simulated hosts "
                         "(needs ShardMapPass: raises)")
    ap.add_argument("--shrink-at", type=int, default=None, metavar="N",
                    help="cluster-sim: shrink the mesh 2 -> 1 after N "
                         "steps (needs ShardMapPass: raises)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    if args.small:
        args.requests = min(args.requests, 6)
        args.slots = min(args.slots, 4)
        args.tokens = min(args.tokens, 8)
        args.max_model_len = min(args.max_model_len, 64)
        args.page_size = min(args.page_size, 8)
    args.device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=args.device).manual_seed(SEED))

    if args.cluster_sim or args.shrink_at is not None:
        run_cluster_sim(args, model, params)
        return

    baseline = None
    if args.faults or args.snapshot_at is not None:
        base_sched = build(args, model, params)
        submit_all(base_sched, cfg, args)
        baseline = streams(base_sched.run())
        base_sched.check_invariants()
        print(f"fault-free baseline: {len(baseline)} requests, "
              f"{sum(map(len, baseline.values()))} tokens")

    injector = None
    if args.faults:
        plan = ServeFaultPlan(step_exception_at=1, page_pressure_at=2,
                              page_pressure_release_at=8, nan_logits_at=5)
        injector = FaultInjector(plan)
    sched = build(args, model, params, injector=injector)
    submit_all(sched, cfg, args)

    if args.snapshot_at is not None:
        for _ in range(args.snapshot_at):
            sched.step()
        snap = sched.snapshot()
        resumed = build(args, model, params).restore(snap)
        out = streams(resumed.run())
        resumed.check_invariants()
        assert out == baseline, "restored run diverged from baseline"
        print(f"snapshot at step {args.snapshot_at}: restored run is "
              "token-exact")

    t0 = time.perf_counter()
    reqs = sched.run()
    wall = time.perf_counter() - t0
    sched.check_invariants()

    total = sum(len(r.tokens_out) for r in reqs)
    print(f"arch={args.arch} (reduced) slots={args.slots} "
          f"requests={args.requests} device={args.device}")
    print(f"{total} tokens in {wall:.2f}s -> {total / wall:.1f} tok/s "
          f"({sched.n_decode_steps} decode steps)\n")
    print(f"{'rid':>4} {'prompt':>7} {'new':>4} {'reason':>10} "
          f"{'ttft_ms':>8} {'p50_ms':>7} {'p99_ms':>7}")
    for r in reqs:
        steady = r.token_times[1:] or r.token_times
        print(f"{r.rid:>4} {len(r.prompt):>7} {len(r.tokens_out):>4} "
              f"{r.finish_reason:>10} {r.ttft * 1e3:>8.1f} "
              f"{np.percentile(steady, 50) * 1e3:>7.2f} "
              f"{np.percentile(steady, 99) * 1e3:>7.2f}")

    if args.faults:
        st = sched.stats()
        print("\nfault recovery:", {k: st[k] for k in
                                    ("preemptions", "fallback_steps",
                                     "recomputes")})
        print("injected:", [e["kind"] for e in injector.events])
        print("watchdog:", [e["kind"] for e in st["watchdog_events"]])
        assert st["preemptions"] >= 1, "page pressure caused no preemption"
        assert all(r.finish_reason for r in reqs), "untyped finish"
        out = streams(reqs)
        assert out == baseline, "faulted streams diverged from fault-free"
        print("faulted run recovered: streams byte-identical to "
              "fault-free baseline")

    print("\ncompiled (B, ctx) buckets:", sorted(sched.compiler._steps))
    for (B, ctx), step in sorted(sched.compiler._steps.items()):
        rep = step.report
        print(f"  ({B}, {ctx}): grid_kernels={rep.get('grid_kernels')} "
              f"fallbacks={rep.get('grid_fallbacks')} rung={step.rung}")
    stats = COMPILATION_CACHE.stats
    print(f"compilation cache: {stats['hits']} hits / "
          f"{stats['misses']} misses ({stats['entries']} entries)")
    return {"streams": streams(reqs), "stats": sched.stats()}


if __name__ == "__main__":
    main()
