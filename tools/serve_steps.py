"""The step table of the port's serve_bench faulted row: the fault-free run
and the faulted run of ``repro_torch.benchmarks.serve_bench.faulted_row``
(reduced starcoder2-3b, B 8, 8 new tokens, the same fault plan, the same
off-clock warm-up of the interpreter rung), each scheduler step listed with
its kind (prefills and re-prefills, the decode rung: grid, the interpreter
fallback after a fault) and its time, then the overhead the row asserts
(fault-free tokens per second over faulted, budget 1.5x). ``--profile``
adds a cProfile of one grid-rung decode step and one interpreter-rung step
at that bucket; ``--threads N`` sets PyTorch's intra-op threads for the
run (the harness's ``--device cpu`` run takes ``run.CPU_THREADS``).

It times each scheduler's ``step``, ``_admit`` and ``_execute`` from
outside, on the instance, so it times whichever checkout of the package is
on ``PYTHONPATH``:

    PYTHONPATH=src python tools/serve_steps.py [--runs 5] [--threads 1] \
        [--profile]
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time

import numpy as np
import torch

from repro_torch.benchmarks import serve_bench as sb
from repro_torch.models import TransformerLM
from repro_torch.serving import FaultInjector, Scheduler, ServeFaultPlan


def timed_steps(sched) -> list:
    """Wrap ``sched``'s step, admission and decode attempt; the list each
    step's row is appended to."""
    rows, cur = [], {}
    admit, execute, step = sched._admit, sched._execute, sched.step

    def timed_admit(req, slot, total):
        t0 = time.perf_counter()
        out = admit(req, slot, total)
        cur["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_execute(fn, kwargs, active, B, ctx):
        fb, t0 = sched.n_fallback_steps, time.perf_counter()
        out = execute(fn, kwargs, active, B, ctx)
        cur["decode"] = {"bucket": [B, ctx], "rung": fn.rung,
                         "fallback": sched.n_fallback_steps > fb,
                         "recompute": out is None,
                         "ms": (time.perf_counter() - t0) * 1e3}
        return out

    def timed_step():
        cur.clear()
        cur.update(prefill_ms=[], decode=None)
        t0 = time.perf_counter()
        try:
            return step()
        finally:
            cur["ms"] = (time.perf_counter() - t0) * 1e3
            rows.append(dict(cur))

    sched._admit, sched._execute, sched.step = \
        timed_admit, timed_execute, timed_step
    return rows


def faulted_pair():
    """One fault-free and one faulted run of the small row on the CPU: for
    each, the tokens per second over the run's wall time and its step
    table."""
    dev = torch.device("cpu")
    new_tokens, max_model_len, B = 8, 128, 8
    cfg = sb._config("starcoder2-3b", True)
    model = TransformerLM(cfg)
    params = sb._init(model, dev)
    rng = np.random.RandomState(1)
    plens = rng.randint(8, sb.PAGE + 1, size=B)
    prompts = [list(map(int, rng.randint(0, cfg.vocab, size=p)))
               for p in plens]
    n_pages = B * ((sb.PAGE + new_tokens) // sb.PAGE + 1) + 1
    out = {}
    for name, injector in (("fault_free", None), ("faulted", FaultInjector(
            ServeFaultPlan(step_exception_at=1, page_pressure_at=2,
                           page_pressure_release_at=6, nan_logits_at=4)))):
        sched = Scheduler(model, params, max_slots=B, page_size=sb.PAGE,
                          n_pages=n_pages, max_model_len=max_model_len,
                          prefill_chunk=sb.PAGE, injector=injector,
                          device=dev)
        if injector is not None:
            for ctx in (2 * sb.PAGE, 4 * sb.PAGE):
                sched.compiler.fallback_for(B, ctx)
        for p in prompts:
            sched.submit(p, new_tokens)
        rows = timed_steps(sched)
        t0 = time.perf_counter()
        reqs = sched.run()
        wall = time.perf_counter() - t0
        out[name] = {"tps": sum(len(r.tokens_out) for r in reqs) / wall,
                     "wall_ms": wall * 1e3, "steps": rows, "sched": sched}
    out["overhead"] = out["fault_free"]["tps"] / out["faulted"]["tps"]
    return out


def profile_steps(pair, top: int = 12) -> dict:
    """cProfile of one grid-rung decode step and one interpreter-rung step
    at the fault-free run's last bucket, on its last inputs."""
    sched = pair["fault_free"]["sched"]
    B, ctx = pair["fault_free"]["steps"][-1]["decode"]["bucket"]
    kw = sched._step_kwargs(B, ctx)
    out = {}
    for rung, step in (("grid", sched.compiler.step_for(B, ctx)),
                       ("interpreter", sched.compiler.fallback_for(B, ctx))):
        fresh = lambda: {k: v.clone() if k in step.donate_names else v
                         for k, v in kw.items()}
        step(fresh())
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        step(fresh())
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(top)
        out[rung] = {"ms_profiled": (time.perf_counter() - t0) * 1e3,
                     "top": text.getvalue()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--threads", type=int, default=None,
                    help="intra-op threads (default: PyTorch's)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if args.threads is not None:
        torch.set_num_threads(args.threads)
    for i in range(args.runs):
        pair = faulted_pair()
        print(json.dumps({"run": i, "overhead": pair["overhead"],
                          "threads": torch.get_num_threads(), **{
                              k: {"tps": v["tps"], "wall_ms": v["wall_ms"],
                                  "steps": v["steps"]}
                              for k, v in pair.items()
                              if isinstance(v, dict)}}), flush=True)
        if args.profile and i == args.runs - 1:
            for rung, p in profile_steps(pair).items():
                print(f"== {rung} step, {p['ms_profiled']:.1f} ms profiled")
                print(p["top"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
