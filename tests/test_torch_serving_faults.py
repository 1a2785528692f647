"""Fault-tolerant serving in the port (mirrors of ``test_serving_faults.py``
and ``test_serving_props.py``): preemption, deadlines, the degradation
ladder, the combined fault plan, snapshot/restore (in memory and to a
directory), and the scheduler churn property. The bar is the reference's:
the greedy streams of non-faulted requests are byte-identical to a
fault-free run — here also to the reference Scheduler's fault-free run —
and every request ends with a typed ``finish_reason``. The reference's
``SimulatedCluster`` case waits for the port of the scale-out runtime
(ROADMAP queue 1 item 9)."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as rget_config
from repro.models.transformer import TransformerLM as RTransformerLM
from repro.pipeline.cache import CompilationCache as RCompilationCache
from repro.serving import Scheduler as RScheduler
from repro_torch.configs import get_config
from repro_torch.models import TransformerLM, lm_params_from_reference
from repro_torch.pipeline.cache import CompilationCache
import torch
from repro_torch.codegen import cuda_backend
from repro_torch.core.sdfg import MapEntry, Tasklet
from repro_torch.serving import (FINISH_REASONS, FaultInjector, Scheduler,
                                 ServeFaultPlan, StepFault, StepWatchdog)
from repro_torch.serving import compile as serving_compile
from repro_torch.serving import scheduler as serving_scheduler
from repro_torch.serving.faults import degrades

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

# one cache for the whole module: every test uses the same geometry, so
# each (B, ctx) bucket lowers once
CACHE = CompilationCache()

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2]]
GEOMETRY = dict(page_size=4, n_pages=32, max_model_len=32, prefill_chunk=4,
                cache_dtype="float32")


@pytest.fixture(scope="module")
def models():
    rcfg = dataclasses.replace(rget_config("starcoder2-3b").reduced(),
                               activation_dtype="float32")
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              activation_dtype="float32")
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    return rmodel, rparams, model, params


@pytest.fixture(scope="module")
def model_params(models):
    return models[2], models[3]


def mk(model_params, max_slots=4, **kw):
    model, params = model_params
    return Scheduler(model, params, max_slots=max_slots, device="cpu",
                     compile_cache=CACHE, **{**GEOMETRY, **kw})


def streams(reqs):
    return {r.rid: list(r.tokens_out) for r in reqs}


@pytest.fixture(scope="module")
def baseline(model_params):
    """Fault-free greedy streams for PROMPTS."""
    s = mk(model_params)
    for p in PROMPTS:
        s.submit(p, 8)
    out = streams(s.run())
    s.check_invariants()
    return out


def run_plan(model_params, plan, **kw):
    s = mk(model_params, injector=FaultInjector(plan), **kw)
    for p in PROMPTS:
        s.submit(p, 8)
    out = streams(s.run())
    s.check_invariants()
    return s, out


def test_baseline_matches_reference_scheduler(models, baseline):
    rmodel, rparams, _, _ = models
    s = RScheduler(rmodel, rparams, max_slots=4,
                   compile_cache=RCompilationCache(), **GEOMETRY)
    for p in PROMPTS:
        s.submit(p, 8)
    assert streams(s.run()) == baseline


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------
class TestPreemption:
    def test_page_pressure_preempts_instead_of_crashing(self, model_params,
                                                        baseline):
        plan = ServeFaultPlan(page_pressure_at=1,
                              page_pressure_release_at=8)
        s, out = run_plan(model_params, plan)
        assert s.n_preemptions >= 1
        assert out == baseline
        assert all(r.finish_reason in FINISH_REASONS for r in s.finished)

    def test_direct_seize_mid_run(self, model_params, baseline):
        s = mk(model_params)
        for p in PROMPTS:
            s.submit(p, 8)
        s.step()
        seized = s.pool.seize()
        for _ in range(4):
            s.step()
            s.check_invariants()
        s.pool.release(seized)
        out = streams(s.run())
        s.check_invariants()
        assert out == baseline

    def test_preempted_request_keeps_tokens(self, model_params):
        plan = ServeFaultPlan(page_pressure_at=1,
                              page_pressure_release_at=10)
        s, _ = run_plan(model_params, plan)
        evs = [e for e in s.events if e["kind"] == "preempt"]
        assert evs and all(e["kept_tokens"] > 0 for e in evs)

    def test_preemption_limit_finishes_typed(self, model_params):
        plan = ServeFaultPlan(page_pressure_at=1,
                              page_pressure_release_at=200)
        s = mk(model_params, max_slots=1, max_preemptions=0,
               injector=FaultInjector(plan))
        s.submit([1, 2, 3, 4, 5, 6, 7], 12)
        s.run()
        s.check_invariants()
        assert [r.finish_reason for r in s.finished] == ["preempted_limit"]


# ---------------------------------------------------------------------------
# Deadlines and TTLs
# ---------------------------------------------------------------------------
class TestDeadlines:
    def test_queue_ttl_and_active_deadline(self, model_params):
        clk = [0.0]
        s = mk(model_params, max_slots=1, clock=lambda: clk[0],
               queue_ttl_s=5.0)
        s.submit(PROMPTS[0], 20, deadline_s=2.0)
        s.submit(PROMPTS[1], 8)
        s.submit(PROMPTS[2], 8)
        for _ in range(3):
            s.step()
            clk[0] += 1.5
        clk[0] += 10.0
        s.run()
        s.check_invariants()
        reasons = {r.rid: r.finish_reason for r in s.finished}
        assert reasons[0] == "timeout"
        assert "timeout" in (reasons[1], reasons[2])
        assert all(v in FINISH_REASONS for v in reasons.values())

    def test_no_deadline_never_times_out(self, model_params, baseline):
        clk = [0.0]
        s = mk(model_params, clock=lambda: clk[0])
        for p in PROMPTS:
            s.submit(p, 8)
        clk[0] += 1e9
        assert streams(s.run()) == baseline


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------
class TestDegradationLadder:
    def test_injected_exception_falls_back_token_exact(self, model_params,
                                                       baseline):
        s, out = run_plan(model_params, ServeFaultPlan(step_exception_at=1))
        assert s.n_fallback_steps >= 1
        assert s.watchdog.faults_of("step_exception")
        assert out == baseline

    def test_nan_logits_rerun_token_exact(self, model_params, baseline):
        s, out = run_plan(model_params, ServeFaultPlan(nan_logits_at=2))
        assert s.watchdog.faults_of("nan_logits")
        assert out == baseline

    def test_persistent_nan_lane_fails_only_that_request(self, model_params,
                                                         baseline):
        plan = ServeFaultPlan(nan_logits_at=1, nan_slots=(0,),
                              nan_persistent=True)
        s, out = run_plan(model_params, plan, max_failures=2)
        reasons = {r.rid: r.finish_reason for r in s.finished}
        assert reasons[0] == "failed"
        for rid in (1, 2, 3):
            assert out[rid] == baseline[rid]

    def test_persistent_exception_fails_everyone_typed(self, model_params):
        plan = ServeFaultPlan(step_exception_at=0,
                              exception_persistent=True)
        s, _ = run_plan(model_params, plan, max_failures=2)
        assert {r.finish_reason for r in s.finished} == {"failed"}
        assert len(s.finished) == len(PROMPTS)

    def test_recompute_recovery_under_donation(self, model_params,
                                               baseline):
        s, out = run_plan(model_params, ServeFaultPlan(step_exception_at=1),
                          donate=True)
        assert s.n_recomputes >= 1
        assert s.n_fallback_steps == 0
        assert out == baseline

    def test_compile_failure_degrades_then_recovers(self, model_params,
                                                    baseline):
        plan = ServeFaultPlan(compile_fail_buckets="all",
                              compile_fail_times=2)
        s, out = run_plan(model_params, plan)
        kinds = [e["kind"] for e in s.compiler.events]
        assert "compile_fallback" in kinds
        assert "compile_retry_failed" in kinds
        assert "compile_recovered" in kinds
        assert all(e.get("rung", "jit") == "jit" for e in s.compiler.events)
        assert out == baseline

    def test_slow_step_trips_watchdog(self, model_params):
        plan = ServeFaultPlan(slow_step_at=6, slow_factor=1e6)
        wd = StepWatchdog(deadline_s=3600.0, straggler_factor=4.0)
        s = mk(model_params, injector=FaultInjector(plan), watchdog=wd)
        for p in PROMPTS:
            s.submit(p, 8)
        s.run()
        assert any(e["kind"] in ("straggler", "dead") for e in wd.events)


def test_combined_fault_plan_token_exact(model_params, baseline):
    plan = ServeFaultPlan(step_exception_at=1, page_pressure_at=2,
                          page_pressure_release_at=8, nan_logits_at=5)
    s, out = run_plan(model_params, plan)
    st_ = s.stats()
    assert st_["preemptions"] >= 1
    assert st_["fallback_steps"] >= 2
    assert all(r.finish_reason in FINISH_REASONS for r in s.finished)
    assert out == baseline
    kinds = [e["kind"] for e in st_["watchdog_events"]]
    assert "step_exception" in kinds and "nan_logits" in kinds


# ---------------------------------------------------------------------------
# Snapshot / restore
# ---------------------------------------------------------------------------
class TestSnapshot:
    def test_mid_decode_restore_token_exact(self, model_params, baseline):
        s = mk(model_params)
        for p in PROMPTS:
            s.submit(p, 8)
        for _ in range(3):
            s.step()
        snap = s.snapshot()
        restored = mk(model_params).restore(snap)
        assert streams(s.run()) == baseline
        assert streams(restored.run()) == baseline
        restored.check_invariants()

    def test_snapshot_is_deep_copy(self, model_params):
        s = mk(model_params)
        for p in PROMPTS:
            s.submit(p, 8)
        s.step()
        snap = s.snapshot()
        live = {r.rid: list(r.tokens_out) for r in s.slots if r is not None}
        pages = {li: a.copy() for li, a in snap["pool"]["k_pages"].items()}
        s.run()
        for d in snap["slots"]:
            if d is not None:
                assert d["tokens_out"] == live[d["rid"]]
        for li, a in pages.items():
            assert np.array_equal(snap["pool"]["k_pages"][li], a)

    def test_restore_preserves_sampling_rng(self, model_params):
        def build():
            return mk(model_params, temperature=0.8, top_k=8, seed=7)

        s = build()
        for p in PROMPTS:
            s.submit(p, 8)
        for _ in range(3):
            s.step()
        snap = s.snapshot()
        assert streams(s.run()) == streams(build().restore(snap).run())

    def test_restore_rejects_config_mismatch(self, model_params):
        s = mk(model_params)
        s.submit(PROMPTS[0], 4)
        s.step()
        snap = s.snapshot()
        with pytest.raises(ValueError, match="config"):
            mk(model_params, max_slots=2).restore(snap)

    def test_snapshot_to_dir_restores_token_exact(self, model_params,
                                                  baseline, tmp_path):
        s = mk(model_params)
        for p in PROMPTS:
            s.submit(p, 8)
        for _ in range(3):
            s.step()
        d = s.snapshot_to_dir(tmp_path / "snap")
        s.snapshot_to_dir(tmp_path / "snap")  # an atomic replace
        assert sorted(p.name for p in (tmp_path / "snap").iterdir()) == \
            ["host000.npz", "meta.json"]
        restored = mk(model_params).restore_from_dir(d)
        assert streams(restored.run()) == baseline
        restored.check_invariants()


def test_stats_shape(model_params):
    s = mk(model_params)
    s.submit(PROMPTS[0], 4)
    s.run()
    st_ = s.stats()
    for key in ("n_steps", "n_decode_steps", "finish_reasons",
                "preemptions", "fallback_steps", "recomputes",
                "watchdog_events", "compiler_events", "pool"):
        assert key in st_
    assert st_["finish_reasons"] == {"max_tokens": 1}


# ---------------------------------------------------------------------------
# Churn property (test_serving_props.py)
# ---------------------------------------------------------------------------
def churn_property(model_params, ops, seed):
    """ops: ("submit", plen, new, deadline) | ("step",) | ("seize", n) |
    ("release",) | ("tick", dt)."""
    model, params = model_params
    rng = np.random.default_rng(seed)
    clk = [0.0]
    sched = Scheduler(model, params, max_slots=3, page_size=4, n_pages=24,
                      max_model_len=32, prefill_chunk=4,
                      cache_dtype="float32", compile_cache=CACHE,
                      queue_ttl_s=60.0, clock=lambda: clk[0], device="cpu")
    seized, n_submitted = [], 0
    for op in ops:
        if op[0] == "submit":
            _, plen, new, deadline = op
            sched.submit(list(rng.integers(0, model.cfg.vocab, plen)),
                         new, deadline_s=deadline)
            n_submitted += 1
        elif op[0] == "step":
            sched.step()
        elif op[0] == "seize":
            seized.extend(sched.pool.seize(op[1]))
        elif op[0] == "release":
            if seized:
                sched.pool.release(seized)
                seized = []
        else:
            clk[0] += op[1]
        sched.check_invariants()
    if seized:
        sched.pool.release(seized)
    sched.run()
    sched.check_invariants()
    assert not sched.queue
    assert all(r is None for r in sched.slots)
    assert len(sched.finished) == n_submitted
    for r in sched.finished:
        assert r.done and r.finish_reason in FINISH_REASONS


def _random_ops(rng) -> list:
    ops = []
    for _ in range(int(rng.integers(4, 20))):
        k = int(rng.integers(0, 5))
        if k == 0:
            deadline = [None, 3.0, 30.0][int(rng.integers(0, 3))]
            ops.append(("submit", int(rng.integers(1, 11)),
                        int(rng.integers(1, 9)), deadline))
        elif k == 1:
            ops.append(("step",))
        elif k == 2:
            ops.append(("seize", int(rng.integers(0, 9))))
        elif k == 3:
            ops.append(("release",))
        else:
            ops.append(("tick", float(rng.uniform(0.1, 4.0))))
    return ops


@pytest.mark.parametrize("seed", range(8))
def test_churn_preserves_invariants_fuzz(model_params, seed):
    rng = np.random.default_rng(1000 + seed)
    churn_property(model_params, _random_ops(rng), seed)


if HAVE_HYPOTHESIS:
    OPS = st.lists(
        st.one_of(
            st.tuples(st.just("submit"), st.integers(1, 10),
                      st.integers(1, 8),
                      st.sampled_from([None, 3.0, 30.0])),
            st.tuples(st.just("step")),
            st.tuples(st.just("seize"), st.integers(0, 8)),
            st.tuples(st.just("release")),
            st.tuples(st.just("tick"), st.floats(0.1, 4.0)),
        ),
        min_size=4, max_size=20)

    @settings(max_examples=10, deadline=None,
              suppress_health_check=[HealthCheck.function_scoped_fixture,
                                     HealthCheck.too_slow])
    @given(ops=OPS, seed=st.integers(0, 2**31 - 1))
    def test_churn_preserves_invariants_hypothesis(model_params, ops, seed):
        churn_property(model_params, list(ops), seed)


# ---------------------------------------------------------------------------
# Which errors the ladder may take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("error, device, want", [
    (StepFault("injected_step_exception"), "cpu", True),
    (StepFault("injected_compile_failure"), "cuda", True),
    (RuntimeError("kernel failed to launch"), "cpu", True),
    (RuntimeError("kernel failed to launch"), "cuda", False),
    (RuntimeError("kernel failed to launch"), torch.device("cuda", 0),
     False),
])
def test_degrades_takes_planted_faults_only_on_the_card(error, device, want):
    assert degrades(error, device) is want


def _break_attention_kernel(monkeypatch, fault):
    """Compile every grid step with its first attention kernel missing
    (``no_kernel``) or its annotation stale (``stale_labels``)."""
    grid = serving_compile.DecodeStepCompiler._compile_grid

    def broken(self, B, ctx):
        step = grid(self, B, ctx)
        st, entry = next(
            ((st, nd) for st in step.compiled.sdfg.states for nd in st.nodes
             if isinstance(nd, MapEntry)
             and cuda_backend.KERNEL_ANNOTATION in nd.map.annotations),
            (None, None))
        if entry is None:       # a bucket too small to convert
            pass
        elif fault == "no_kernel":
            del entry.map.annotations[cuda_backend.KERNEL_ANNOTATION]
        else:
            next(n for n in st.scope_children()[entry]
                 if isinstance(n, Tasklet)).label += "_edited"
        return step

    monkeypatch.setattr(serving_compile.DecodeStepCompiler, "_compile_grid",
                        broken)


@pytest.mark.parametrize("fault", ["no_kernel", "stale_labels"])
@pytest.mark.parametrize("card_rule", [False, True])
def test_attention_kernel_that_cannot_launch(model_params, baseline,
                                             monkeypatch, fault, card_rule):
    """On the CPU a step whose attention kernel cannot launch degrades to
    the interpreter rung and still serves the baseline's first tokens;
    under the card's rule (only planted faults degrade) the
    GridLaunchError raises out of ``Scheduler.run``."""
    _break_attention_kernel(monkeypatch, fault)
    if card_rule:
        on_card = lambda e, device: degrades(e, "cuda")  # noqa: E731
        monkeypatch.setattr(serving_scheduler, "degrades", on_card)
        monkeypatch.setattr(serving_compile, "degrades", on_card)
    model, params = model_params
    s = Scheduler(model, params, max_slots=4, device="cpu", donate=False,
                  compile_cache=CompilationCache(), **GEOMETRY)
    for p in PROMPTS[:2]:       # B = 2: the attention scopes convert
        s.submit(p, 3)
    if card_rule:
        with pytest.raises(cuda_backend.GridLaunchError):
            s.run()
        return
    reqs = s.run()
    assert [r.finish_reason for r in reqs] == ["max_tokens"] * 2
    assert {k: v[:3] for k, v in streams(reqs).items()} == {
        k: baseline[k][:3] for k in (0, 1)}
    assert s.n_fallback_steps == s.n_decode_steps == 2
    assert all("GridLaunchError" in e["detail"]
               for e in s.watchdog.faults_of("step_exception"))
