"""The served decode step's counterpart of the reference's ``jax.jit``
bucket (``serving/graphs.py``) and its host side, on the CPU: the greedy
tokens and row finiteness taken where the logits lie equal ``_sample``'s
float64 argmax (bf16 and fp32, ties, planted non-finite rows); the
scheduler copies the whole logits to the host only when the injector or a
temperature needs them; asking for the capture on ``cuda`` without a card
raises, and the CPU runs the step op by op; the launch counters that a
replay adds back; the harness's CPU run at one intra-op thread restores the
count; a plain block program keeps its operands' indices only with its
grid. The capture itself runs on the card (``tests/test_torch_gpu.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import programs
from repro_torch.benchmarks import run as bench_run, serve_bench
from repro_torch.benchmarks.run import host_threads
from repro_torch.codegen import cuda_backend
from repro_torch.configs import get_config
from repro_torch.models import TransformerLM
from repro_torch.pipeline import lower
from repro_torch.pipeline.cache import CompilationCache
from repro_torch.serving import (DecodeStepCompiler, FaultInjector, Scheduler,
                                 ServeFaultPlan, graphs)
from repro_torch.serving.scheduler import greedy_picks


def _sample_greedy(row):
    """``Scheduler._sample`` at temperature 0, as written."""
    s = Scheduler.__new__(Scheduler)
    s.temperature = 0.0
    return s._sample(row)


def _logits(seed, B, V, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, V)).astype(np.float32) * 4
    # ties: the row's largest value planted again, later in the row, and
    # small integers that collide after the cast
    x[0, V // 3] = x[0, V // 2] = x[0].max() + 1.0
    x[1] = np.round(x[1])
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(4))
def test_device_greedy_equals_float64_argmax(dtype, seed):
    B, V = 9, 1000
    lg = _logits(seed, B, V, dtype)
    bad = {2: float("nan"), 3: float("inf"), 4: float("-inf")}
    for row, v in bad.items():
        lg[row, (7 * row) % V] = v
    tokens, finite = greedy_picks(lg)
    rows = lg.float().numpy()
    assert finite.tolist() == [bool(np.isfinite(r).all()) for r in rows]
    assert finite.sum() == B - len(bad)
    for b in range(B):
        if finite[b]:
            assert tokens[b] == _sample_greedy(rows[b])
    assert tokens[0] == V // 3          # the first of the tied maxima


@pytest.fixture(scope="module")
def model_params():
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def _serve(model_params, **kw):
    model, params = model_params
    s = Scheduler(model, params, max_slots=4, page_size=4, n_pages=32,
                  max_model_len=32, prefill_chunk=4, device="cpu",
                  cache_dtype="float32", compile_cache=CompilationCache(),
                  **kw)
    for p in ([1, 2, 3], [4, 5], [6, 7, 8, 9]):
        s.submit(p, 5)
    return {r.rid: r.tokens_out for r in s.run()}, s


def test_full_logits_reach_the_host_only_when_needed(model_params,
                                                      monkeypatch):
    """Greedy without an injector copies B tokens and B flags a step;
    sampling at a temperature, or an armed injector, copies the logits."""
    greedy, s = _serve(model_params)
    assert s.stats()["logit_copies"] == 0 and s.n_decode_steps > 0
    _, s = _serve(model_params, temperature=0.7, seed=3)
    assert s.stats()["logit_copies"] == s.n_decode_steps > 0
    faulted, s = _serve(model_params,
                        injector=FaultInjector(ServeFaultPlan()))
    assert s.stats()["logit_copies"] >= s.n_decode_steps > 0
    assert faulted == greedy
    # a greedy decode step samples no row on the host: only each request's
    # first token (its prefill's last row) is
    rows = []
    sample = Scheduler._sample

    def counted(self, row):
        rows.append(row)
        return sample(self, row)
    monkeypatch.setattr(Scheduler, "_sample", counted)
    again, s = _serve(model_params)
    assert again == greedy
    assert len(rows) == len(again) and s.n_decode_steps > 0


def test_capture_needs_a_card_and_the_cpu_runs_eagerly(model_params):
    model, params = model_params
    kw = dict(page_size=4, n_pages=32, cache_dtype="float32",
              cache=CompilationCache())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DecodeStepCompiler(model, params, device="cuda", **kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            DecodeStepCompiler(model, params, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.StepGraphs("cpu")
    comp = DecodeStepCompiler(model, params, device="cpu", **kw)
    assert comp.graphs is None
    step = comp.step_for(2, 8)
    assert step.graphs is None and step.captured is None
    _, s = _serve(model_params)
    assert all(st.captured is None for st in s.compiler._steps.values())


def test_a_replay_adds_back_what_its_capture_launched():
    """What the counters moved while a step was captured is put back, and
    added again at each replay, a dict in place."""
    from repro_torch.codegen import cuda_backend as cb
    from repro_torch.kernels.gemm import matmul
    routes = matmul.routes
    snap = graphs.counts_snapshot()
    try:
        cb.reset_launch_counts()
        fma = routes["fma"]
        before = graphs.counts_snapshot()
        cb.run_grid_kernel.launches += 3
        cb.run_grid_kernel.launches_by_name["attn0_grid_tiled"] = 3
        routes["fma"] += 2
        moved = graphs._moved(before)
        graphs.restore_counts(before)
        assert cb.run_grid_kernel.launches == 0
        assert cb.run_grid_kernel.launches_by_name == {}
        assert matmul.routes is routes and routes["fma"] == fma
        for _ in range(2):
            graphs._add(moved)
        assert cb.run_grid_kernel.launches == 6
        assert cb.run_grid_kernel.launches_by_name == {"attn0_grid_tiled": 6}
        assert matmul.routes is routes and routes["fma"] == fma + 4
    finally:
        graphs.restore_counts(snap)


def test_host_threads_restores_the_count():
    n = torch.get_num_threads()
    with host_threads(1):
        assert torch.get_num_threads() == 1
    assert torch.get_num_threads() == n
    with host_threads(None):
        assert torch.get_num_threads() == n
    with pytest.raises(KeyError):
        with host_threads(1):
            raise KeyError
    assert torch.get_num_threads() == n


def test_a_cpu_run_of_the_harness_runs_on_one_thread(model_params,
                                                      monkeypatch):
    """``run --device cpu`` runs its modules on ``CPU_THREADS`` intra-op
    threads and gives the count back; a serving step sets none."""
    seen = []

    def spy(report, small=False, device=None):
        seen.append(torch.get_num_threads())
    monkeypatch.setattr(serve_bench, "run", spy)
    n = torch.get_num_threads()
    assert bench_run.main(["--only", "serve", "--small",
                           "--device", "cpu"]) == 0
    assert seen == [bench_run.CPU_THREADS]
    assert torch.get_num_threads() == n
    with host_threads(n + 1):
        _serve(model_params)
        assert torch.get_num_threads() == n + 1


@pytest.mark.parametrize("keep,grid_kept", [(64, False), (1 << 20, True)])
def test_a_plain_program_keeps_indices_only_with_its_grid(keep, grid_kept,
                                                         monkeypatch):
    """A grid of 1-element blocks in batches of 64 steps: where the grid
    holds more than ``KEEP_INDEX_ELEMS`` elements it is not kept, and then
    neither is any batch's operand index (each small enough to keep), so a
    second run adds nothing to the program's memo; where it fits, the grid
    and the indices are kept. Either way the second run gives the first's
    result."""
    n = 4096
    monkeypatch.setattr(cuda_backend, "PLAIN_BATCH_ELEMS", 64)
    monkeypatch.setattr(cuda_backend, "KEEP_INDEX_ELEMS", keep)
    seen = set()
    grid = cuda_backend.GridProgram._grid

    def spy(self, device):
        seen.add(self)
        return grid(self, device)
    monkeypatch.setattr(cuda_backend.GridProgram, "_grid", spy)
    ct = lower(programs.axpydot(n)).compile(
        "cuda", cache=None, device="cpu",
        pipeline=programs.axpydot_grid_pipeline(True, tiled=False))
    rng = np.random.default_rng(5)
    d = {k: torch.from_numpy(rng.standard_normal(n).astype(np.float32))
         for k in "xyw"}
    d["a"] = torch.tensor(1.5)
    first = ct(**d)["result"].clone()
    (prog,) = seen
    kept = dict(prog._memo)
    assert (("grid", "cpu") in kept) == grid_kept
    assert any(k[0] == "gather" for k in kept) == grid_kept
    again = ct(**d)["result"]
    assert prog._memo.keys() == kept.keys()
    assert torch.equal(again, first)
    want = np.dot(1.5 * d["x"].double().numpy() + d["y"].double().numpy(),
                  d["w"].double().numpy())
    assert abs(float(first) - want) <= 1e-4 * max(1.0, abs(want))
