"""The port's serving scripts against the reference's: the serving
benchmark (``repro_torch.benchmarks.serve_bench``, through the port's
harness ``repro_torch.benchmarks.run``) reports the rows of the
reference's small run (``benchmarks/serve_bench.py``) by name and in
order; each arch's compiled fp32 greedy streams equal its baseline loop's;
the generated attention row kernel at gemma3-4b's served head shape (Dh
256, 8 heads GQA-gathered from 4, window 1,024, a context of 2,048 with
pos past the window), run by the CPU emulator, against the reference's
plain attention on the same numpy inputs; and the port's ``serve_lm``
example in its small modes. Everything runs on the CPU."""
import json

import numpy as np
import pytest
import torch

from repro.frontends.api import Program as RProgram
from repro.library import PagedAttnDecode as RPagedAttnDecode
from repro.pipeline import lower as rlower
from repro_torch import programs
from repro_torch.benchmarks import run as bench_run
from repro_torch.benchmarks import serve_bench
from repro_torch.configs import get_config
from repro_torch.examples import serve_lm
from repro_torch.models import TransformerLM
from repro_torch.pipeline import lower

from test_torch_grid import _emulated_launch

#: the rows ``benchmarks/serve_bench.py`` reports in its small run, in its
#: order (its sharded rows need two devices and are skipped on one)
REFERENCE_SMALL_ROWS = [
    "serve_starcoder2_3b_b1_baseline_tps",
    "serve_starcoder2_3b_b1_compiled_tps",
    "serve_starcoder2_3b_b8_baseline_tps",
    "serve_starcoder2_3b_b8_compiled_tps",
    "serve_gemma3_4b_b1_baseline_tps",
    "serve_gemma3_4b_b1_compiled_tps",
    "serve_gemma3_4b_b8_baseline_tps",
    "serve_gemma3_4b_b8_compiled_tps",
    "serve_rwkv6_7b_b1_baseline_tps",
    "serve_rwkv6_7b_b1_compiled_tps",
    "serve_rwkv6_7b_b8_baseline_tps",
    "serve_rwkv6_7b_b8_compiled_tps",
    "serve_starcoder2_3b_b16_f32_tps",
    "serve_starcoder2_3b_faulted_tps",
]


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """The harness's small serve run on the CPU, with its JSON record."""
    out = tmp_path_factory.mktemp("bench")
    rc = bench_run.main(["--only", "serve", "--small", "--device", "cpu",
                         "--json", str(out)])
    return rc, out


def test_small_run_reports_the_reference_rows_in_order(small_run):
    rc, out = small_run
    assert rc == 0
    assert sorted(p.name for p in out.iterdir()) == ["BENCH_serve.json"]
    entries = json.loads((out / "BENCH_serve.json").read_text())
    assert [e["name"] for e in entries] == REFERENCE_SMALL_ROWS
    assert all(e["small"] and e["value"] > 0 for e in entries)
    by = {e["name"]: e for e in entries}
    for arch in ("starcoder2_3b", "gemma3_4b", "rwkv6_7b"):
        for B in (1, 8):
            row = by[f"serve_{arch}_b{B}_compiled_tps"]
            assert row["p99_ms"] >= row["p50_ms"] > 0
            assert by[f"serve_{arch}_b{B}_baseline_tps"]["derived"] == \
                "dense ctx=128"
    # one attention grid kernel a layer at B = 8 (reduced: 4 and 6
    # layers), none for the RWKV steps
    assert by["serve_starcoder2_3b_b8_compiled_tps"]["grid_kernels"] == 4
    assert by["serve_gemma3_4b_b8_compiled_tps"]["grid_kernels"] == 6
    assert by["serve_rwkv6_7b_b8_compiled_tps"]["grid_kernels"] == 0
    assert by["serve_starcoder2_3b_b16_f32_tps"]["grid_kernels"] >= 1
    faulted = by["serve_starcoder2_3b_faulted_tps"]
    assert faulted["preemptions"] >= 1 and faulted["fallback_steps"] >= 1
    assert faulted["batch"] == 8 and faulted["fault_free_tps"] > 0


def test_failed_module_writes_no_record(tmp_path, monkeypatch, capsys):
    """A module that raises makes the harness exit 1 and leaves no partial
    record; an unknown module is refused."""
    def boom(report, small=False, device=None):
        report("serve_starcoder2_3b_b1_baseline_tps", 1.0)
        raise AssertionError("planted")

    monkeypatch.setattr(serve_bench, "run", boom)
    assert bench_run.main(["--only", "serve", "--json", str(tmp_path),
                           "--device", "cpu"]) == 1
    assert list(tmp_path.iterdir()) == []
    assert "serve,ERROR,AssertionError: planted" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        bench_run.main(["--only", "roofline"])


@pytest.mark.parametrize("arch", serve_bench.ARCHS)
def test_compiled_fp32_streams_equal_baseline_loop(arch):
    """At B = 8 (the small run's geometry, fp32 activations and caches)
    the scheduler's compiled steps give the plain decode_step loop's
    greedy streams token for token."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(serve_bench.SEED))
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(8, serve_bench.PROMPT))
    dev = torch.device("cpu")
    _, base = serve_bench.baseline(model, params, prompts, 8, 128, dev,
                                   cache_dtype=torch.float32)
    _, _, _, rep, got, _ = serve_bench.compiled_run(
        model, params, prompts, 8, 128, dev, cache_dtype="float32")
    assert got == base
    assert len(rep["grid_kernels"]) == (0 if arch == "rwkv6-7b"
                                        else cfg.n_layers)


def _rattn_program(B, C, H, Dh, window):
    p = RProgram("decode_attention")
    q = p.input("q", (B, H, Dh), "float32")
    k = p.input("k", (B, C, H, Dh), "float32")
    v = p.input("v", (B, C, H, Dh), "float32")
    pos = p.input("pos", (B,), "int32")
    out = p.add_op(RPagedAttnDecode("attn0", window=window),
                   {"q": q, "k": k, "v": v, "pos": pos},
                   out_shapes={"out": (B, H, Dh)}, out_dtypes={"out": "float32"})
    p.output("out", out)
    return p.finalize()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1024, None])
def test_generated_attention_at_gemma3_served_shape(window, dt):
    """gemma3-4b's served attention: Dh 256, 8 query heads over K/V
    gathered from 4 KV heads as the step's ``gather`` expands them, a
    context of 2,048 with pos past the 1,024-token window (the window run's
    last step, and the context's end), a windowed and a global layer. The
    generated row kernel's Triton source under the CPU emulator against the
    reference's plain attention (``PagedAttnDecode`` at its ``xla`` level)
    on the same seeded numpy inputs, bf16 rounded for both."""
    B, C, H, Hkv, Dh = 3, 2048, 8, 4, 256
    rng = np.random.default_rng(2048)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k, v = (np.repeat(rng.standard_normal((B, C, Hkv, Dh)).astype(
        np.float32), H // Hkv, axis=2) for _ in range(2))
    pos = np.array([1062, 2047, 1500], np.int32)
    tdt = getattr(torch, dt)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    sdfg = programs.decode_attention_program(B, C, H, Dh, window, dt)
    c = lower(sdfg).compile("cuda", cache=None, device="cpu")
    assert c.report["grid_kernels"] == ["attn0_grid_tiled"]
    (kernel,) = {id(n.map): n.map.annotations["grid_kernel"]
                 for st in c.sdfg.states for n in st.nodes
                 if "grid_kernel" in getattr(getattr(n, "map", None),
                                             "annotations", {})}.values()
    outs = {"out": torch.zeros(B, H, Dh, dtype=tdt)}
    _emulated_launch(kernel.desc, kernel.source,
                     {"q": tq, "k": tk, "v": tv, "pos": torch.as_tensor(pos)},
                     outs)
    rc = rlower(_rattn_program(B, C, H, Dh, window)).compile(
        backend="jnp", expansion_level="xla", cache=None)
    want = np.asarray(rc(q=tq.float().numpy(), k=tk.float().numpy(),
                         v=tv.float().numpy(), pos=pos)["out"])
    tol = 2.0 ** -7 if dt == "bfloat16" else 1e-5
    np.testing.assert_allclose(outs["out"].float().numpy(), want, rtol=tol,
                               atol=tol)
    if window is not None:
        # the window excludes rows: the same heads over the whole prefix
        # differ
        rg = rlower(_rattn_program(B, C, H, Dh, None)).compile(
            backend="jnp", expansion_level="xla", cache=None)
        full = np.asarray(rg(q=tq.float().numpy(), k=tk.float().numpy(),
                             v=tv.float().numpy(), pos=pos)["out"])
        assert np.abs(full - want).max() > 10 * tol


@pytest.mark.parametrize("mode", [[], ["--faults"], ["--snapshot-at", "3"]])
def test_serve_lm_small_runs_on_cpu(mode, capsys):
    """``serve_lm --small`` on the CPU: every request served with a typed
    finish reason, one attention grid kernel a layer in each bucket; with
    ``--faults`` the faulted streams equal the fault-free ones, with
    ``--snapshot-at`` the restored run is token-exact (the example's own
    assertions)."""
    res = serve_lm.main(["--small", "--device", "cpu"] + mode)
    assert len(res["streams"]) == 6
    assert set(res["stats"]["finish_reasons"]) <= {"max_tokens", "eos"}
    out = capsys.readouterr().out
    assert "grid_kernels=['attn0_grid_tiled', 'attn1_grid_tiled', " \
           "'attn2_grid_tiled', 'attn3_grid_tiled']" in out
    if mode == ["--faults"]:
        assert res["stats"]["preemptions"] >= 1
        assert "streams byte-identical to fault-free baseline" in out


def test_serve_lm_cluster_sim_waits_for_shard_map():
    with pytest.raises(NotImplementedError, match="ShardMapPass"):
        serve_lm.main(["--small", "--cluster-sim", "--device", "cpu"])


def test_serve_lm_shrink_at_waits_for_shard_map():
    """The mesh shrink is part of the sharded run: the flag raises too,
    instead of being read by nothing."""
    with pytest.raises(NotImplementedError, match="ShardMapPass"):
        serve_lm.main(["--small", "--shrink-at", "3", "--device", "cpu"])
