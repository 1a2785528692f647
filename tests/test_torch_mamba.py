"""The port's Mamba/hybrid family against the reference package on the same
inputs: the selective scans (step by step and chunked) against the
reference's, the Mamba block with and without a decode cache on the
reference's own weights, the reduced jamba-1.5-large-398b's leaves,
forward, decode and served step. Tolerances: the scans and the block
rtol/atol 2e-4 (the reference's ``tests/test_wkv_ssm.py``), the forward's
logits rtol/atol 1e-4 and its aux loss rtol 1e-5 (the MoE forward's in
``tests/test_torch_moe.py``), decode against the forward 2e-3
(``tests/test_models_smoke.py``); the served step's state rows, grid
kernels and fused regions exactly, its greedy streams token for token.
Everything runs on the CPU; the card runs the block in
``test_torch_gpu.py -k mamba`` and jamba at full width in
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import blocks as rblocks
from repro.models.transformer import TransformerLM as RTransformerLM
from repro.pipeline.cache import CompilationCache as RCompilationCache
from repro.serving import Scheduler as RScheduler
from repro.serving.compile import state_specs as rstate_specs
from repro_torch.configs import get_config
from repro_torch.core.sdfg import Tasklet
from repro_torch.models import (TransformerLM, blocks, build_model,
                                lm_params_from_reference)
from repro_torch.pipeline.cache import CompilationCache
from repro_torch.serving import Scheduler
from repro_torch.serving import compile as serving_compile

ARCH = "jamba-1.5-large-398b"


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _cfgs(f32=True):
    rcfg, cfg = rget_config(ARCH).reduced(), get_config(ARCH).reduced()
    if f32:
        rcfg = dataclasses.replace(rcfg, activation_dtype="float32")
        cfg = dataclasses.replace(cfg, activation_dtype="float32")
    return rcfg, cfg


# ---------------------------------------------------------------------------
# the selective scans
# ---------------------------------------------------------------------------
def _ssm_inputs(seed, B, S, Din, N):
    """``tests/test_wkv_ssm.py``'s draws: decays in (-2, -0.01)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, Din)).astype(np.float32)
    ldA = -np.abs(rng.uniform(0.01, 2.0, (B, S, Din, N))).astype(np.float32)
    dBu = (rng.standard_normal((B, S, Din, N)) * 0.2).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, Din, N)) * 0.1).astype(np.float32)
    return u, ldA, dBu, C, s0


@pytest.mark.parametrize("state0", [True, False], ids=["state0", "zero"])
@pytest.mark.parametrize("S", [16, 64, 20])
@pytest.mark.parametrize("scan", ["ref", "chunked"])
def test_ssm_scan_matches_reference(scan, S, state0):
    """Both scans against the reference's, y and the last state. The
    reference's chunked scan takes whole chunks only, so at S = 20 (the
    port's chunked scan takes a partial last chunk) it is held to the
    reference's step scan; a chunked scan starts from a state, zeros
    without ``state0`` (as ``mamba_apply`` gives it)."""
    u, ldA, dBu, C, s0 = _ssm_inputs(S + state0, 2, S, 6, 4)
    if not state0:
        s0 = None if scan == "ref" else np.zeros_like(s0)
    rscan = rblocks._ssm_scan_chunked if scan == "chunked" and S % 16 == 0 \
        else rblocks._ssm_scan_ref
    fn = blocks._ssm_scan_chunked if scan == "chunked" \
        else blocks._ssm_scan_ref
    y_want, st_want = rscan(*(None if a is None else jnp.asarray(a)
                              for a in (u, ldA, dBu, C, s0)))
    y, st = fn(*(None if a is None else torch.as_tensor(a)
                 for a in (u, ldA, dBu, C, s0)))
    assert y.shape == (2, S, 6) and st.shape == (2, 6, 4)
    _close(y, y_want, 2e-4, 2e-4)
    _close(st, st_want, 2e-4, 2e-4)


def test_ssm_chunked_keeps_one_chunk_of_states(monkeypatch):
    """The chunked scan's cumulative sums run over one (B, 16, Din, N)
    slab at a time, never over the whole sequence's states."""
    shapes = []
    cumsum = torch.cumsum

    def recorded(x, dim):
        shapes.append(tuple(x.shape))
        return cumsum(x, dim=dim)

    monkeypatch.setattr(torch, "cumsum", recorded)
    u, ldA, dBu, C, s0 = map(torch.as_tensor, _ssm_inputs(0, 2, 64, 6, 4))
    blocks._ssm_scan_chunked(u, ldA, dBu, C, s0)
    assert shapes == [(2, blocks.SSM_CHUNK, 6, 4)] * 8


# ---------------------------------------------------------------------------
# the Mamba block on the reference's weights
# ---------------------------------------------------------------------------
def test_mamba_init_leaves_match_reference():
    """Names, shapes and dtypes of the reference's leaves; its constant
    leaves (dt_bias, D, the norm) equal, A_log = log(1..N) to an fp32 ulp
    (the two libraries' logs round apart); the scales of the drawn
    ones."""
    _, cfg = _cfgs()
    rp = rblocks.mamba_init(rget_config(ARCH).reduced(),
                            jax.random.PRNGKey(0))
    p = blocks.mamba_init(cfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in p.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in rp.items()}
    for key in ("dt_bias", "D", "ln_scale"):
        np.testing.assert_array_equal(p[key].numpy(), np.asarray(rp[key]))
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(rp["A_log"]),
                               rtol=2.0 ** -23, atol=0)
    assert p["A_log"].is_contiguous()
    d_in = cfg.expand * cfg.d_model
    want = 1.0 / np.sqrt(d_in * 2 * cfg.n_layers)
    assert abs(float(p["w_out"].std()) / want - 1) < 0.05
    assert abs(float(p["conv_w"].std()) / 0.5 - 1) < 0.1


def _mamba_case(seed, b, s, cached):
    rcfg, cfg = _cfgs()
    rp = jax.tree.map(np.asarray, rblocks.mamba_init(
        rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    cache = None
    if cached:
        d_in = cfg.expand * cfg.d_model
        cache = {"conv": rng.standard_normal(
                     (b, cfg.d_conv - 1, d_in)).astype(np.float32),
                 "ssm": (rng.standard_normal((b, d_in, cfg.d_state))
                         * 0.1).astype(np.float32)}
    return rcfg, cfg, rp, x, cache


@pytest.mark.parametrize("cached,s", [(False, 32), (False, 20), (True, 1),
                                      (True, 16), (True, 20)],
                         ids=["none-32", "none-20", "cache-1", "cache-16",
                              "cache-20"])
def test_mamba_apply_matches_reference(cached, s):
    """The block's output and its new cache (the conv's last rows, the
    state) against the reference's: no cache (S 32 takes the chunked scan,
    S 20 the step scan), and from a random cache at s = 1 (the one-step
    update), 16 (chunked) and 20 (the step scan)."""
    rcfg, cfg, rp, x, cache = _mamba_case(s + 3 * cached, 2, s, cached)
    want, rnc = rblocks.mamba_apply(
        rcfg, rp, jnp.asarray(x),
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, nc = blocks.mamba_apply(
        cfg, {k: torch.as_tensor(np.array(v)) for k, v in rp.items()},
        torch.as_tensor(x),
        cache=None if cache is None else
        {k: torch.as_tensor(v) for k, v in cache.items()})
    _close(got, want, 2e-4, 2e-4)
    assert (nc is None) == (rnc is None)
    if cached:
        assert set(nc) == set(rnc) == {"conv", "ssm"}
        for key in nc:
            assert nc[key].dtype == torch.float32
            _close(nc[key], rnc[key], 2e-4, 2e-4)


def test_mamba_cache_is_float32_whatever_the_dtype():
    _, cfg = _cfgs()
    model = TransformerLM(cfg)
    cache = model.init_cache(2, 8, dtype=torch.bfloat16)
    d_in = cfg.expand * cfg.d_model
    specs = model.layer_specs
    assert [s.kind for s in specs] == ["attn", "mamba", "mamba", "mamba"]
    assert cache["layers"][0]["k"].dtype == torch.bfloat16
    for layer in cache["layers"][1:]:
        assert layer["conv"].shape == (2, cfg.d_conv - 1, d_in)
        assert layer["ssm"].shape == (2, d_in, cfg.d_state)
        assert {a.dtype for a in layer.values()} == {torch.float32}


# ---------------------------------------------------------------------------
# the reduced jamba
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jamba():
    """(reference model, its PRNGKey(0) params, port model, the same
    params), fp32 activations."""
    rcfg, cfg = _cfgs()
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    return rmodel, rparams, model, params


def test_build_model_runs_the_hybrid_family():
    model = build_model(get_config(ARCH).reduced())
    assert isinstance(model, TransformerLM)
    assert [(s.kind, s.is_moe) for s in model.layer_specs] == [
        ("attn", False), ("mamba", True), ("mamba", False), ("mamba", True)]
    params = model.init(torch.Generator().manual_seed(0))
    logits, aux = model.forward(params, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)})
    assert bool(torch.isfinite(logits[..., :model.cfg.vocab]).all())
    assert float(aux) > 0.0


def test_leaves_match_reference():
    """The port's init draws the reference's leaves, layer by layer: the
    same groups, names, shapes and dtypes (the reference's stacked over
    its one period)."""
    rcfg, cfg = rget_config(ARCH).reduced(), get_config(ARCH).reduced()
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rtree = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    params = model.init(torch.Generator().manual_seed(0))
    assert rmodel.n_periods == 1 and not rmodel.tail_specs

    def leaves(d, strip=0):
        return {(g, k): (tuple(a.shape)[strip:],
                         str(a.dtype).removeprefix("torch."))
                for g, kd in d.items() for k, a in kd.items()}

    for li, layer in enumerate(params["layers"]):
        assert leaves(layer) == leaves(rtree["body"][li], strip=1)
    assert set(params["layers"][1]) == {"mamba", "ffn"}
    assert "router" in params["layers"][1]["ffn"]
    assert "w_gate" in params["layers"][2]["ffn"]
    for key in ("embed", "final_scale", "lm_head"):
        assert tuple(params[key].shape) == tuple(rtree[key].shape)
    assert set(params) == set(rtree) - {"body", "tail"} | {"layers"}


def test_mamba_leaves_carried_from_the_reference(jamba):
    """lm_params_from_reference carries the ``mamba`` group across."""
    _, rparams, _, params = jamba
    for li in (1, 2, 3):
        for key, a in rparams["body"][li]["mamba"].items():
            assert np.array_equal(params["layers"][li]["mamba"][key].numpy(),
                                  np.asarray(a)[0])


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("S", [20, 32])
def test_forward_matches_reference(jamba, S, training):
    """Logits and the summed aux loss at S 20 (the step scan) and 32 (the
    chunked scan); ``training`` drops MoE tokens past capacity on both
    sides."""
    rmodel, rparams, model, params = jamba
    toks = np.random.default_rng(S).integers(
        0, model.cfg.vocab, (2, S)).astype(np.int32)
    want, raux = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)},
                                training=training)
    got, aux = model.forward(params, {"tokens": torch.as_tensor(toks)},
                             training=training)
    assert got.shape == (2, S, model.vocab_padded)
    _close(got, want, 1e-4, 1e-4)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("chunks", [(1,) * 12, (16, 1, 1, 1, 1)],
                         ids=["tokens", "chunked"])
def test_decode_matches_forward(chunks):
    """Decode against an fp32 cache equals the full-sequence forward at the
    reference's 2e-3 (``test_models_smoke.py::test_decode_matches_forward``,
    whose archs include jamba): one token a step, and a 16-token chunk
    (the chunked scan from the zero state) then single tokens."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    T = sum(chunks)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, T)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 32, dtype=torch.float32)
    outs, t = [], 0
    for n in chunks:
        lg, cache = model.decode_step(params, cache, toks[:, t:t + n])
        outs.append(lg)
        t += n
    assert cache["pos"] == T
    _close(torch.cat(outs, 1), full, 2e-3, 2e-3)


def test_decode_step_matches_reference(jamba):
    """Chunks of 16 (chunked), 3 (step scan), 1 and 1, each step's logits
    against the reference's decode_step on its own cache."""
    rmodel, rparams, model, params = jamba
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, 21)).astype(np.int32)
    rcache = rmodel.init_cache(2, 24, dtype=jnp.float32)
    cache = model.init_cache(2, 24, dtype=torch.float32)
    for lo, hi in ((0, 16), (16, 19), (19, 20), (20, 21)):
        want, rcache = rmodel.decode_step(rparams, rcache,
                                          jnp.asarray(toks[:, lo:hi]))
        got, cache = model.decode_step(params, cache,
                                       torch.as_tensor(toks[:, lo:hi]))
        _close(got, want, 1e-4, 1e-4)
    for li in (1, 2, 3):
        for key in ("conv", "ssm"):
            _close(cache["layers"][li][key],
                   np.asarray(rcache["body"][li][key])[0], 2e-4, 2e-4)


# ---------------------------------------------------------------------------
# the served step
# ---------------------------------------------------------------------------
def _serve(model, params, prompts, new, **kw):
    s = Scheduler(model, params, device="cpu",
                  compile_cache=CompilationCache(), **kw)
    for p in prompts:
        s.submit(list(map(int, p)), new)
    reqs = s.run()
    s.check_invariants()
    return s, [r.tokens_out for r in reqs]


def _rserve(model, params, prompts, new, **kw):
    s = RScheduler(model, params, compile_cache=RCompilationCache(), **kw)
    for p in prompts:
        s.submit(list(map(int, p)), new)
    return s, [r.tokens_out for r in s.run()]


GEOMETRY = dict(max_slots=4, page_size=8, n_pages=32, max_model_len=64)


def test_state_specs_match_reference(jamba):
    """The Mamba layers' state rows: the reference's names, shapes and
    dtype strings (float32, whatever the cache dtype)."""
    rmodel, _, model, _ = jamba
    specs = serving_compile.state_specs(model)
    assert specs == rstate_specs(rmodel)
    cfg = model.cfg
    d_in = cfg.expand * cfg.d_model
    assert sorted(specs) == [f"st{li}__{k}" for li in (1, 2, 3)
                             for k in ("conv", "ssm")]
    assert specs["st1__conv"] == (1, (cfg.d_conv - 1, d_in), "float32")
    assert specs["st3__ssm"] == (3, (d_in, cfg.d_state), "float32")


def test_step_structure_matches_reference(jamba):
    """The compiled step at test_serving.py:206's geometry (B = 16, fp32,
    dtype-aware sublanes): the same tokens, buckets, grid kernels (the one
    attention layer's), fused regions, no fallback; each Mamba layer is a
    whole-array tasklet followed by its FFN's."""
    rmodel, rparams, model, params = jamba
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (16, 6), 0, model.cfg.vocab))
    kw = dict(max_slots=16, page_size=8, n_pages=64, max_model_len=64,
              prefill_chunk=8, dtype_aware_sublanes=True)
    rs, want = _rserve(rmodel, rparams, prompts, 3, **kw)
    s, got = _serve(model, params, prompts, 3, **kw)
    assert got == want
    assert sorted(s.compiler._steps) == sorted(rs.compiler._steps)
    for key, step in s.compiler._steps.items():
        rep, rrep = step.report, rs.compiler._steps[key].report
        assert rep["grid_kernels"] == rrep["grid_kernels"] == \
            ["attn0_grid_tiled"]
        assert rep.get("fused_regions", []) == rrep.get("fused_regions", [])
        assert not rep["grid_fallbacks"] and not rep["grid_skipped"]
        labels = {n.label for st in step.compiled.sdfg.states
                  for n in st.nodes if isinstance(n, Tasklet)}
        assert {"mamba1", "mamba2", "mamba3", "ffn0", "ffn1", "ffn2",
                "ffn3"} <= labels
    assert set(s.compiler._donate) == set(
        serving_compile.state_specs(model)) | {"kp0", "vp0"}


@pytest.mark.parametrize("chunk", [4, 16])
def test_streams_match_reference_scheduler(jamba, chunk):
    """4 prompts of 6 in prefill chunks of 4 (the step scan), and prompts
    of 36 in chunks of 16 (the chunked scan from the zero state, then from
    the first chunk's state and conv rows, then 4 tokens through the step
    scan): the reference Scheduler's streams."""
    rmodel, rparams, model, params = jamba
    L = 6 if chunk == 4 else 36
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, L), 0, model.cfg.vocab))
    kw = dict(GEOMETRY, prefill_chunk=chunk)
    _, want = _rserve(rmodel, rparams, prompts, 5, **kw)
    s, got = _serve(model, params, prompts, 5, **kw)
    assert got == want
    assert all(st.rung == "grid" for st in s.compiler._steps.values())
    assert not s.compiler.events and s.n_fallback_steps == 0


def _dense_greedy(model, params, prompts, new):
    """Greedy decode through decode_step on an fp32 cache, whole prompts
    first."""
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int32)
    cache = model.init_cache(len(prompts), toks.shape[1] + new,
                             dtype=torch.float32)
    logits, cache = model.decode_step(params, cache, toks)
    streams = [[t] for t in logits[:, -1].argmax(-1).tolist()]
    for _ in range(new - 1):
        last = torch.as_tensor([[s[-1]] for s in streams], dtype=torch.int32)
        logits, cache = model.decode_step(params, cache, last)
        for s, t in zip(streams, logits[:, 0].argmax(-1).tolist()):
            s.append(t)
    return streams


def test_streams_match_decode_loop_after_chunked_prefill(jamba):
    """3 prompts of 20 tokens admitted in prefill chunks of 16 (a 16-token
    chunk takes the chunked scan, the 4-token tail the step scan from the
    carried state and conv rows) into 4 slots (one padding lane), fp32
    cache: the streams equal the decode_step loop that takes each whole
    prompt at once (the step scan over 20 tokens)."""
    _, _, model, params = jamba
    prompts = np.random.default_rng(5).integers(
        0, model.cfg.vocab, (3, 20)).astype(np.int32)
    kw = dict(GEOMETRY, prefill_chunk=16, cache_dtype="float32")
    s, got = _serve(model, params, prompts, 6, **kw)
    assert got == _dense_greedy(model, params, prompts, 6)
    assert any(B > len(prompts) for B, _ in s.compiler._steps)


def test_state_rows_written_in_place(jamba):
    """A donating step writes the Mamba layers' conv and ssm rows in place
    (no copy); a non-donating one leaves its inputs intact. Admission
    wrote the prompt's rows first."""
    _, _, model, params = jamba
    for donate in (True, False):
        s = Scheduler(model, params, device="cpu",
                      compile_cache=CompilationCache(), donate=donate,
                      **GEOMETRY, prefill_chunk=4)
        s.submit([1, 2, 3, 4, 5], 3)
        s.step()
        for li in (1, 2, 3):
            assert bool(s.states[f"st{li}__conv"][0].abs().sum())
            assert bool(s.states[f"st{li}__ssm"][0].abs().sum())
        B, ctx = s._buckets([r for r in s.slots if r is not None])
        kwargs = s._step_kwargs(B, ctx)
        before = {n: kwargs[n].clone() for n in s.states}
        out = s.compiler.step_for(B, ctx)(kwargs)
        for n in s.states:
            assert (out[n].data_ptr() == s.states[n].data_ptr()) == donate
            assert torch.equal(kwargs[n], before[n]) != donate
