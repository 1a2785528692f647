"""The port's RWKV6 family against the reference package on the same
inputs: the plain WKV versions (kernel row 13's plain version, the
sequential scan, the chunked form from a nonzero state), the RWKV block,
and reduced rwkv6-7b carrying the reference's own ``jax.random`` weights
across (``lm_params_from_reference``).

Tolerances: the WKV at the reference tests' own (rtol/atol 3e-4 against
its Pallas kernel and sequential oracle, ``test_attention_rwkv_kernels.py``;
2e-4 for the chunked form from a state, ``test_wkv_ssm.py``). The logits
at rtol/atol 2e-5: the chunked WKV's decay factors are exponentials of
16-term log sums (up to 56 in size), which both packages round in their
own order, so the two forwards differ by more than the dense family's
1e-5 (measured: 5e-6 on logits up to 4.5); 2e-5 stays far inside the
3e-4 of the WKV itself. ``chip_smoke.py``'s fp32 parity check is held
against CPU emulations of the kernel's three tf32 products and of one. The
CUDA kernel runs in ``test_torch_gpu.py`` and ``chip_smoke.py``; on the CPU
its wrapper takes the plain version."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.kernels.rwkv import wkv_chunked as rwkv_chunked_kernel
from repro.kernels.rwkv import wkv_ref as rwkv_ref
from repro.models import blocks as rblocks
from repro.models.transformer import TransformerLM as RTransformerLM
from repro_torch.configs import get_config
from repro_torch.kernels import rwkv as wkv_mod
from repro_torch.kernels.rwkv import (WKVLimitError, wkv_chunked,
                                      wkv_chunked_ref, wkv_ref)
from repro_torch.models import (TransformerLM, blocks, build_model,
                                lm_params_from_reference)


def _wkv_inputs(seed, B, S, H, hd):
    """The reference tests' draws (``test_wkv_ssm.py::_wkv_inputs``): decays
    in the range the model produces, exp(-0.5 - 3 sigmoid)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-0.5 - 3.0 * rng.uniform(0, 1, (B, S, H, hd))
               ).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    return r, k, v, w, u, s0


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the plain WKV versions (kernel row 13)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [16, 64, 160])
@pytest.mark.parametrize("hd", [8, 32])
def test_plain_wkv_chunked_matches_pallas_kernel(S, hd):
    """test_attention_rwkv_kernels.py:57's cases: the zero-state chunked
    WKV against the reference's Pallas kernel (interpret mode) and its
    sequential oracle, output and final state."""
    r, k, v, w, u, _ = _wkv_inputs(S + hd, 2, S, 3, hd)
    s0 = np.zeros((2, 3, hd, hd), np.float32)
    want_k, st_k = rwkv_chunked_kernel(*map(jnp.asarray, (r, k, v, w, u)),
                                       interpret=True)
    want_r, st_r = rwkv_ref(*map(jnp.asarray, (r, k, v, w, u, s0)))
    got, st = wkv_chunked(*_t(r, k, v, w, u))
    assert got.dtype == torch.float32 and st.shape == (2, 3, hd, hd)
    for want, want_st in ((want_k, st_k), (want_r, st_r)):
        _close(got, want, 3e-4)
        _close(st, want_st, 3e-4)


@pytest.mark.parametrize("S", [16, 64, 128])
def test_plain_wkv_chunked_from_a_state_matches_reference(S):
    """test_wkv_ssm.py:26's cases: the chunked form from a nonzero state0
    (the model's chunked prefill) against the reference's
    blocks._wkv_chunked and both packages' sequential scans."""
    r, k, v, w, u, s0 = _wkv_inputs(S, 2, S, 3, 8)
    jin = list(map(jnp.asarray, (r, k, v, w, u, s0)))
    want, want_st = rblocks._wkv_chunked(*jin)
    seq, seq_st = rblocks._wkv_scan(*jin)
    got, st = wkv_chunked(*_t(r, k, v, w, u, s0))
    for ref_out, ref_st in ((want, want_st), (seq, seq_st)):
        _close(got, ref_out, 2e-4)
        _close(st, ref_st, 2e-4)
    got64, st64 = wkv_ref(*(x.double() for x in _t(r, k, v, w, u, s0)))
    _close(got, got64, 2e-4)
    _close(st, st64, 2e-4)


def test_plain_wkv_chunked_widens_bf16():
    """bf16 inputs are computed in fp32: the output is the fp32 result of
    the widened inputs rounded to bf16, the state fp32."""
    r, k, v, w, u, s0 = _t(*_wkv_inputs(3, 1, 32, 2, 16))
    bf = [x.to(torch.bfloat16) for x in (r, k, v, w)]
    got, st = wkv_chunked_ref(*bf, u, s0)
    want, want_st = wkv_chunked_ref(*(x.float() for x in bf), u, s0)
    assert got.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16))
    assert torch.equal(st, want_st)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_wkv_split_by_value_columns_equals_the_whole(hd, with_state):
    """The identity the kernel's value-channel blocks rest on: the WKV run
    on v[..., e0:e1] and state0[..., e0:e1] alone (the plain sequential
    scan, which takes a v narrower than k) gives columns e0:e1 of the
    whole call, for slices of 16 (a warp's value channels; a kernel block
    holds four) and a last slice that hd leaves short; the whole call also matches the
    reference (its Pallas kernel from a zero state, its chunked form from
    a state). Rtol/atol as the tests above."""
    r, k, v, w, u, s0 = _wkv_inputs(hd + with_state, 1, 32, 2, hd)
    if not with_state:
        s0 = np.zeros_like(s0)
    whole, whole_st = wkv_chunked(*_t(r, k, v, w, u, s0))
    if with_state:
        want, want_st = rblocks._wkv_chunked(*map(jnp.asarray,
                                                  (r, k, v, w, u, s0)))
    else:
        want, want_st = rwkv_chunked_kernel(
            *map(jnp.asarray, (r, k, v, w, u)), interpret=True)
    _close(whole, want, 3e-4)
    _close(whole_st, want_st, 3e-4)
    E = 16     # the value channels of one warp of a kernel block
    for e0, e1 in [(e, min(e + E, hd)) for e in range(0, hd, E)] + [
            (hd - 8, hd)]:
        out, st = wkv_ref(*_t(r, k, v[..., e0:e1], w, u, s0[..., e0:e1]))
        _close(out, whole[..., e0:e1], 3e-4)
        _close(st, whole_st[..., e0:e1], 3e-4)
        _close(out, np.asarray(want)[..., e0:e1], 3e-4)


def test_wkv_scan_matches_reference():
    r, k, v, w, u, s0 = _wkv_inputs(5, 2, 7, 3, 8)
    want, want_st = rblocks._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    got, st = blocks._wkv_scan(*_t(r, k, v, w, u, s0))
    _close(got, want, 1e-5)
    _close(st, want_st, 1e-5)


def test_wkv_decode_consistency():
    """test_wkv_ssm.py:49: chunked prefill then per-token sequential steps
    equal the full sequential scan."""
    r, k, v, w, u, s0 = _t(*_wkv_inputs(9, 1, 48, 2, 8))
    out_full, st_full = blocks._wkv_scan(r, k, v, w, u, s0)
    out_pre, st = blocks._wkv_chunked(r[:, :32], k[:, :32], v[:, :32],
                                      w[:, :32], u, s0)
    outs = [out_pre]
    for t in range(32, 48):
        o, st = blocks._wkv_scan(r[:, t:t + 1], k[:, t:t + 1],
                                 v[:, t:t + 1], w[:, t:t + 1], u, st)
        outs.append(o)
    _close(torch.cat(outs, dim=1), out_full, 3e-4)
    _close(st, st_full, 3e-4)


def test_wkv_chunked_refuses_what_the_kernel_does_not_take():
    """The reference asserts S % 16 == 0; the port raises ValueError. An hd
    over the kernel's 256 (hd / 2 state floats a lane) raises
    WKVLimitError on the CPU too, so a call that runs here runs on the
    card; every hd up to it fits the 227 KB of shared memory a block may
    use, in fp32 and bf16."""
    r, k, v, w, u, _ = _t(*_wkv_inputs(1, 1, 24, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        wkv_chunked(r, k, v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv_chunked(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u[:1])
    with pytest.raises(ValueError, match="state0 must be"):
        wkv_chunked(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u,
                    torch.zeros(1, 2, 8, 4))
    kern = wkv_mod.kernel
    assert kern.MAX_HEAD == 256
    assert kern.smem_bytes(64) == 55_552
    assert kern.smem_bytes(64, itemsize=2) == 39_168
    assert max(kern.smem_bytes(hd, size) for hd in range(1, 257)
               for size in (2, 4)) == kern.smem_bytes(256) <= 232_448
    z = torch.zeros(1, 16, 1, 256)
    wkv_chunked(z, z, z, z, torch.zeros(1, 256))
    z = torch.zeros(1, 16, 1, 257)
    with pytest.raises(WKVLimitError, match="over the 256"):
        wkv_chunked(z, z, z, z, torch.zeros(1, 257))


# ---------------------------------------------------------------------------
# the RWKV block and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,state", [
    ((1, 16, 64, 64), "zero"), ((1, 16, 64, 64), "random"),
    ((2, 256, 8, 64), "none"),
], ids=["admission-zero", "admission-random", "forward"])
def test_smoke_wkv_parity_passes_three_tf32_products_and_fails_one(shape,
                                                                   state):
    """``chip_smoke.py``'s WKV checks on the CPU at the serving admission
    shape (from a zero and from a random state) and a reduced forward:
    ``Smoke.wkv_tf32_only`` with three tf32 products (the kernel's route)
    passes the WKV limit and parity with the plain version, on the outputs
    and the state; with one (the control) it fails the two together by at
    least CONTROL_MARGIN on the outputs, where the limit alone gave 1.0-1.4x
    on the card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    smoke = mod.Smoke()
    smoke.dev = torch.device("cpu")
    r, k, v, w, u, s0 = smoke.wkv_inputs(*shape, torch.float32, 240, state)
    want, want_st, mag, mag_st, lam = smoke.wkv_terms(r, k, v, w, u, s0)
    plain, plain_st = wkv_chunked_ref(r, k, v, w, u, s0)
    three, three_st = smoke.wkv_tf32_only(r, k, v, w, u, s0, products=3)
    assert smoke.wkv_within(three, want, mag, lam, 0.0)[0]
    assert smoke.wkv_within(three_st, want_st, mag_st, lam, 0.0)[0]
    assert mod.parity(three, plain, want)[0]
    assert mod.parity(three_st, plain_st, want_st)[0]
    one, one_st = smoke.wkv_tf32_only(r, k, v, w, u, s0)
    ratio = smoke.wkv_within(one, want, mag, lam, 0.0)[2]
    ok, par = mod.parity(one, plain, want)
    assert not ok and max(ratio, par) >= mod.CONTROL_MARGIN
    assert not mod.parity(one_st, plain_st, want_st)[0]


@pytest.fixture(scope="module")
def rwkv():
    """(reference model, reference params, port model, port params): reduced
    rwkv6-7b, fp32 activations, the reference's PRNGKey(0) weights."""
    rcfg = dataclasses.replace(rget_config("rwkv6-7b").reduced(),
                               activation_dtype="float32")
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              activation_dtype="float32")
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    return rmodel, rparams, model, params


@pytest.mark.parametrize("s", [16, 5])
@pytest.mark.parametrize("with_cache", [False, True])
def test_rwkv_apply_matches_reference(rwkv, s, with_cache):
    """One block of layer 0, the chunked (s = 16) and sequential (s = 5)
    paths, from no cache and from a nonzero cache; output and new cache."""
    rmodel, rparams, model, params = rwkv
    cfg = model.cfg
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    p = params["layers"][0]["rwkv"]
    rp = jax.tree.map(lambda a: np.asarray(a)[0], rparams["body"][0]["rwkv"])
    cache = rcache = None
    if with_cache:
        H, hd = cfg.n_heads, cfg.head_dim
        parts = {"shift1": (2, 1, cfg.d_model), "shift2": (2, 1, cfg.d_model),
                 "wkv": (2, H, hd, hd)}
        arrs = {n: (rng.standard_normal(sh) * 0.1).astype(np.float32)
                for n, sh in parts.items()}
        cache = {n: torch.as_tensor(a) for n, a in arrs.items()}
        rcache = {n: jnp.asarray(a) for n, a in arrs.items()}
    want, want_c = rblocks.rwkv_apply(rmodel.cfg, rp, jnp.asarray(x),
                                      cache=rcache)
    got, got_c = blocks.rwkv_apply(cfg, p, torch.as_tensor(x), cache=cache)
    _close(got, want, 2e-5)
    assert (got_c is None) == (want_c is None)
    if with_cache:
        for n in ("shift1", "shift2", "wkv"):
            _close(got_c[n], want_c[n], 2e-5)


def test_forward_matches_reference(rwkv):
    """32 tokens (two WKV chunks a layer) through the 4 reduced layers."""
    rmodel, rparams, model, params = rwkv
    toks = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 32)).astype(np.int32)
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 32, model.vocab_padded) and float(aux) == 0.0
    _close(got, want, 2e-5)


def test_decode_step_matches_reference(rwkv):
    """A 16-token chunk (the chunked WKV from the cache's zero state), a
    second 16-token chunk (from a nonzero state), then single tokens (the
    sequential scan): logits and the recurrent states."""
    rmodel, rparams, model, params = rwkv
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, 35)).astype(np.int32)
    rcache = rmodel.init_cache(2, 40, dtype=jnp.float32)
    cache = model.init_cache(2, 40, dtype=torch.float32)
    for lo, hi in ((0, 16), (16, 32), (32, 33), (33, 34), (34, 35)):
        want, rcache = rmodel.decode_step(rparams, rcache,
                                          jnp.asarray(toks[:, lo:hi]))
        got, cache = model.decode_step(params, cache,
                                       torch.as_tensor(toks[:, lo:hi]))
        _close(got, want, 2e-5)
    assert cache["pos"] == int(rcache["pos"]) == 35
    for key in ("shift1", "shift2", "wkv"):
        _close(cache["layers"][1][key], np.asarray(rcache["body"][0][key])[1],
               2e-5)


def test_chunked_calls_go_through_the_kernel_wrapper(rwkv, monkeypatch):
    """Every chunked WKV call of the model goes through the kernel's
    wrapper (on the CPU it takes the plain version): forward passes
    state0=None, a decode chunk the cache's state; a single token takes
    the sequential scan."""
    _, _, model, params = rwkv
    calls = []

    def spy(r, k, v, w, u, state0=None):
        calls.append(None if state0 is None else tuple(state0.shape))
        return wkv_chunked(r, k, v, w, u, state0)

    monkeypatch.setattr(blocks, "wkv_chunked", spy)
    toks = torch.arange(1, 33, dtype=torch.int32)[None]
    model.forward(params, {"tokens": toks})
    L, H, hd = model.cfg.n_layers, model.cfg.n_heads, model.cfg.head_dim
    assert calls == [None] * L
    calls.clear()
    cache = model.init_cache(1, 33, dtype=torch.float32)
    _, cache = model.decode_step(params, cache, toks[:, :16])
    _, cache = model.decode_step(params, cache, toks[:, 16:17])
    assert calls == [(1, H, hd, hd)] * L


def test_rwkv_init_draws_from_the_generator():
    model = build_model(get_config("rwkv6-7b").reduced())
    p1 = model.init(torch.Generator().manual_seed(3))
    p2 = model.init(torch.Generator().manual_seed(3))
    cfg = model.cfg
    layer = p1["layers"][1]["rwkv"]
    assert list(p1["layers"][1]) == ["rwkv"]
    assert torch.equal(layer["wr"], p2["layers"][1]["rwkv"]["wr"])
    assert layer["u_bonus"].shape == (cfg.n_heads, cfg.head_dim)
    assert layer["cm_wk"].shape == (cfg.d_model, cfg.d_ff)
    assert {"ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"} <= set(layer)
    assert p1["lm_head"].shape == (cfg.d_model, model.vocab_padded)
    n = sum(t.numel() for layer in p1["layers"] for t in layer["rwkv"].values())
    rtree = RTransformerLM(rget_config("rwkv6-7b").reduced()).init(
        jax.random.PRNGKey(0))
    assert n == sum(np.asarray(a).size
                    for a in jax.tree.leaves(rtree["body"]))
