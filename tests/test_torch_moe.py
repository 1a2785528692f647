"""The port's MoE family against the reference package on the same
inputs: ``moe_block`` in every combination of dispatch (onehot, sort),
top_k (1, 2, 8), shared expert, token dropping and capacity factor; the
port's sort dispatch against its onehot; the MoE branch of ``ffn_apply``
on the reference's own weights; reduced llama4-scout-17b-a16e and
kimi-k2-1t-a32b forwards in eval and training mode; decode against the
forward. Tolerances: fp32 outputs rtol/atol 2e-4 (the reference's
``test_sort_moe_matches_onehot``), the aux loss rtol 1e-5, logits rtol/atol
1e-4, decode against the forward 2e-3 (``test_models_smoke.py``), bf16
outputs within 2^-8 of the output's largest magnitude (one bf16 ulp at
the top binade: both sides may order the sums differently). Everything
runs on the CPU; the card runs the block in ``test_torch_gpu.py -k moe``
and in ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import blocks as rblocks
from repro.models import layers as rlayers
from repro.models.transformer import TransformerLM as RTransformerLM
from repro_torch.configs import get_config
from repro_torch.models import (TransformerLM, blocks, build_model,
                                lm_params_from_reference)
from repro_torch.models import layers

MOE_ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b")


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _moe_inputs(seed, top_k, shared, b=2, s=24, d=16, f=32):
    """x, router and expert weights drawn from ``seed``, over max(8, k)
    experts."""
    rng = np.random.default_rng(seed)
    e = max(8, top_k)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    wg, wu = (rng.standard_normal((e, d, f)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.standard_normal((e, f, d)).astype(np.float32) * 0.3
    sh = None
    if shared:
        sh = {k: rng.standard_normal(sh_).astype(np.float32) * 0.3
              for k, sh_ in (("w_gate", (d, f)), ("w_up", (d, f)),
                             ("w_down", (f, d)))}
    return x, router, wg, wu, wd, sh


def _to_torch(arrays, dtype=torch.float32):
    x, router, wg, wu, wd, sh = arrays
    t = lambda a: torch.as_tensor(a).to(dtype)  # noqa: E731
    return (t(x), torch.as_tensor(router), t(wg), t(wu), t(wd),
            None if sh is None else {k: t(v) for k, v in sh.items()})


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [1.0, 1.25])
@pytest.mark.parametrize("drop", [True, False], ids=["drop", "nodrop"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("top_k", [1, 2, 8])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_block_matches_reference(dispatch, top_k, shared, drop, cf):
    """fp32, 48 tokens over 8 experts: with ``drop`` the capacity
    (ceil(k T cf / E), at least 4) is too small for the busiest expert, so
    tokens really drop (the reference's own output differs from its
    no-drop output)."""
    arrays = _moe_inputs(100 + top_k, top_k, shared)
    x, router, wg, wu, wd, sh = arrays
    kw = dict(top_k=top_k, capacity_factor=cf, dispatch=dispatch,
              drop_tokens=drop)
    want, raux = rlayers.moe_block(x, router, wg, wu, wd, shared=sh, **kw)
    tx, tr, twg, twu, twd, tsh = _to_torch(arrays)
    got, aux = layers.moe_block(tx, tr, twg, twu, twd, shared=tsh, **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, 2e-4, 2e-4)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    if drop and top_k < 8:
        kept, _ = rlayers.moe_block(x, router, wg, wu, wd, shared=sh,
                                    **dict(kw, drop_tokens=False))
        assert np.abs(np.asarray(kept) - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "nodrop"])
@pytest.mark.parametrize("top_k", [1, 8])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_block_bf16_close_to_reference(dispatch, top_k, drop):
    """bf16 activations and expert weights (the router stays fp32, as
    ``ffn_apply`` passes it): the same routing, the output within 2^-8 of
    its largest magnitude."""
    arrays = _moe_inputs(200 + top_k, top_k, True)
    x, router, wg, wu, wd, sh = arrays
    bf = jnp.bfloat16
    kw = dict(top_k=top_k, capacity_factor=1.0, dispatch=dispatch,
              drop_tokens=drop)
    want, raux = rlayers.moe_block(
        jnp.asarray(x, bf), jnp.asarray(router), jnp.asarray(wg, bf),
        jnp.asarray(wu, bf), jnp.asarray(wd, bf),
        shared={k: jnp.asarray(v, bf) for k, v in sh.items()}, **kw)
    got, aux = layers.moe_block(*_to_torch(arrays, torch.bfloat16)[:5],
                                shared=_to_torch(arrays,
                                                 torch.bfloat16)[5], **kw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= \
        2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_sort_moe_matches_onehot():
    """The port's two dispatches agree (the reference's
    ``test_sort_moe_matches_onehot``: capacity factor 8, top-2)."""
    rng = np.random.default_rng(5)
    b, s, d, e, f, k = 2, 16, 8, 4, 16, 2
    t = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    x = t(rng.standard_normal((b, s, d)))
    router = t(rng.standard_normal((d, e)))
    wg = t(rng.standard_normal((e, d, f)) * 0.3)
    wu = t(rng.standard_normal((e, d, f)) * 0.3)
    wd = t(rng.standard_normal((e, f, d)) * 0.3)
    out1, aux1 = layers.moe_block(x, router, wg, wu, wd, top_k=k,
                                  capacity_factor=8.0, dispatch="onehot")
    out2, aux2 = layers.moe_block(x, router, wg, wu, wd, top_k=k,
                                  capacity_factor=8.0, dispatch="sort")
    _close(out2, out1, 2e-4, 2e-4)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_top_k_breaks_ties_toward_the_lower_index(k):
    """Equal router columns tie; the port routes them as
    ``jax.lax.top_k``, lower expert index first, and the block's output
    follows."""
    rng = np.random.default_rng(k)
    probs = rng.integers(0, 4, (40, 12)).astype(np.float32) / 4
    rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
    v, i = layers._top_k(torch.as_tensor(probs), k)
    assert torch.equal(i, torch.as_tensor(np.asarray(ri)).long())
    assert torch.equal(v, torch.as_tensor(np.asarray(rv)))
    x, router, wg, wu, wd, _ = _moe_inputs(7, 8, False, s=8)
    router[:, 3] = router[:, 1]
    router[:, 6] = router[:, 1]
    want, _ = rlayers.moe_block(x, router, wg, wu, wd, top_k=k,
                                drop_tokens=False)
    tx, tr, twg, twu, twd, _ = _to_torch((x, router, wg, wu, wd, None))
    got, _ = layers.moe_block(tx, tr, twg, twu, twd, top_k=k,
                              drop_tokens=False)
    _close(got, want, 2e-4, 2e-4)


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "nodrop"])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_kimi_k2_routing_matches_reference(dispatch, drop):
    """kimi-k2-1t-a32b's published routing (384 experts, top-8, capacity
    factor 1.0, a shared expert) at a narrow width (D 32, F 16) over 48
    tokens: capacity max(ceil(8 48 / 384), 4) = 4 slots an expert."""
    m = get_config("kimi-k2-1t-a32b").moe
    rng = np.random.default_rng(384)
    b, s, d, f, e = 2, 24, 32, 16, m.n_experts
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    wg, wu = (rng.standard_normal((e, d, f)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.standard_normal((e, f, d)).astype(np.float32) * 0.3
    sh = {k: rng.standard_normal(sh_).astype(np.float32) * 0.3
          for k, sh_ in (("w_gate", (d, f)), ("w_up", (d, f)),
                         ("w_down", (f, d)))}
    kw = dict(top_k=m.top_k, capacity_factor=m.capacity_factor,
              dispatch=dispatch, drop_tokens=drop)
    want, raux = rlayers.moe_block(x, router, wg, wu, wd, shared=sh, **kw)
    tx, tr, twg, twu, twd, tsh = _to_torch((x, router, wg, wu, wd, sh))
    got, aux = layers.moe_block(tx, tr, twg, twu, twd, shared=tsh, **kw)
    _close(got, want, 2e-4, 2e-4)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    assert layers.moe_capacity(b * s, m.top_k, e, m.capacity_factor,
                               drop) == (4 if drop else b * s)


def test_capacity_from_static_shapes():
    assert layers.moe_capacity(48, 1, 8, 1.0, True) == 6
    assert layers.moe_capacity(48, 2, 8, 1.25, True) == 15
    assert layers.moe_capacity(4, 1, 16, 1.25, True) == 4
    assert layers.moe_capacity(48, 8, 8, 1.0, False) == 48


# ---------------------------------------------------------------------------
# the MoE FFN block on the reference's weights
# ---------------------------------------------------------------------------
def _cfg(arch, f32=True):
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    if f32:
        rcfg = dataclasses.replace(rcfg, activation_dtype="float32")
        cfg = dataclasses.replace(cfg, activation_dtype="float32")
    return rcfg, cfg


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ffn_apply_moe_matches_reference(arch, training):
    rcfg, cfg = _cfg(arch)
    rp = jax.tree.map(np.asarray, rblocks.ffn_init(
        rcfg, jax.random.PRNGKey(3), True))
    p = {k: torch.as_tensor(v) for k, v in rp.items()}
    x = np.random.default_rng(4).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    want, raux = rblocks.ffn_apply(rcfg, rp, jnp.asarray(x), True,
                                   training=training)
    got, aux = blocks.ffn_apply(cfg, p, torch.as_tensor(x), True,
                                training=training)
    _close(got, want, 2e-4, 2e-4)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ffn_init_moe_leaves_match_reference(arch):
    """The keys, shapes and dtypes of the reference's MoE leaves, and
    moe_down's scale 1/sqrt(F 2 L) (the (E, D, F) leaves take fan_in = E,
    as the reference's dense_init)."""
    _, cfg = _cfg(arch)
    rp = rblocks.ffn_init(rget_config(arch).reduced(),
                          jax.random.PRNGKey(0), True)
    p = blocks.ffn_init(cfg, torch.Generator().manual_seed(0), True)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in p.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in rp.items()}
    m = cfg.moe
    assert p["router"].shape == (cfg.d_model, m.n_experts)
    assert p["moe_gate"].shape == (m.n_experts, cfg.d_model, m.d_ff_expert)
    assert p["moe_down"].shape == (m.n_experts, m.d_ff_expert, cfg.d_model)
    want = 1.0 / np.sqrt(m.d_ff_expert * 2 * cfg.n_layers)
    assert abs(float(p["moe_down"].std()) / want - 1) < 0.05
    assert abs(float(p["moe_up"].std()) * np.sqrt(m.n_experts) - 1) < 0.05


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    """(reference model, its PRNGKey(0) params, port model, the same
    params), fp32 activations."""
    rcfg, cfg = _cfg(request.param)
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    return rmodel, rparams, model, params


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_build_model_runs_the_moe_family(arch):
    model = build_model(get_config(arch).reduced())
    assert isinstance(model, TransformerLM)
    assert all(s.is_moe for s in model.layer_specs)
    params = model.init(torch.Generator().manual_seed(0))
    logits, aux = model.forward(params, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)})
    assert bool(torch.isfinite(logits[..., :model.cfg.vocab]).all())
    assert float(aux) > 0.0


def test_moe_leaves_carried_from_the_reference(moe_model):
    """lm_params_from_reference unstacks each MoE leaf over the periods."""
    _, rparams, model, params = moe_model
    for li, layer in enumerate(params["layers"]):
        for key in ("router", "moe_gate", "moe_up", "moe_down", "sh_gate",
                    "sh_down", "ln_scale"):
            want = np.asarray(rparams["body"][0]["ffn"][key])[li]
            assert np.array_equal(layer["ffn"][key].numpy(), want)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_forward_matches_reference(moe_model, training):
    """Logits and the summed aux loss; ``training`` drops tokens past
    capacity on both sides (the training-mode logits differ from eval's)."""
    rmodel, rparams, model, params = moe_model
    toks = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 16)).astype(np.int32)
    want, raux = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)},
                                training=training)
    got, aux = model.forward(params, {"tokens": torch.as_tensor(toks)},
                             training=training)
    assert got.shape == (2, 16, model.vocab_padded)
    _close(got, want, 1e-4, 1e-4)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    assert float(aux) > 0.0
    if training:
        evl, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
        assert not torch.equal(evl, got)


def test_decode_matches_forward():
    """Reduced llama4-scout: token-by-token decode against an fp32 cache
    equals the full-sequence forward at the reference's 2e-3
    (``test_models_smoke.py::test_decode_matches_forward``): eval mode
    drops no token, so the routing does not see the sequence length."""
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e").reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    T = 12
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, T)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 32, dtype=torch.float32)
    outs = []
    for t in range(T):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        outs.append(lg)
    _close(torch.cat(outs, 1), full, 2e-3, 2e-3)


def test_decode_step_matches_reference(moe_model):
    rmodel, rparams, model, params = moe_model
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, 6)).astype(np.int32)
    rcache = rmodel.init_cache(2, 12, dtype=jnp.float32)
    cache = model.init_cache(2, 12, dtype=torch.float32)
    for lo, hi in ((0, 3), (3, 4), (4, 5)):
        want, rcache = rmodel.decode_step(rparams, rcache,
                                          jnp.asarray(toks[:, lo:hi]))
        got, cache = model.decode_step(params, cache,
                                       torch.as_tensor(toks[:, lo:hi]))
        _close(got, want, 1e-4, 1e-4)
