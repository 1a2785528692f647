"""The port's enc-dec family (``EncDecLM``) against the reference package on
the same inputs: the reduced seamless-m4t-medium (2 encoder + 4 decoder
layers, d 128, 8 frames) carrying the reference's own ``jax.random``
weights across (``encdec_params_from_reference``). Checked: every leaf,
``encode``, ``forward`` with naive and chunked attention (the CPU plain
flash attention), a vocab the padding mask shows in, the bf16 forward,
``prefill_cache``, a decode sequence (one multi-token call, then single
tokens) and the cached branch of ``_decoder_stack``. Tolerances: fp32
rtol/atol 1e-5 (``test_torch_models.py``'s dense forward); bf16 0.1 of
the largest logit with 75% argmax agreement
(``test_bf16_forward_close_to_reference``); decode against the forward
2e-3 (``test_models_smoke.py``). The card runs the model in
``test_torch_gpu.py -k encdec`` and at full width and depth in
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import example_batch as rexample_batch
from repro.models.encdec import EncDecLM as REncDecLM
from repro_torch.configs import get_config
from repro_torch.models import (EncDecLM, TransformerLM, build_model,
                                encdec_params_from_reference, example_batch)

ARCH = "seamless-m4t-medium"


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _pair(impl="naive", activation_dtype="float32", **changes):
    """(reference model, its PRNGKey(0) params, port model, the same
    params) of the reduced config with ``changes`` on both sides."""
    rcfg, cfg = (dataclasses.replace(
        c(ARCH).reduced(), attention_impl=impl,
        activation_dtype=activation_dtype, **changes)
        for c in (rget_config, get_config))
    rmodel, model = REncDecLM(rcfg), EncDecLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = encdec_params_from_reference(
        model, jax.tree.map(np.asarray, rparams))
    return rmodel, rparams, model, params


@pytest.fixture(scope="module", params=["naive", "chunked"])
def seamless(request):
    return _pair(request.param)


def _batch(cfg, B=2, S=7, seed=3):
    b = example_batch(cfg, "train", B, S, seed=seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def test_build_model_gives_encdec():
    cfg = get_config(ARCH)
    assert isinstance(build_model(cfg), EncDecLM)
    model = build_model(cfg.reduced())
    assert isinstance(model, EncDecLM) and model.vocab_padded == 512
    with pytest.raises(ValueError, match="EncDecLM"):
        TransformerLM(cfg)


def test_init_draws_from_the_generator_in_the_reference_layout():
    cfg = get_config(ARCH).reduced()
    model = EncDecLM(cfg)
    p1 = model.init(torch.Generator().manual_seed(3))
    p2 = model.init(torch.Generator().manual_seed(3))
    assert torch.equal(p1["decoder"][1]["cross"]["wk"],
                       p2["decoder"][1]["cross"]["wk"])
    rp = REncDecLM(cfg).init(jax.random.PRNGKey(0))
    assert len(p1["encoder"]) == cfg.n_encoder_layers == 2
    assert len(p1["decoder"]) == cfg.n_layers == 4
    for part in ("encoder", "decoder"):
        for li, layer in enumerate(p1[part]):
            assert set(layer) == set(rp[part])
            for g, d in layer.items():
                assert set(d) == set(rp[part][g])
                for k, a in d.items():
                    ra = rp[part][g][k]
                    assert tuple(a.shape) == ra.shape[1:], (part, g, k)
                    assert str(a.dtype) == f"torch.{ra.dtype}"
    for k in ("embed", "frame_proj", "final_scale", "final_bias", "lm_head"):
        assert tuple(p1[k].shape) == rp[k].shape, k


def test_converted_leaves_equal_the_reference():
    rmodel, rparams, model, params = _pair()
    for k in ("embed", "frame_proj", "final_scale", "final_bias", "lm_head"):
        assert np.array_equal(params[k].numpy(), np.asarray(rparams[k])), k
    n = 0
    for part in ("encoder", "decoder"):
        for li, layer in enumerate(params[part]):
            for g, d in layer.items():
                for k, a in d.items():
                    want = np.asarray(rparams[part][g][k])[li]
                    assert np.array_equal(a.numpy(), want), (part, li, g, k)
                    n += 1
    assert n == sum(a.shape[0] for part in ("encoder", "decoder")
                    for a in jax.tree.leaves(rparams[part]))


def test_encode_matches_reference(seamless):
    rmodel, rparams, model, params = seamless
    rb, b = _batch(model.cfg)
    want = rmodel.encode(rparams, rb["frames"])
    got = model.encode(params, b["frames"])
    assert got.shape == (2, model.cfg.n_stub_tokens, model.cfg.d_model)
    _close(got, want)


def test_encoder_is_bidirectional(seamless):
    """A frame late in the sequence reaches the first position's memory."""
    _, _, model, params = seamless
    _, b = _batch(model.cfg)
    frames = b["frames"].clone()
    base = model.encode(params, frames)
    frames[:, -1] += 1.0
    moved = model.encode(params, frames)
    assert float((moved[:, 0] - base[:, 0]).abs().max()) > 1e-3


def test_forward_matches_reference(seamless):
    rmodel, rparams, model, params = seamless
    rb, b = _batch(model.cfg)
    want, _ = rmodel.forward(rparams, rb)
    got, aux = model.forward(params, b)
    assert got.shape == (2, 7, model.vocab_padded) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_forward_with_a_padded_vocab_matches_reference(impl):
    """vocab 500 pads to 512: the 12 padded columns are -1e30 on both
    sides (the reduced vocab of 512 needs no padding)."""
    rmodel, rparams, model, params = _pair(impl, vocab=500)
    assert model.vocab_padded == rmodel.vocab_padded == 512
    rb, b = _batch(model.cfg)
    want, _ = rmodel.forward(rparams, rb)
    got, _ = model.forward(params, b)
    _close(got, want)
    assert (got[..., 500:] == -1e30).all()
    assert bool(torch.isfinite(got[..., :500]).all())


def test_bf16_forward_close_to_reference():
    """The config's bf16 activations: the same function up to bf16
    rounding (products in bf16 on both sides, differently ordered)."""
    rmodel, rparams, model, params = _pair(activation_dtype="bfloat16")
    rb, b = _batch(model.cfg, B=1, S=8)
    want, _ = rmodel.forward(rparams, rb)
    got, _ = model.forward(params, b)
    assert got.dtype == torch.bfloat16
    V = model.cfg.vocab
    want = np.asarray(want, np.float32)[..., :V]
    got = got.float().numpy()[..., :V]
    assert np.abs(got - want).max() < 0.1 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75


def test_prefill_cache_matches_reference_and_writes_its_argument(seamless):
    """ck/cv of every layer, in the cache's dtype; as the reference's, the
    call assigns them into the cache it is given and returns that cache
    (the zero tensors it held are not written)."""
    rmodel, rparams, model, params = seamless
    cfg = model.cfg
    rb, b = _batch(cfg)
    for rdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        rcache = rmodel.init_cache(2, 12, dtype=rdt)
        rcache = rmodel.prefill_cache(rparams, rcache, rb["frames"])
        cache = model.init_cache(2, 12, dtype=dt, device="cpu")
        zeros = cache["layers"][0]["ck"]
        out = model.prefill_cache(params, cache, b["frames"])
        assert out is cache and cache["layers"][0]["ck"] is not zeros
        assert not zeros.any()
        for li, c in enumerate(cache["layers"]):
            assert c["ck"].dtype == c["cv"].dtype == dt
            assert c["ck"].shape == (2, cfg.n_stub_tokens, cfg.n_kv_heads,
                                     cfg.head_dim)
            for key in ("ck", "cv"):
                want = np.asarray(rcache["layers"][key][li].astype(
                    jnp.float32))
                if dt == torch.float32:
                    _close(c[key], want)
                else:   # one bf16 rounding of values within 1e-5
                    _close(c[key].float(), want, rtol=2 ** -7, atol=1e-5)


def test_init_cache_layout_and_device():
    model = EncDecLM(get_config(ARCH).reduced())
    rcache = REncDecLM(get_config(ARCH).reduced()).init_cache(3, 10)
    cache = model.init_cache(3, 10, device="cpu")
    assert cache["pos"] == 0 and len(cache["layers"]) == 4
    for key in ("k", "v", "ck", "cv"):
        assert cache["layers"][2][key].shape == \
            rcache["layers"][key].shape[1:]
        assert cache["layers"][2][key].dtype == torch.bfloat16
    assert model.init_cache(1, 4, t_enc=5, device="cpu")[
        "layers"][0]["ck"].shape[1] == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init_cache(1, 4)


def test_decode_steps_match_reference(seamless):
    """prefill_cache, then a 3-token decode_step and two single tokens
    against an fp32 cache: logits, pos and the self-attention cache."""
    rmodel, rparams, model, params = seamless
    rb, b = _batch(model.cfg)
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, 5)).astype(np.int32)
    rcache = rmodel.prefill_cache(
        rparams, rmodel.init_cache(2, 12, dtype=jnp.float32), rb["frames"])
    cache = model.prefill_cache(
        params, model.init_cache(2, 12, dtype=torch.float32, device="cpu"),
        b["frames"])
    for lo, hi in ((0, 3), (3, 4), (4, 5)):
        want, rcache = rmodel.decode_step(rparams, rcache,
                                          jnp.asarray(toks[:, lo:hi]))
        got, cache = model.decode_step(params, cache,
                                       torch.as_tensor(toks[:, lo:hi]))
        assert got.shape == (2, hi - lo, model.vocab_padded)
        _close(got, want)
        assert cache["pos"] == int(rcache["pos"]) == hi
    for li in (0, 3):
        for key in ("k", "v", "ck"):
            _close(cache["layers"][li][key],
                   np.asarray(rcache["layers"][key])[li])


def test_decode_step_leaves_its_cache():
    _, _, model, params = _pair()
    cache = model.init_cache(1, 6, dtype=torch.float32, device="cpu")
    k0 = cache["layers"][1]["k"].clone()
    _, new = model.decode_step(params, cache,
                               torch.ones((1, 2), dtype=torch.int32))
    assert cache["pos"] == 0 and torch.equal(cache["layers"][1]["k"], k0)
    assert new["pos"] == 2 and new["layers"][1]["ck"] is \
        cache["layers"][1]["ck"]


def test_cached_decoder_stack_matches_reference():
    """The cached branch of ``_decoder_stack`` (an fp32 cache holding the
    memory's cross K/V) against the reference's."""
    rmodel, rparams, model, params = _pair()
    rb, b = _batch(model.cfg)
    rcache = rmodel.prefill_cache(
        rparams, rmodel.init_cache(2, 9, dtype=jnp.float32), rb["frames"])
    cache = model.prefill_cache(
        params, model.init_cache(2, 9, dtype=torch.float32, device="cpu"),
        b["frames"])
    x = np.random.default_rng(2).standard_normal(
        (2, 4, model.cfg.d_model)).astype(np.float32)
    want, rlayers = rmodel._decoder_stack(rparams, jnp.asarray(x), None,
                                          cache=rcache, pos=3)
    got, layers = model._decoder_stack(params, torch.as_tensor(x), None,
                                       cache=cache, pos=3)
    _close(got, want)
    _close(layers[2]["v"], np.asarray(rlayers["v"])[2])


def test_decode_matches_forward():
    """Token-by-token decode after prefill_cache against the port's own
    forward, at the reference's 2e-3."""
    _, _, model, params = _pair()
    _, b = _batch(model.cfg, S=10, seed=4)
    full, _ = model.forward(params, b)
    cache = model.prefill_cache(
        params, model.init_cache(2, 16, dtype=torch.float32, device="cpu"),
        b["frames"])
    outs = []
    for t in range(10):
        lg, cache = model.decode_step(params, cache, b["tokens"][:, t:t + 1])
        outs.append(lg)
    _close(torch.cat(outs, 1), full, 2e-3, 2e-3)


def test_example_batch_frames_match_reference():
    cfg = get_config(ARCH).reduced()
    ours, theirs = example_batch(cfg, "train", 2, 5, seed=7), \
        rexample_batch(rget_config(ARCH).reduced(), "train", 2, 5, seed=7)
    assert set(ours) == set(theirs) == {"tokens", "frames"}
    for k in ours:
        assert np.array_equal(ours[k], theirs[k])
