"""The port's dense model zoo and decode-attention kernel against the
reference package on the same inputs: configs, layers, reduced
starcoder2-3b and gemma3-4b (the sliding window and tied embeddings)
carrying the reference's own ``jax.random`` weights across
(``lm_params_from_reference``), and ``decode_attention``'s plain version
against the reference kernel in interpret mode. Tolerances: fp32 logits
rtol 1e-5 / atol 1e-5; the kernel rtol 1e-5 / atol 1e-6 in fp32 and one
bf16 ulp in bf16. The CUDA kernel itself runs in ``test_torch_gpu.py``
and ``chip_smoke.py``."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS, get_config as rget_config
from repro.kernels.attention import decode_attention as rdecode_attention
from repro.models import layers as rlayers
from repro.models.transformer import TransformerLM as RTransformerLM
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.attention import (DecodeAttentionLimitError,
                                           decode_attention,
                                           decode_attention_ref)
from repro_torch.models import TransformerLM, lm_params_from_reference
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("starcoder2-3b", "gemma3-4b")


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    """(reference model, reference params, port model, port params), fp32
    activations, the reference's PRNGKey(0) weights carried across."""
    arch = request.param
    rcfg = dataclasses.replace(rget_config(arch).reduced(),
                               activation_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              activation_dtype="float32")
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    return rmodel, rparams, model, params


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(RARCHS))
def test_configs_equal_the_reference(arch):
    assert set(ARCHS) == set(RARCHS)
    ours, theirs = get_config(arch), rget_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    assert ours.n_params() == theirs.n_params()
    assert ours.n_active_params() == theirs.n_active_params()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_norms_rope_mlps_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    s, b = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    t = torch.as_tensor
    _close(layers.rms_norm(t(x), t(s)), rlayers.rms_norm(x, s))
    _close(layers.layer_norm(t(x), t(s), t(b)), rlayers.layer_norm(x, s, b))
    pos = np.arange(10, 15)[None].repeat(2, 0)
    for theta in (10000.0, 100000.0, 1000000.0):
        _close(layers.apply_rope(t(x), t(pos), theta),
               rlayers.apply_rope(x, pos, theta))
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w1, w2, w3 = (rng.standard_normal(sh).astype(np.float32) * 0.1
                  for sh in ((32, 64), (32, 64), (64, 32)))
    b1, b2 = rng.standard_normal(64).astype(np.float32), s
    _close(layers.gelu_mlp(t(h), t(w1), t(b1), t(w3), t(b2)),
           rlayers.gelu_mlp(h, w1, b1, w3, b2))
    _close(layers.swiglu(t(h), t(w1), t(w2), t(w3)),
           rlayers.swiglu(h, w1, w2, w3))


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("sq,offset", [(7, 0), (1, 9)])
def test_attention_matches_reference(window, sq, offset):
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 10 if sq == 1 else sq, 2, 16)
                                ).astype(np.float32) for _ in range(2))
    t = torch.as_tensor
    want = rlayers.attention_xla(q, k, v, window=window, q_offset=offset)
    _close(layers.attention_xla(t(q), t(k), t(v), window=window,
                                q_offset=offset), want)
    _close(layers.attention_chunked(t(q), t(k), t(v), window=window,
                                    q_offset=offset, bk=4), want)


def test_flash_attention_level_names_its_row(monkeypatch):
    """attention(impl="cuda") is the reference's impl="pallas": it reaches
    row 12's kernel (``kernels.attention.flash_attention``, its plain
    version on CPU tensors) and equals the reference's Pallas kernel in
    interpret mode (rtol/atol 2e-4, the reference kernel test's)."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
            for _ in range(2))
    calls = []
    real = layers.flash_attention
    monkeypatch.setattr(layers, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    for window in (None, 5):
        want = rlayers.attention(q, k, v, window=window, impl="pallas")
        got = layers.attention(*map(torch.as_tensor, (q, k, v)),
                               window=window, impl="cuda")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
    assert [c["window"] for c in calls] == [None, 5]


def test_dense_init_draws_from_the_generator():
    model = TransformerLM(get_config("starcoder2-3b").reduced())
    p1 = model.init(torch.Generator().manual_seed(3))
    p2 = model.init(torch.Generator().manual_seed(3))
    assert torch.equal(p1["layers"][2]["attn"]["wq"],
                       p2["layers"][2]["attn"]["wq"])
    w = p1["layers"][0]["ffn"]["w_in"]
    assert w.shape == (128, 256) and w.dtype == torch.float32
    assert abs(float(w.std()) * np.sqrt(128) - 1.0) < 0.05


# ---------------------------------------------------------------------------
# the dense models, with the reference's weights
# ---------------------------------------------------------------------------
def test_forward_matches_reference(dense):
    rmodel, rparams, model, params = dense
    toks = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 9)).astype(np.int32)
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 9, model.vocab_padded) and float(aux) == 0.0
    _close(got, want)
    if model.vocab_padded != model.cfg.vocab:
        assert (got[..., model.cfg.vocab:] == -1e30).all()


def test_decode_step_matches_reference(dense):
    """Three decode calls (a 3-token chunk, then single tokens) against an
    fp32 cache: logits and the new caches."""
    rmodel, rparams, model, params = dense
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, 6)).astype(np.int32)
    rcache = rmodel.init_cache(2, 12, dtype=jnp.float32)
    cache = model.init_cache(2, 12, dtype=torch.float32)
    for lo, hi in ((0, 3), (3, 4), (4, 5)):
        want, rcache = rmodel.decode_step(rparams, rcache,
                                          jnp.asarray(toks[:, lo:hi]))
        got, cache = model.decode_step(params, cache,
                                       torch.as_tensor(toks[:, lo:hi]))
        _close(got, want)
    assert cache["pos"] == int(rcache["pos"]) == 5
    rk = np.asarray(rcache["body"][0]["k"])[0]
    _close(cache["layers"][0]["k"], rk)


def test_bf16_forward_close_to_reference():
    """The default (bf16 activation) config: the same function up to bf16
    rounding (products in bf16 on both sides, differently ordered)."""
    rcfg, cfg = rget_config("starcoder2-3b").reduced(), \
        get_config("starcoder2-3b").reduced()
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    toks = np.arange(1, 9, dtype=np.int32)[None]
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
    want = np.asarray(want, np.float32)[..., :cfg.vocab]
    got = got.float().numpy()[..., :cfg.vocab]
    assert np.abs(got - want).max() < 0.1 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75


# ---------------------------------------------------------------------------
# decode_attention (kernel row 11): its plain version
# ---------------------------------------------------------------------------
def _attn_case(B, C, H, Dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, C, H, Dh)).astype(np.float32)
            for _ in range(2))
    pos = rng.integers(0, C, B).astype(np.int32)
    pos[0] = 0                    # all but one position masked
    return q, k, v, pos


@pytest.mark.parametrize("window", [None, 1, 7])
@pytest.mark.parametrize("shape", [(3, 40, 5, 64), (2, 16, 2, 32),
                                   (4, 128, 3, 128)])
def test_decode_attention_plain_matches_reference_fp32(shape, window):
    q, k, v, pos = _attn_case(*shape, seed=sum(shape))
    want = rdecode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)),
                             window=window, interpret=True)
    t = torch.as_tensor
    got = decode_attention(t(q), t(k), t(v), t(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got, decode_attention_ref(t(q), t(k), t(v), t(pos),
                                                 window))


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_plain_matches_reference_bf16(window):
    q, k, v, pos = _attn_case(3, 48, 4, 64, seed=11)
    bf = jnp.bfloat16
    want = rdecode_attention(jnp.asarray(q, bf), jnp.asarray(k, bf),
                             jnp.asarray(v, bf), jnp.asarray(pos),
                             window=window, interpret=True)
    t = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    got = decode_attention(t(q), t(k), t(v), torch.as_tensor(pos),
                           window=window)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 ulp of the output (2^-7 relative at the bottom of a binade)
    assert np.all(np.abs(got.float().numpy() - want)
                  <= 2.0 ** -7 * np.abs(want) + 1e-6)


def test_decode_attention_masks_past_pos():
    """Garbage past pos (the null page, unwritten slots) never reaches the
    output; a mask that admits one more position does."""
    q, k, v, pos = _attn_case(2, 32, 2, 16, seed=5)
    pos[:] = 10
    t = torch.as_tensor
    base = decode_attention(t(q), t(k), t(v), t(pos))
    k2, v2 = k.copy(), v.copy()
    k2[:, 11:], v2[:, 11:] = 1e6, -1e6
    assert torch.equal(base, decode_attention(t(q), t(k2), t(v2), t(pos)))
    moved = decode_attention(t(q), t(k2), t(v2), t(pos + 1))
    assert not torch.allclose(moved, base)


def test_decode_attention_refuses_contexts_beyond_shared_memory():
    q = torch.zeros(1, 1, 128)
    k = torch.zeros(1, 60_000, 1, 128)
    with pytest.raises(DecodeAttentionLimitError):
        decode_attention(q, k, k, torch.zeros(1, dtype=torch.int32))
    k = torch.zeros(1, 8192, 1, 128)
    out = decode_attention(q, k, k, torch.zeros(1, dtype=torch.int32))
    assert out.shape == (1, 1, 128)


def test_model_and_serving_modules_import_no_jax():
    """The new packages import without JAX or the reference package."""
    code = ("import sys; import repro_torch.models, repro_torch.configs, "
            "repro_torch.models.encdec, "
            "repro_torch.serving, repro_torch.kernels.attention, "
            "repro_torch.kernels.rwkv, "
            "repro_torch.library.attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    import os
    env = {**os.environ, **env}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT)
