"""The port's prefill flash attention against the reference package on the
same seeded numpy inputs: ``kernels.attention.flash_attention`` (on the CPU
its plain version, the online-softmax loop of ``ref.py``),
``layers.attention(impl="cuda")`` and ``layers.attention_chunked`` against
the reference's Pallas ``flash_attention`` in interpret mode at the cases
and tolerances of ``test_attention_rwkv_kernels.py`` (rtol/atol 2e-4 in
fp32, 3e-2 in bf16) and at shapes its divisor search never sees; a row that
admits no key (the mean of V on both sides); ``q_offset``, which the port
keeps and the reference's ``attention(impl="pallas")`` drops; the typed
limit; and a reduced gemma3-4b forward with ``attention_impl="chunked"``
against the reference's own chunked forward. On the CPU nothing launches;
the CUDA kernel runs in ``test_torch_gpu.py`` and ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.kernels.attention import flash_attention as rflash
from repro.models import layers as rlayers
from repro.models.transformer import TransformerLM as RTransformerLM
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.attention import (FlashAttentionLimitError,
                                           flash_attention,
                                           flash_attention_ref)
from repro_torch.models import TransformerLM, lm_params_from_reference
from repro_torch.models import layers

F32_TOL = 2e-4
BF16_TOL = 3e-2


def _qkv(b, sq, sk, hq, hkv, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, dh)).astype(dtype)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(dtype)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(dtype)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == ml_dtypes.bfloat16 else torch.float32)
        for a in arrays]


def _port_routes(q, k, v, **kw):
    """The port's three routes to the kernel (its plain version here)."""
    before = flash_attention.launches
    outs = {"flash_attention": flash_attention(q, k, v, **kw),
            "attention_cuda": layers.attention(q, k, v, impl="cuda", **kw),
            "attention_chunked": layers.attention_chunked(q, k, v, **kw)}
    assert flash_attention.launches == before     # CPU: plain, no launch
    return outs


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the reference kernel's own cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    dict(b=1, s=256, hq=4, hkv=4, dh=64),            # MHA
    dict(b=2, s=128, hq=8, hkv=2, dh=32),            # GQA 4:1
    dict(b=1, s=512, hq=2, hkv=1, dh=64),            # MQA
], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_kernel(cfg, causal):
    q, k, v = _qkv(cfg["b"], cfg["s"], cfg["s"], cfg["hq"], cfg["hkv"],
                   cfg["dh"], seed=cfg["s"] + cfg["hq"])
    want = rflash(q, k, v, causal=causal, bq=64, bk=64, interpret=True)
    for out in _port_routes(*_torch(q, k, v), causal=causal).values():
        assert out.dtype == torch.float32 and out.shape == q.shape
        _close(out, want, F32_TOL)


def test_matches_reference_kernel_sliding_window():
    q, k, v = _qkv(1, 256, 256, 4, 4, 32, seed=3)
    want = rflash(q, k, v, causal=True, window=64, bq=64, bk=64,
                  interpret=True)
    for out in _port_routes(*_torch(q, k, v), causal=True,
                            window=64).values():
        _close(out, want, F32_TOL)


def test_matches_reference_kernel_bf16():
    q, k, v = _qkv(1, 128, 128, 4, 4, 64, seed=4, dtype=ml_dtypes.bfloat16)
    want = rflash(q, k, v, causal=True, bq=64, bk=64, interpret=True)
    for out in _port_routes(*_torch(q, k, v), causal=True).values():
        assert out.dtype == torch.bfloat16
        _close(out, want, BF16_TOL)


# ---------------------------------------------------------------------------
# shapes the reference's divisor search never sees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk,dh,causal,window", [
    (97, 97, 64, True, None),         # no useful divisor
    (97, 97, 96, True, 32),           # phi-3-vision's head
    (40, 97, 112, False, 32),         # kimi-k2's head, Sq != Sk
    (97, 40, 256, True, 32),          # gemma3's head, Sq > Sk
    (64, 160, 128, True, None),       # Sq < Sk
], ids=["ragged", "dh96", "dh112-sq<sk", "dh256-sq>sk", "dh128-sq<sk"])
def test_matches_reference_kernel_at_odd_shapes(sq, sk, dh, causal, window):
    """GQA 2:1; the reference kernel shrinks bq and bk to divisors (97 is
    prime), the port masks its ragged tiles."""
    q, k, v = _qkv(2, sq, sk, 4, 2, dh, seed=sq * sk + dh)
    want = rflash(q, k, v, causal=causal, window=window, interpret=True)
    xla = rlayers.attention_xla(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(np.asarray(want), np.asarray(xla),
                               rtol=F32_TOL, atol=F32_TOL)
    for out in _port_routes(*_torch(q, k, v), causal=causal,
                            window=window).values():
        _close(out, want, F32_TOL)


def test_a_row_that_admits_no_key_gets_the_mean_of_v():
    """Non-causal with a window and Sq > Sk: rows q_pos >= Sk - 1 + window
    admit no key. Every score is -1e30, so the reference kernel and
    attention_xla give those rows the mean of V; so does the port."""
    q, k, v = _qkv(1, 96, 32, 4, 2, 64, seed=7)
    kw = dict(causal=False, window=16)
    want = np.asarray(rflash(q, k, v, interpret=True, **kw))
    xla = np.asarray(rlayers.attention_xla(q, k, v, **kw))
    mean = np.repeat(v.mean(axis=1), 2, axis=1)           # (1, Hq, Dh)
    empty = np.arange(96) >= 32 - 1 + 16
    assert empty.any() and not empty.all()
    for ref_out in (want, xla):
        np.testing.assert_allclose(
            ref_out[:, empty], np.broadcast_to(mean[:, None],
                                               ref_out[:, empty].shape),
            rtol=1e-5, atol=1e-5)
    for out in _port_routes(*_torch(q, k, v), **kw).values():
        _close(out, want, F32_TOL)
        _close(out, xla, F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, 24)])
def test_q_offset_is_kept(causal, window):
    """A 16-row chunk at positions 40..55 against 56 keys, as a chunked
    prefill would call it, against the reference's attention_xla with the
    same q_offset; the reference's impl="pallas" drops q_offset and
    computes the chunk as if it sat at positions 0..15 (a reference-side
    fault), which the port's impl="cuda" does not."""
    q, k, v = _qkv(2, 16, 56, 4, 2, 32, seed=11)
    kw = dict(causal=causal, window=window)
    want = np.asarray(rlayers.attention_xla(q, k, v, q_offset=40, **kw))
    for out in _port_routes(*_torch(q, k, v), q_offset=40, **kw).values():
        _close(out, want, F32_TOL)
    dropped = np.asarray(rlayers.attention(q, k, v, q_offset=40,
                                           impl="pallas", **kw))
    at_zero = np.asarray(rlayers.attention_xla(q, k, v, **kw))
    np.testing.assert_allclose(dropped, at_zero, rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(dropped - want).max() > 0.1


def test_heads_the_kernel_cannot_tile_are_refused_on_every_device():
    """Wider than 256 (the output tile's registers) or not a multiple of 4
    (rows load as 4-element groups): FlashAttentionLimitError on the CPU
    as on the card; Hq not a multiple of Hkv: ValueError."""
    q = torch.zeros(1, 4, 2, 288)
    with pytest.raises(FlashAttentionLimitError, match="288"):
        flash_attention(q, q, q)
    with pytest.raises(FlashAttentionLimitError):
        layers.attention(q, q, q, impl="cuda")
    q = torch.zeros(1, 4, 2, 62)
    with pytest.raises(FlashAttentionLimitError, match="multiples of 4"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 256)
    assert flash_attention(q, q, q).shape == (1, 4, 2, 256)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8),
                        torch.zeros(1, 4, 2, 8))


def test_plain_version_takes_any_chunk():
    """attention_chunked's bk is a CPU-side argument: any chunk gives the
    same function."""
    q, k, v = _torch(*_qkv(1, 50, 50, 2, 1, 16, seed=2))
    want = flash_attention_ref(q, k, v, window=9)
    for bk in (1, 7, 50, 4096):
        got = layers.attention_chunked(q, k, v, window=9, bk=bk)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_source_is_a_hand_written_hopper_kernel():
    """The CUDA source names the TPU kernel it replaces and its bound,
    builds with the others, and calls no library kernel and no atomic."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert "repro/kernels/attention/kernel.py::" in src
    assert "67 TFLOP/s" in src
    assert "flash_attention" in build.KERNELS
    for call in ("cublas", "cudnn", "scaled_dot_product", "atomicAdd",
                 "torch"):
        assert call not in src.lower()


# ---------------------------------------------------------------------------
# the path: a reduced gemma3-4b forward with attention_impl="chunked"
# ---------------------------------------------------------------------------
def test_gemma3_chunked_forward_matches_reference(monkeypatch):
    """Reduced gemma3-4b (6 layers, 5:1 local:global, window 16) with the
    reference's PRNGKey(0) weights carried across, fp32 activations, 40
    tokens (past the window), attention_impl="chunked" on both sides, at
    test_torch_models.py's forward tolerance (rtol/atol 1e-5)."""
    rcfg = dataclasses.replace(rget_config("gemma3-4b").reduced(),
                               activation_dtype="float32",
                               attention_impl="chunked")
    cfg = dataclasses.replace(get_config("gemma3-4b").reduced(),
                              activation_dtype="float32",
                              attention_impl="chunked")
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    toks = np.random.default_rng(5).integers(0, cfg.vocab,
                                             (2, 40)).astype(np.int32)
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    from repro_torch.models import blocks
    calls, real = [], blocks.attention_chunked

    def counted(*args, **kw):
        calls.append(kw.get("window"))
        return real(*args, **kw)

    monkeypatch.setattr(blocks, "attention_chunked", counted)
    got, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
    assert calls == [16] * 5 + [None]             # 5 local, 1 global
    assert got.shape == (2, 40, model.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain, _ = TransformerLM(dataclasses.replace(
        cfg, attention_impl="naive")).forward(
        params, {"tokens": torch.as_tensor(toks)})
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
