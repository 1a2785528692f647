"""The reference's ``tests/test_models_smoke.py`` for the port: one forward
and one loss with every parameter's gradient on each reduced config
(shapes, finite logits, loss and gradients), one decode step on each
(shapes, finite logits, ``pos``), and token-by-token decode against the
full-sequence forward at the reference's 2e-3 on its four archs plus the
enc-dec family with frames. Everything runs on the CPU and imports no
JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model, example_batch
from repro_torch.optim import tree_leaves

ALL_ARCHS = sorted(ARCHS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_train_step(arch):
    """As the reference's: the reduced config's own (bf16) activations, a
    (2, 32) batch; the forward's logits finite, then the loss and every
    parameter leaf's gradient finite."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in
             example_batch(cfg, "train", batch=2, seq=32).items()}
    if cfg.family == "vlm":
        batch["stub_embeds"] = batch["stub_embeds"][:, :cfg.n_stub_tokens]
    logits, aux = model.forward(params, batch)
    assert logits.shape[:2] == (2, 32)
    assert bool(torch.isfinite(logits).all())
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    assert np.isfinite(float(loss.detach()))
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_decode_step(arch):
    """As the reference's: two single-token steps from a zero cache (for
    the enc-dec family, zero cross caches and no prefill_cache)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 64, device="cpu") \
        if cfg.family == "encdec" else model.init_cache(2, 64)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    logits, cache = model.decode_step(params, cache, tok)
    assert logits.shape[0] == 2 and logits.shape[1] == 1
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    logits2, cache = model.decode_step(params, cache, tok)
    assert int(cache["pos"]) == 2


@pytest.mark.parametrize("arch", [
    "granite-3-2b", "rwkv6-7b", "jamba-1.5-large-398b", "gemma3-4b",
    "seamless-m4t-medium"])
def test_decode_matches_forward(arch):
    """Token-by-token decode with the cache == the full-sequence forward
    (the enc-dec family: its cross caches from prefill_cache over the
    same frames). As in the reference, jamba's MoE layers agree because
    the eval-mode forward drops no token."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              activation_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    T = 12
    batch = {k: torch.as_tensor(v) for k, v in
             example_batch(cfg, "train", 2, T, seed=0).items()}
    tokens = batch["tokens"]
    full, _ = model.forward(params, batch)
    if cfg.family == "encdec":
        cache = model.prefill_cache(
            params, model.init_cache(2, 32, dtype=torch.float32,
                                     device="cpu"), batch["frames"])
    else:
        cache = model.init_cache(2, 32, dtype=torch.float32)
    outs = []
    for t in range(T):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)
