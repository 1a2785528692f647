"""The port's training path against the reference's on the same numpy
inputs, on the CPU: ``TransformerLM.loss`` / ``EncDecLM.loss`` and every
parameter's gradient against ``jax.value_and_grad`` of the reference's
loss (weights carried across by ``lm_params_from_reference`` /
``encdec_params_from_reference``, fp32 activations) for a reduced dense,
MoE, RWKV, hybrid, VLM and enc-dec model, naive and chunked attention;
and ``remat`` on and off. The train step against the reference's is in
``test_torch_train_step*.py``, checkpoints and the ``Trainer`` in
``test_torch_train_checkpoint.py``, the plain backward versions in
``test_torch_train_bwd.py``.

Tolerances, each measured first: a loss rtol 1e-5; a gradient leaf
max |g - g_ref| <= 1e-4 max |g_ref| (the worst measured 2.3e-5, a reduced
llama4-scout's MoE leaves, whose one-hot dispatch sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import build_model as rbuild_model
from repro.models import example_batch as rexample_batch
from repro_torch.configs import get_config
from repro_torch.models import (build_model, encdec_params_from_reference,
                                lm_params_from_reference)
from repro_torch.optim import tree_leaves

FAMILIES = ["granite-3-2b", "llama4-scout-17b-a16e", "rwkv6-7b",
            "jamba-1.5-large-398b", "phi-3-vision-4.2b",
            "seamless-m4t-medium"]


def _configs(arch, **changes):
    return tuple(dataclasses.replace(g(arch).reduced(),
                                     activation_dtype="float32", **changes)
                 for g in (rget_config, get_config))


def _carry(model, tree):
    conv = encdec_params_from_reference if model.cfg.family == "encdec" \
        else lm_params_from_reference
    return conv(model, jax.tree.map(np.asarray, tree))


def _batch(cfg, seed=0, B=2, S=32):
    b = rexample_batch(cfg, "train", B, S, seed=seed)
    if cfg.family == "vlm":
        b["stub_embeds"] = b["stub_embeds"][:, :cfg.n_stub_tokens]
    return b


def _grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _leaf_close(got, want, tol=1e-4):
    for a, b in zip(got, want):
        a = a.detach().double()
        b = torch.as_tensor(np.asarray(b)).double()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale + 1e-12, \
            (float((a - b).abs().max()), scale)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch, impl):
    rcfg, cfg = _configs(arch, attention_impl=impl)
    rmodel, model = rbuild_model(rcfg), build_model(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = _carry(model, rparams)
    batch = _batch(cfg)
    rloss, rgrads = jax.value_and_grad(rmodel.loss)(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(model, params, batch)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    want = tree_leaves(_carry(model, rgrads))
    assert len(want) == len(grads)
    _leaf_close(grads, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_loss_and_gradients(arch):
    """Activation checkpointing recomputes each block in the backward pass:
    the same loss and gradients, bit for bit on the CPU."""
    _, cfg = _configs(arch, attention_impl="chunked")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, seed=1)
    loss, grads = _grads(model, params, batch)
    model.remat = True
    loss2, grads2 = _grads(model, params, batch)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_remat_recomputes_each_block_once():
    """Under remat each layer's forward runs again in the backward pass
    (one more ``wkv_chunked`` call a layer), and not with a cache."""
    from repro_torch.models import blocks
    _, cfg = _configs("rwkv6-7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    calls = []
    real = blocks._wkv_chunked

    def counted(*a):
        calls.append(1)
        return real(*a)

    blocks._wkv_chunked = counted
    try:
        _grads(model, params, _batch(cfg))
        plain = len(calls)
        model.remat = True
        _grads(model, params, _batch(cfg))
    finally:
        blocks._wkv_chunked = real
    assert plain == cfg.n_layers and len(calls) - plain == 2 * cfg.n_layers


