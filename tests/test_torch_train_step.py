"""The port's train step against the reference's on the same numpy
inputs, on the CPU: ``make_train_step`` (remat on, chunked attention) for
3 steps against the reference's unjitted step with AdamW and Adafactor,
for a reduced dense and RWKV model (the enc-dec model's in
``test_torch_train_step_encdec.py``; the files split so that the
test runner spreads them). Tolerances, each measured first: a step's loss
and grad norm rtol 1e-5, its parameters after 3 steps atol 1e-6 (updates
of at most the schedule's ~1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.launch.mesh import make_smoke_mesh
from repro.launch.steps import make_train_step as rmake_train_step
from repro.models import example_batch as rexample_batch
from repro_torch.configs import get_config
from repro_torch.launch import make_train_step
from repro_torch.models import encdec_params_from_reference, \
    lm_params_from_reference
from repro_torch.optim import tree_leaves


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


def track_reference(arch, opt_name):
    """Three steps of ``make_train_step`` against the reference's
    (unjitted) step from the same weights and batches: loss and grad norm
    each step, the parameters after the last."""
    rcfg, cfg = _configs(arch, attention_impl="chunked")
    rstep, _, _, rmodel, ropt = rmake_train_step(
        rcfg, make_smoke_mesh(), optimizer_name=opt_name)
    step, model, opt = make_train_step(cfg, optimizer_name=opt_name)
    assert model.remat and rmodel.remat
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = _carry(model, rparams)
    rstate = {"params": rparams, "opt": ropt.init(rparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        batch = _batch(cfg, seed=i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-5)
        assert int(state["step"]) == int(rstate["step"]) == i + 1
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(_carry(model, rstate["params"]))):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=0,
                                   atol=1e-6)



@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-7b"])
def test_train_step_tracks_reference(arch, opt_name):
    track_reference(arch, opt_name)


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="step 10"):
        make_train_step(get_config("granite-3-2b").reduced(), mesh=object())


