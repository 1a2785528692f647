"""The train step builder, the counterpart of the reference's
``repro/launch/steps.py::make_train_step``, for one device.

``train_step``: loss -> gradients -> global-norm clip -> optimizer update.
The reference jits the step with explicit shardings and donated state;
here the step runs eagerly on the device its state lies on, and the
optimizer updates the state's tensors in place (its donation). Meshes,
``make_serve_step`` and ``lower_cell`` come with the scale-out runtime
(ROADMAP step 10).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models.registry import build_model
from ..optim import (clip_by_global_norm, get_optimizer, tree_leaves,
                     tree_unflatten)


def _no_mesh(mesh, what: str):
    if mesh is not None:
        raise NotImplementedError(
            f"{what} on a mesh comes with the scale-out runtime (ROADMAP "
            f"step 10); the port trains on one device (mesh=None)")


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    optimizer_name: str = None, clip_norm: float = 1.0,
                    remat: bool = True):
    """Returns (step_fn, model, opt).

    ``step_fn(state, batch) -> (state, {"loss", "grad_norm"})`` with state
    ``{"params", "opt", "step"}`` (``step`` a 0-d int32 CPU tensor): the
    model's loss, its gradients with respect to every parameter leaf
    (``torch.autograd.grad``), ``clip_by_global_norm`` and the optimizer's
    update, which writes the new parameters and optimizer state into the
    state's tensors; the step counter goes up by one. The metrics are 0-d
    tensors on the device, read by nobody inside the step."""
    _no_mesh(mesh, "make_train_step")
    model = build_model(cfg)
    model.remat = remat
    opt = get_optimizer(optimizer_name or cfg.optimizer,
                        stacks=model.stacked_leaves)

    def step(state: Dict, batch: Dict):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(params, batch)
        grads = tree_unflatten(params, list(
            torch.autograd.grad(loss, leaves)))
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, new_opt = opt.update(grads, state["opt"], params,
                                         state["step"])
        del grads
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step, model, opt
