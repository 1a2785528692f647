"""Optimizers: AdamW and Adafactor (low-memory, for the XXL MoE archs),
with a warmup-cosine schedule and global-norm clipping — the counterparts
of the reference's ``repro/optim/optimizers.py``, as plain functions on
tensors over the port's parameter trees (dicts and lists).

Updates work in place: ``Optimizer.update`` and ``clip_by_global_norm``
write into the tensors they are given under ``torch.no_grad()`` and return
the same objects, so a step holds no second copy of the parameters, their
gradients or the optimizer state (a 3B-parameter model's worth each). The
arithmetic is the reference's, in float32, with the parameters cast back
to their own dtype.

The schedule and the bias corrections are computed from the step in
float32, as the reference computes them from its int32 step, on the host
(the trainer keeps the step a CPU tensor), and enter the update as
scalars: nothing waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import torch


# ---------------------------------------------------------------------------
# Parameter trees: dicts (keys in sorted order, as jax.tree orders them),
# lists and tuples, tensors at the leaves
# ---------------------------------------------------------------------------
def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of the
    same structure), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: List):
    """A tree of ``like``'s structure whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable:
    """step -> learning rate (a 0-d float32 tensor): linear warmup to
    ``base_lr``, then a cosine down to ``final_frac`` of it at ``total``."""
    def schedule(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(_f32(math.pi) * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return schedule


def global_norm(tree) -> torch.Tensor:
    """The 2-norm of every leaf together, each leaf summed in float32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scales every leaf by min(1, max_norm / (norm + 1e-9)) in place (the
    product in float32, cast back to the leaf's dtype) -> (tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree_leaves(tree):
        g.copy_((g * scale).to(g.dtype))
    return tree, norm


@dataclasses.dataclass
class Optimizer:
    init: Callable            # params -> opt_state
    update: Callable          # (grads, opt_state, params, step) ->
    #                           (params, opt_state), both updated in place
    name: str = "opt"


def _scalar(x) -> float:
    """A float32 schedule value as a Python number (exact)."""
    return float(_f32(x))


def adamw(schedule: Callable, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "v": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update(grads, opt, params, step):
        lr = _scalar(schedule(step))
        t = _f32(step) + 1
        bc1 = _scalar(1 - torch.pow(_f32(b1), t))
        bc2 = _scalar(1 - torch.pow(_f32(b2), t))
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt["m"]),
                              tree_leaves(opt["v"]), tree_leaves(params)):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            del g
            p32 = p.float()
            step_ = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                + weight_decay * p32
            p.copy_((p32 - lr * step_).to(p.dtype))
        return params, opt

    return Optimizer(init, update, "adamw")


def adafactor(schedule: Callable, eps=1e-30, decay=0.8,
              clip_threshold=1.0, weight_decay=0.0,
              stacks: Callable = None) -> Optimizer:
    """Factored second moments: O(n+m) state for an (n, m) matrix — the
    memory trick that lets the 1T-param configs train on 512 chips.

    The reference stores a layer's leaf stacked over the periods of the
    model's schedule, one array for all of them, and Adafactor sees that
    array: a per-layer vector becomes a (periods, d) matrix with factored
    moments, and the update's RMS is clipped over all the periods
    together. The port's layers are separate leaves, so ``stacks(params)``
    (a model's ``stacked_leaves``) names the groups of leaves the reference
    stacks, as (stacked, [indices into tree_leaves(params)]); a group is
    updated as that one stacked array. Without ``stacks`` every leaf is
    its own, unstacked array."""

    def groups(params):
        n = len(tree_leaves(params))
        return stacks(params) if stacks is not None else \
            [(False, [i]) for i in range(n)]

    def init(params):
        leaves = tree_leaves(params)
        state = [None] * len(leaves)
        for stacked, idx in groups(params):
            for i in idx:
                p = leaves[i]
                z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                              device=p.device)
                if p.dim() >= 2:
                    state[i] = {"vr": z(p.shape[:-1]),
                                "vc": z(p.shape[:-2] + p.shape[-1:])}
                elif stacked and p.dim() == 1:
                    # a row of the (periods, d) matrix: its own vr, the
                    # matrix's vc (kept with every row)
                    state[i] = {"vr": z(()), "vc": z(p.shape)}
                else:
                    state[i] = {"v": z(p.shape)}
        return tree_unflatten(params, state)

    def direction(g, o):
        """The unclipped update of one leaf from its refreshed state."""
        if "v" in o:
            return g / (torch.sqrt(o["v"]) + eps)
        return g / (torch.sqrt(o["vr"][..., None] * o["vc"][..., None, :]
                               / (o["mean_vr"] + eps)) + eps)

    @torch.no_grad()
    def update(grads, opt, params, step):
        lr = _scalar(schedule(step))
        t = _f32(step) + 1
        be = _scalar(1.0 - torch.pow(t, -decay))
        gl, pl = tree_leaves(grads), tree_leaves(params)
        ol = _state_leaves(opt, params)
        for stacked, idx in groups(params):
            rows = stacked and pl[idx[0]].dim() == 1
            if rows:
                # the group is one (periods, d) matrix: vr a row each, vc
                # the mean over the rows
                g2s = [torch.square(gl[i].float()) + eps for i in idx]
                vc = ol[idx[0]]["vc"]
                vc = be * vc + (1 - be) * (sum(g2s) / len(idx))
                for i, g2 in zip(idx, g2s):
                    ol[i]["vr"].copy_(be * ol[i]["vr"] + (1 - be) * g2.mean())
                    ol[i]["vc"].copy_(vc)
                mean_vr = sum(ol[i]["vr"] for i in idx) / len(idx)
                del g2s
            views = []
            for i in idx:
                o = ol[i]
                if rows:
                    views.append({"vr": o["vr"][None], "vc": o["vc"],
                                  "mean_vr": mean_vr})
                    continue
                g2 = torch.square(gl[i].float()) + eps
                if "v" in o:
                    o["v"].copy_(be * o["v"] + (1 - be) * g2)
                    views.append(o)
                    continue
                o["vr"].copy_(be * o["vr"] + (1 - be) * g2.mean(-1))
                o["vc"].copy_(be * o["vc"] + (1 - be) * g2.mean(-2))
                views.append(dict(o, mean_vr=o["vr"].mean(
                    -1, keepdim=True)[..., None]))
                del g2
            # update clipping (RMS <= clip_threshold) over the whole
            # (stacked) array: the sum of squares first, then the updates
            sq = sum(torch.sum(torch.square(direction(gl[i].float(), o)))
                     for i, o in zip(idx, views))
            count = sum(pl[i].numel() for i in idx)
            clip = torch.clamp(torch.sqrt(sq / count + eps) / clip_threshold,
                               min=1.0)
            for i, o in zip(idx, views):
                p = pl[i]
                u = direction(gl[i].float(), o) / clip
                if rows:
                    u = u[0]
                if weight_decay:
                    u = u + weight_decay * p.float()
                p.copy_((p.float() - lr * u).to(p.dtype))
        return params, opt

    return Optimizer(init, update, "adafactor")


def _state_leaves(opt, params) -> List:
    """Adafactor's per-parameter state dicts, in ``tree_leaves(params)``
    order (the state tree is the parameter tree with a dict at each
    leaf)."""
    out = []

    def walk(o, p):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(o[k], p[k])
        elif isinstance(p, (list, tuple)):
            for oi, pi in zip(o, p):
                walk(oi, pi)
        else:
            out.append(o)
    walk(opt, params)
    return out


def get_optimizer(name: str, lr: float = 3e-4, warmup: int = 100,
                  total: int = 10000, stacks: Callable = None) -> Optimizer:
    """``stacks``: the model's ``stacked_leaves``, which Adafactor reads
    (AdamW's update is elementwise and needs no grouping)."""
    sched = warmup_cosine(lr, warmup, total)
    if name == "adamw":
        return adamw(sched)
    if name == "adafactor":
        return adafactor(sched, stacks=stacks)
    raise ValueError(name)
