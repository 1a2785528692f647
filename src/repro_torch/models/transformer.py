"""Decoder-only LM for the dense family (GQA, RoPE, local:global sliding
windows, tied embeddings), the MoE family (top-k routed experts with an
optional shared expert), the RWKV6 family (attention-free, a recurrent
WKV state), the hybrid family (Mamba blocks interleaved with attention)
and the VLM family (stub patch embeddings projected and put in front of
the text), the counterpart of the reference's
``repro/models/transformer.py``.

The reference stacks each period position's parameters over periods and
scans; PyTorch runs eagerly, so here the layers are a plain list in
execution order (``params["layers"][li]``, one ``{"attn", "ffn"}``,
``{"mamba", "ffn"}`` or ``{"rwkv"}`` dict a layer) and
``forward``/``decode_step`` loop over them.
The layer schedule (which layers are sliding-window) is the reference's
``build_schedule``. ``loss`` is the reference's logsumexp cross-entropy
plus 0.01 aux; ``remat`` wraps each block in
``torch.utils.checkpoint.checkpoint`` (the reference's ``jax.checkpoint``)
when no cache is given.
:func:`lm_params_from_reference` turns the reference's stacked tree,
carried across as numpy arrays, into this layout, so both packages
compute the same function in the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from . import blocks
from .layers import NEG_INF, dense_init, layer_norm, rms_norm


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str                    # attn | mamba | rwkv
    is_moe: bool = False
    window: Optional[int] = None


def build_schedule(cfg: ModelConfig) -> Tuple[List[BlockSpec], int,
                                              List[BlockSpec]]:
    """Returns (period_specs, n_periods, tail_specs), as the reference."""
    def pos_spec(i: int) -> BlockSpec:
        if cfg.family == "ssm":
            return BlockSpec("rwkv")
        kind = "attn"
        if cfg.hybrid_period:
            kind = "attn" if i % cfg.hybrid_period == cfg.hybrid_attn_index \
                else "mamba"
        is_moe = bool(cfg.moe) and (i % cfg.moe.moe_every
                                    == cfg.moe.moe_every - 1)
        window = None
        if cfg.local_global_ratio and kind == "attn":
            l, g = cfg.local_global_ratio
            if (i % (l + g)) < l:
                window = cfg.window
        elif cfg.window and kind == "attn":
            window = cfg.window
        return BlockSpec(kind, is_moe, window)

    period = 1
    if cfg.hybrid_period:
        period = np.lcm(period, cfg.hybrid_period)
    if cfg.moe:
        period = np.lcm(period, cfg.moe.moe_every)
    if cfg.local_global_ratio:
        period = np.lcm(period, sum(cfg.local_global_ratio))
    period = int(period)
    n_periods = cfg.n_layers // period
    remainder = cfg.n_layers - n_periods * period
    period_specs = [pos_spec(i) for i in range(period)]
    tail_specs = [pos_spec(n_periods * period + i) for i in range(remainder)]
    return period_specs, n_periods, tail_specs


class TransformerLM:
    """The dense, MoE, RWKV6, hybrid and VLM families: embed (after the
    projected stub embeddings, for a VLM), attention or Mamba blocks each
    with an FFN (dense or MoE), or RWKV blocks, final norm, head."""

    def __init__(self, cfg: ModelConfig, remat: bool = False):
        self.cfg = cfg
        #: per-layer activation checkpointing: only the layer-boundary
        #: activations are kept; attention and FFN internals recompute in
        #: the backward pass (the reference's ``jax.checkpoint``)
        self.remat = remat
        #: Megatron-style vocab padding to a multiple of 256, as the
        #: reference; the padded logits are masked to -1e30
        self.vocab_padded = -(-cfg.vocab // 256) * 256
        self.period_specs, self.n_periods, self.tail_specs = \
            build_schedule(cfg)
        self.layer_specs: List[BlockSpec] = \
            list(self.period_specs) * self.n_periods + list(self.tail_specs)
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the enc-dec family is EncDecLM "
                             f"(models.encdec), not TransformerLM")

    def __repr__(self):
        # stable across instances: compiled serving steps key on it
        return f"TransformerLM({self.cfg!r})"

    @property
    def adt(self) -> torch.dtype:
        return getattr(torch, self.cfg.activation_dtype)

    # -- parameters ------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> Dict:
        """Random parameters drawn from ``generator`` (on its device unless
        ``device`` is given)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.param_dtype)
        dev = generator.device if device is None else torch.device(device)
        g = generator
        params: Dict = {"embed": dense_init(
            g, (self.vocab_padded, cfg.d_model), scale=1.0, dtype=dt,
            device=dev)}
        params["layers"] = [self._block_init(spec, g, dev)
                             for spec in self.layer_specs]
        params["final_scale"] = torch.zeros((cfg.d_model,),
                                            dtype=torch.float32, device=dev)
        if cfg.norm == "layernorm":
            params["final_bias"] = torch.zeros((cfg.d_model,),
                                               dtype=torch.float32, device=dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(g, (cfg.d_model, self.vocab_padded),
                                           dtype=dt, device=dev)
        if cfg.n_stub_tokens:
            params["stub_proj"] = dense_init(g, (cfg.d_model, cfg.d_model),
                                             dtype=dt, device=dev)
        return params

    def _block_init(self, spec: BlockSpec, g: torch.Generator, dev) -> Dict:
        cfg = self.cfg
        if spec.kind == "rwkv":
            return {"rwkv": blocks.rwkv_init(cfg, g, dev)}
        mixer = blocks.mamba_init if spec.kind == "mamba" \
            else blocks.attn_init
        return {spec.kind: mixer(cfg, g, dev),
                "ffn": blocks.ffn_init(cfg, g, spec.is_moe, dev)}

    # -- forward ----------------------------------------------------------
    def _final_norm(self, params, x):
        if self.cfg.norm == "rmsnorm":
            return rms_norm(x, params["final_scale"])
        return layer_norm(x, params["final_scale"] + 1.0,
                          params["final_bias"])

    def _logits(self, params, x):
        adt = self.adt
        head = params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]
        logits = torch.matmul(x.to(adt), head.to(adt))
        if self.cfg.tie_embeddings:  # gemma-style tied-head scaling
            logits = logits * torch.tensor(
                np.float32(1.0 / np.sqrt(self.cfg.d_model)),
                device=logits.device).to(logits.dtype)
        if self.vocab_padded != self.cfg.vocab:
            # in place: a second (B, S, V) buffer is GBs at a long prefill
            logits[..., self.cfg.vocab:] = NEG_INF
        return logits

    def embed_tokens(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return params["embed"][tokens.long()].to(self.adt)

    def _block(self, spec: BlockSpec, p: Dict, x, cache=None, pos=None,
               training: bool = False):
        """(x, aux, new cache). ``training`` lets MoE blocks drop tokens
        past capacity; the eval-mode forward and decode drop none, so they
        agree token for token. With ``remat`` and no cache the block runs
        under activation checkpointing."""
        if self.remat and cache is None:
            x, aux = remat_call(
                lambda x_: self._apply_block(spec, p, x_, None, None,
                                             training)[:2], x)
            return x, aux, {}
        return self._apply_block(spec, p, x, cache, pos, training)

    def _apply_block(self, spec: BlockSpec, p: Dict, x, cache, pos,
                     training: bool):
        if spec.kind == "rwkv":
            x, nc = blocks.rwkv_apply(self.cfg, p["rwkv"], x, cache=cache)
            return x, torch.zeros((), dtype=torch.float32,
                                  device=x.device), nc or {}
        if spec.kind == "mamba":
            x, nc = blocks.mamba_apply(self.cfg, p["mamba"], x, cache=cache)
            x, aux = blocks.ffn_apply(self.cfg, p["ffn"], x, spec.is_moe,
                                      training=training)
            return x, aux, nc or {}
        c = None
        if cache is not None:
            c = {"k": cache["k"], "v": cache["v"], "pos": pos}
        x, nc = blocks.attn_apply(self.cfg, p["attn"], x, window=spec.window,
                                  cache=c)
        x, aux = blocks.ffn_apply(self.cfg, p["ffn"], x, spec.is_moe,
                                  training=training)
        new_cache = {"k": nc["k"], "v": nc["v"]} if nc is not None else {}
        return x, aux, new_cache

    def forward(self, params, batch: Dict, training: bool = False):
        """batch: {'tokens': (B, S) int, for a VLM optionally
        'stub_embeds': (B, n_stub, D)} -> (logits (B, S, V) of the text
        positions, aux loss, the MoE layers' load-balancing losses
        summed). ``training`` turns on MoE capacity dropping, as the
        reference's."""
        cfg = self.cfg
        x = self.embed_tokens(params, batch["tokens"])
        stub = bool(cfg.n_stub_tokens) and "stub_embeds" in batch
        if stub:
            s = torch.as_tensor(batch["stub_embeds"],
                                device=x.device).to(x.dtype)
            s = torch.matmul(s, params["stub_proj"].to(x.dtype))
            x = torch.cat([s, x], dim=1)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, p in zip(self.layer_specs, params["layers"]):
            x, a, _ = self._block(spec, p, x, training=training)
            aux = aux + a
        x = self._final_norm(params, x)
        logits = self._logits(params, x)
        if stub:
            logits = logits[:, cfg.n_stub_tokens:]
        return logits, aux

    def stacked_leaves(self, params):
        """The groups of parameter leaves that the reference stores as one
        array, as (stacked, [indices into tree_leaves(params)]): a period
        position's leaf stacked over the periods; the tail layers' and the
        other leaves each alone (Adafactor reads this)."""
        period = len(self.period_specs)
        return stack_groups(params, {"layers": [
            [pp * period + pi for pp in range(self.n_periods)]
            for pi in range(period)]})

    def loss(self, params, batch: Dict):
        """Mean next-token cross-entropy (logsumexp form, in float32) plus
        0.01 times the aux loss, from the training-mode forward."""
        logits, aux = self.forward(params, batch, training=True)
        return next_token_loss(logits, batch["tokens"]) + 0.01 * aux

    # -- decode -----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> Dict:
        """A zero decode cache: per attention layer K/V of ``max_seq``
        positions in ``dtype``; per RWKV or Mamba layer its state, in
        float32 whatever ``dtype`` (as the reference's cache)."""
        def layer(spec):
            if spec.kind == "rwkv":
                return blocks.rwkv_cache_init(self.cfg, batch, device=device)
            if spec.kind == "mamba":
                return blocks.mamba_cache_init(self.cfg, batch, device=device)
            return {k: v for k, v in blocks.attn_cache_init(
                self.cfg, batch, max_seq, dtype, device).items()
                if k != "pos"}
        return {"pos": 0, "layers": [layer(s) for s in self.layer_specs]}

    def decode_step(self, params, cache: Dict, tokens):
        """tokens: (B, S) -> (logits (B, S, V), new cache); the cache is
        not modified."""
        x = self.embed_tokens(params, tokens)
        pos = int(cache["pos"])
        new_layers = []
        for spec, p, c in zip(self.layer_specs, params["layers"],
                              cache["layers"]):
            x, _, nc = self._block(spec, p, x, cache=c, pos=pos)
            new_layers.append(nc)
        x = self._final_norm(params, x)
        return self._logits(params, x), {"pos": pos + x.shape[1],
                                         "layers": new_layers}


def stack_groups(params, stacks: Dict[str, List[List[int]]]):
    """(stacked, leaf indices) groups over ``tree_leaves(params)``: for
    each list of layer indices in ``stacks[key]`` and each leaf of those
    layers of ``params[key]``, the leaf across them; every other leaf
    alone."""
    from ..optim import tree_leaves, tree_unflatten
    ids = tree_unflatten(params, list(range(len(tree_leaves(params)))))
    taken, out = set(), []
    for key, groups in stacks.items():
        for layers in groups:
            if not layers:
                continue
            for path in _paths(ids[key][layers[0]]):
                group = [_at(ids[key][li], path) for li in layers]
                out.append((True, group))
                taken.update(group)
    out += [(False, [i]) for i in tree_leaves(ids) if i not in taken]
    return out


def _paths(tree, prefix=()):
    """The key paths of a layer's nested dict, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                       prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def remat_call(fn, *args):
    """``fn(*args)`` under activation checkpointing: the backward pass
    recomputes ``fn``'s internals from its inputs (``use_reentrant=False``,
    so tensors ``fn`` reads from its closure get their gradients too).
    The blocks draw no random numbers, so no RNG state is kept."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def next_token_loss(logits, tokens):
    """mean over (B, S - 1) of logsumexp(logits_t) - logits_t[tokens_t+1],
    in float32: the reference's logsumexp-form cross-entropy, which keeps
    no second (B, S, V) log-probability buffer."""
    tokens = torch.as_tensor(tokens, device=logits.device)
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    return torch.mean(lse - tgt)


def lm_params_from_reference(model: TransformerLM, tree,
                             device="cpu") -> Dict:
    """The reference ``TransformerLM.init`` tree (``embed``, ``body`` — one
    dict a period position, each leaf stacked over periods — ``tail``,
    ``final_scale``/``final_bias``, ``lm_head``, ``stub_proj``), as numpy
    arrays, turned into this package's layout with the same values: the
    layers unstacked into execution order, periods outer and positions
    inner, as the reference's scan runs them."""
    def t(a):
        return torch.as_tensor(np.array(a)).to(device)

    layers = []
    for pp in range(model.n_periods):
        for pi in range(len(model.period_specs)):
            layers.append({g: {k: t(np.asarray(a)[pp]) for k, a in d.items()}
                           for g, d in tree["body"][pi].items()})
    for ti in range(len(model.tail_specs)):
        layers.append({g: {k: t(a) for k, a in d.items()}
                       for g, d in tree["tail"][ti].items()})
    out = {"embed": t(tree["embed"]), "layers": layers,
           "final_scale": t(tree["final_scale"])}
    for key in ("final_bias", "lm_head", "stub_proj"):
        if key in tree:
            out[key] = t(tree[key])
    return out
