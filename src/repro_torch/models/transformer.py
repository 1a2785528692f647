"""Decoder-only LM for the dense family (GQA, RoPE, local:global sliding
windows, tied embeddings) and the RWKV6 family (attention-free, a
recurrent WKV state), the counterpart of the reference's
``repro/models/transformer.py``.

The reference stacks each period position's parameters over periods and
scans; PyTorch runs eagerly, so here the layers are a plain list in
execution order (``params["layers"][li]``, one ``{"attn", "ffn"}`` or
``{"rwkv"}`` dict a layer) and ``forward``/``decode_step`` loop over them.
The layer schedule (which layers are sliding-window) is the reference's
``build_schedule``.
:func:`lm_params_from_reference` turns the reference's stacked tree,
carried across as numpy arrays, into this layout, so both packages
compute the same function in the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

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


def _check_supported(cfg: ModelConfig, specs: List[BlockSpec]):
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise blocks.FamilyNotPortedError(f"the {cfg.family!r} family")
    if cfg.n_stub_tokens:
        raise blocks.FamilyNotPortedError("stub (VLM/audio) token inputs")
    for spec in specs:
        if spec.kind == "mamba":
            raise blocks.FamilyNotPortedError("the Mamba selective-SSM block")
        if spec.is_moe:
            raise blocks.FamilyNotPortedError("the MoE FFN block")


class TransformerLM:
    """The dense and RWKV6 families: embed, attention + FFN blocks or RWKV
    blocks, final norm, head."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        #: Megatron-style vocab padding to a multiple of 256, as the
        #: reference; the padded logits are masked to -1e30
        self.vocab_padded = -(-cfg.vocab // 256) * 256
        self.period_specs, self.n_periods, self.tail_specs = \
            build_schedule(cfg)
        self.layer_specs: List[BlockSpec] = \
            list(self.period_specs) * self.n_periods + list(self.tail_specs)
        _check_supported(cfg, self.layer_specs)

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
        params["layers"] = [
            {"rwkv": blocks.rwkv_init(cfg, g, dev)} if spec.kind == "rwkv"
            else {"attn": blocks.attn_init(cfg, g, dev),
                  "ffn": blocks.ffn_init(cfg, g, spec.is_moe, dev)}
            for spec in self.layer_specs]
        params["final_scale"] = torch.zeros((cfg.d_model,),
                                            dtype=torch.float32, device=dev)
        if cfg.norm == "layernorm":
            params["final_bias"] = torch.zeros((cfg.d_model,),
                                               dtype=torch.float32, device=dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(g, (cfg.d_model, self.vocab_padded),
                                           dtype=dt, device=dev)
        return params

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
            pad = torch.arange(self.vocab_padded,
                               device=logits.device) >= self.cfg.vocab
            logits = torch.where(pad, torch.tensor(NEG_INF, dtype=logits.dtype,
                                                   device=logits.device),
                                 logits)
        return logits

    def embed_tokens(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return params["embed"][tokens.long()].to(self.adt)

    def _block(self, spec: BlockSpec, p: Dict, x, cache=None, pos=None):
        if spec.kind == "rwkv":
            x, nc = blocks.rwkv_apply(self.cfg, p["rwkv"], x, cache=cache)
            return x, torch.zeros((), dtype=torch.float32,
                                  device=x.device), nc or {}
        c = None
        if cache is not None:
            c = {"k": cache["k"], "v": cache["v"], "pos": pos}
        x, nc = blocks.attn_apply(self.cfg, p["attn"], x, window=spec.window,
                                  cache=c)
        x, aux = blocks.ffn_apply(self.cfg, p["ffn"], x, spec.is_moe)
        new_cache = {"k": nc["k"], "v": nc["v"]} if nc is not None else {}
        return x, aux, new_cache

    def forward(self, params, batch: Dict, training: bool = False):
        """batch: {'tokens': (B, S) int} -> (logits (B, S, V), aux loss)."""
        x = self.embed_tokens(params, batch["tokens"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, p in zip(self.layer_specs, params["layers"]):
            x, a, _ = self._block(spec, p, x)
            aux = aux + a
        x = self._final_norm(params, x)
        return self._logits(params, x), aux

    # -- decode -----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> Dict:
        """A zero decode cache: per attention layer K/V of ``max_seq``
        positions in ``dtype``; per RWKV layer its state, in float32
        whatever ``dtype`` (as the reference's cache)."""
        def layer(spec):
            if spec.kind == "rwkv":
                return blocks.rwkv_cache_init(self.cfg, batch, device=device)
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


def lm_params_from_reference(model: TransformerLM, tree,
                             device="cpu") -> Dict:
    """The reference ``TransformerLM.init`` tree (``embed``, ``body`` — one
    dict a period position, each leaf stacked over periods — ``tail``,
    ``final_scale``/``final_bias``, ``lm_head``), as numpy arrays, turned
    into this package's layout with the same values: the layers unstacked
    into execution order, periods outer and positions inner, as the
    reference's scan runs them."""
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
    for key in ("final_bias", "lm_head"):
        if key in tree:
            out[key] = t(tree[key])
    return out
