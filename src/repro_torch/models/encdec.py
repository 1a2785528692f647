"""Encoder-decoder backbone (seamless-m4t-medium), the counterpart of the
reference's ``repro/models/encdec.py``.

The audio frontend is a stub: the encoder takes precomputed frame
embeddings (B, T_enc, D), projects them (``frame_proj``) and runs a
bidirectional self-attention + FFN stack with no final norm. The decoder
runs causal self-attention, then cross-attention over the encoder memory
(no RoPE on either side), then the FFN. Decoding caches both the
self-attention K/V and the memory's per-layer cross K/V, which
``prefill_cache`` projects once.

The reference stacks each leaf over layers and scans; here the encoder and
decoder layers are plain lists in execution order
(``params["encoder"][li]`` = ``{"attn", "ffn"}``,
``params["decoder"][li]`` = ``{"attn", "cross", "ffn"}``), and the decode
cache is ``{"pos": int, "layers": [{"k", "v", "ck", "cv"}, ...]}``: entry
``li`` of the list holds row ``li`` of the reference's stacked
(L, B, ...) arrays ``cache["layers"]["k"]`` etc.
:func:`encdec_params_from_reference` turns the reference's stacked tree,
carried across as numpy arrays, into this layout.

``loss`` is the reference's cross-entropy (no aux term), and ``remat``
runs each encoder and decoder layer under activation checkpointing (the
reference's ``jax.checkpoint``) when no cache is given.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..pipeline.stages import resolve_device
from . import blocks
from .layers import NEG_INF, dense_init, layer_norm, rms_norm
from .transformer import next_token_loss, remat_call, stack_groups


class EncDecLM:
    """The enc-dec family: frame projection and bidirectional encoder,
    decoder with causal self-attention and cross-attention, final norm,
    head."""

    def __init__(self, cfg: ModelConfig, remat: bool = False):
        self.cfg = cfg
        self.remat = remat
        #: Megatron-style vocab padding to a multiple of 256, as the
        #: reference; the padded logits are masked to -1e30
        self.vocab_padded = -(-cfg.vocab // 256) * 256

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
        params: Dict = {
            "embed": dense_init(g, (self.vocab_padded, cfg.d_model),
                                scale=1.0, dtype=dt, device=dev),
            "frame_proj": dense_init(g, (cfg.d_model, cfg.d_model),
                                     dtype=dt, device=dev)}
        params["encoder"] = [
            {"attn": blocks.attn_init(cfg, g, dev),
             "ffn": blocks.ffn_init(cfg, g, False, dev)}
            for _ in range(cfg.n_encoder_layers)]
        params["decoder"] = [
            {"attn": blocks.attn_init(cfg, g, dev),
             "cross": blocks.attn_init(cfg, g, dev),
             "ffn": blocks.ffn_init(cfg, g, False, dev)}
            for _ in range(cfg.n_layers)]
        params["final_scale"] = torch.zeros((cfg.d_model,),
                                            dtype=torch.float32, device=dev)
        if cfg.norm == "layernorm":
            params["final_bias"] = torch.zeros((cfg.d_model,),
                                               dtype=torch.float32, device=dev)
        params["lm_head"] = dense_init(g, (cfg.d_model, self.vocab_padded),
                                       dtype=dt, device=dev)
        return params

    # -- forward ----------------------------------------------------------
    def encode(self, params, frames):
        """frames (B, T_enc, D) -> the encoder memory (B, T_enc, D) in the
        activation dtype."""
        cfg = self.cfg
        adt = self.adt
        w = params["frame_proj"]
        frames = torch.as_tensor(frames, device=w.device).to(adt)
        x = torch.matmul(frames, w.to(adt))
        for p in params["encoder"]:
            def blk(x_, p=p):
                x_, _ = blocks.attn_apply(cfg, p["attn"], x_, window=None,
                                          causal=False)
                x_, _ = blocks.ffn_apply(cfg, p["ffn"], x_, False)
                return x_
            x = remat_call(blk, x) if self.remat else blk(x)
        return x

    def _cross_kv(self, cfg, p, memory):
        adt = self.adt
        b, t, _ = memory.shape
        shape = (b, t, cfg.n_kv_heads, cfg.head_dim)
        k = torch.matmul(memory, p["wk"].to(adt)).reshape(shape)
        v = torch.matmul(memory, p["wv"].to(adt)).reshape(shape)
        return k, v

    def _decoder_stack(self, params, x, memory, cache=None, pos=None):
        """The decoder layers over x (B, S, D). Without ``cache``: causal
        self-attention over x and cross-attention over ``memory`` ->
        (x, None). With a decode cache: self-attention through each
        layer's K/V cache from ``pos`` and cross-attention over its cached
        ``ck``/``cv`` (cast to x's dtype, as the reference's decode_step
        casts them) -> (x, the new per-layer caches)."""
        cfg = self.cfg
        if cache is None:
            for p in params["decoder"]:
                def blk(x_, mem_, p=p):
                    x_, _ = blocks.attn_apply(cfg, p["attn"], x_,
                                              window=None)
                    kv = self._cross_kv(cfg, p["cross"], mem_)
                    x_, _ = blocks.attn_apply(cfg, p["cross"], x_,
                                              window=None, kv_override=kv)
                    x_, _ = blocks.ffn_apply(cfg, p["ffn"], x_, False)
                    return x_
                x = remat_call(blk, x, memory) if self.remat \
                    else blk(x, memory)
            return x, None
        new_layers: List[Dict] = []
        for p, c in zip(params["decoder"], cache["layers"]):
            x, nc = blocks.attn_apply(cfg, p["attn"], x, window=None,
                                      cache={"k": c["k"], "v": c["v"],
                                             "pos": pos})
            kv = (c["ck"].to(x.dtype), c["cv"].to(x.dtype))
            x, _ = blocks.attn_apply(cfg, p["cross"], x, window=None,
                                     kv_override=kv)
            x, _ = blocks.ffn_apply(cfg, p["ffn"], x, False)
            new_layers.append({"k": nc["k"], "v": nc["v"], "ck": c["ck"],
                               "cv": c["cv"]})
        return x, new_layers

    def _final(self, params, x):
        cfg = self.cfg
        if cfg.norm == "rmsnorm":
            x = rms_norm(x, params["final_scale"])
        else:
            x = layer_norm(x, params["final_scale"] + 1.0,
                           params["final_bias"])
        adt = self.adt
        logits = torch.matmul(x.to(adt), params["lm_head"].to(adt))
        if self.vocab_padded != cfg.vocab:
            # in place: a second (B, S, V) buffer is GBs at full width
            logits[..., cfg.vocab:] = NEG_INF
        return logits

    def embed_tokens(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return params["embed"][tokens.long()].to(self.adt)

    def forward(self, params, batch: Dict):
        """batch: {'tokens': (B, S) int, 'frames': (B, T_enc, D)} ->
        (logits (B, S, V), a zero aux loss)."""
        memory = self.encode(params, batch["frames"])
        x = self.embed_tokens(params, batch["tokens"])
        x, _ = self._decoder_stack(params, x, memory)
        return self._final(params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def stacked_leaves(self, params):
        """The groups of leaves the reference stores as one array: each
        encoder leaf over the encoder layers, each decoder leaf over the
        decoder layers; the other leaves alone (Adafactor reads this)."""
        return stack_groups(params, {
            key: [list(range(len(params[key])))]
            for key in ("encoder", "decoder")})

    def loss(self, params, batch: Dict):
        """Mean next-token cross-entropy, logsumexp form in float32."""
        logits, _ = self.forward(params, batch)
        return next_token_loss(logits, batch["tokens"])

    # -- decode -----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   t_enc: int = None, device=None) -> Dict:
        """A zero decode cache in ``dtype`` on ``device`` (``cuda`` unless
        given): per decoder layer the self-attention K/V of ``max_seq``
        positions and the cross K/V of ``t_enc`` frames (the config's
        ``n_stub_tokens`` unless given)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = blocks._dtype(dtype)
        t_enc = t_enc or cfg.n_stub_tokens
        hd = cfg.head_dim

        def zeros(t):
            return torch.zeros((batch, t, cfg.n_kv_heads, hd), dtype=dt,
                               device=dev)

        return {"pos": 0,
                "layers": [{"k": zeros(max_seq), "v": zeros(max_seq),
                            "ck": zeros(t_enc), "cv": zeros(t_enc)}
                           for _ in range(cfg.n_layers)]}

    def prefill_cache(self, params, cache, frames):
        """Encode ``frames`` and project the memory into every decoder
        layer's cross K/V, in the cache's dtype. As the reference's, it
        assigns them into the cache it is given (each layer's ``ck``/
        ``cv`` entry becomes a new tensor; the old tensors are not written)
        and returns that cache."""
        cfg = self.cfg
        memory = self.encode(params, frames)
        for p, c in zip(params["decoder"], cache["layers"]):
            ck, cv = self._cross_kv(cfg, p["cross"], memory)
            c["ck"] = ck.to(c["ck"].dtype)
            c["cv"] = cv.to(c["cv"].dtype)
        return cache

    def decode_step(self, params, cache: Dict, tokens):
        """tokens: (B, S) -> (logits (B, S, V), new cache); the cache is
        not modified (the new one shares its cross K/V)."""
        x = self.embed_tokens(params, tokens)
        pos = int(cache["pos"])
        x, layers = self._decoder_stack(params, x, None, cache=cache,
                                        pos=pos)
        return self._final(params, x), {"pos": pos + x.shape[1],
                                        "layers": layers}


def encdec_params_from_reference(model: EncDecLM, tree,
                                 device="cpu") -> Dict:
    """The reference ``EncDecLM.init`` tree (``embed``, ``frame_proj``,
    ``encoder`` and ``decoder`` with each leaf stacked over layers,
    ``final_scale``/``final_bias``, ``lm_head``), as numpy arrays, turned
    into this package's layout with the same values: the layers unstacked
    into execution order."""
    def t(a):
        return torch.as_tensor(np.array(a)).to(device)

    def unstack(stack, n):
        return [{g: {k: t(np.asarray(a)[li]) for k, a in d.items()}
                 for g, d in stack.items()} for li in range(n)]

    cfg = model.cfg
    out = {"embed": t(tree["embed"]), "frame_proj": t(tree["frame_proj"]),
           "encoder": unstack(tree["encoder"], cfg.n_encoder_layers),
           "decoder": unstack(tree["decoder"], cfg.n_layers),
           "final_scale": t(tree["final_scale"]),
           "lm_head": t(tree["lm_head"])}
    if "final_bias" in tree:
        out["final_bias"] = t(tree["final_bias"])
    return out
