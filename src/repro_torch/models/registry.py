"""Model registry: config -> model instance, and the model's inputs: the
stand-ins of ``input_specs`` (meta tensors, no allocation) and the small
concrete batches of ``example_batch``."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from .encdec import EncDecLM
from .transformer import TransformerLM


def build_model(cfg: ModelConfig):
    """The model of a config: :class:`EncDecLM` for the enc-dec family,
    :class:`TransformerLM` for the others (dense, MoE, ssm (RWKV6),
    hybrid (Mamba) and VLM)."""
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return TransformerLM(cfg)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch_override: int = None) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input (shape and dtype, no
    allocation), the reference's: a VLM's prompt shapes hold S - n_stub
    text tokens beside its (B, n_stub, D) stub embeddings."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "decode":
        specs["tokens"] = _spec((B, 1), torch.int32)
    else:
        s_tok = S
        if cfg.n_stub_tokens and cfg.family in ("vlm",):
            s_tok = S - cfg.n_stub_tokens
        specs["tokens"] = _spec((B, s_tok), torch.int32)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["stub_embeds"] = _spec((B, cfg.n_stub_tokens, cfg.d_model),
                                     torch.bfloat16)
    if cfg.family == "encdec" and shape.kind != "decode":
        specs["frames"] = _spec((B, cfg.n_stub_tokens, cfg.d_model),
                                torch.bfloat16)
    return specs


def example_batch(cfg: ModelConfig, shape_name: str, batch: int, seq: int,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """A small concrete batch for smoke tests: the reference's numpy draws
    from the same seed."""
    rng = np.random.default_rng(seed)
    batch_d: Dict[str, np.ndarray] = {}
    batch_d["tokens"] = rng.integers(0, cfg.vocab, (batch, seq),
                                     dtype=np.int32)
    if cfg.family == "vlm":
        batch_d["stub_embeds"] = rng.standard_normal(
            (batch, cfg.n_stub_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch_d["frames"] = rng.standard_normal(
            (batch, cfg.n_stub_tokens, cfg.d_model)).astype(np.float32)
    return batch_d
