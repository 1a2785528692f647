"""Model registry: config -> model instance."""
from __future__ import annotations

from ..configs.base import ModelConfig
from .blocks import FamilyNotPortedError
from .transformer import TransformerLM


def build_model(cfg: ModelConfig):
    """The model of a config. The dense, MoE and ssm (RWKV6) families run;
    the enc-dec family (and every block of the Mamba and VLM families)
    raises :class:`FamilyNotPortedError`."""
    if cfg.family == "encdec":
        raise FamilyNotPortedError("the enc-dec family (EncDecLM)")
    return TransformerLM(cfg)

