"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import SHAPES, ModelConfig, MoEConfig, ShapeSpec

ARCHS = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-3-2b": "granite_3_2b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma3-4b": "gemma3_4b",
    "yi-34b": "yi_34b",
    "rwkv6-7b": "rwkv6_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    mod = importlib.import_module(f".{ARCHS[arch]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "MoEConfig", "ShapeSpec",
           "get_config", "all_configs"]
