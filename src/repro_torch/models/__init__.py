"""LM model stack for the dense and RWKV6 families: layers, blocks, the
decoder-only transformer and the registry."""
from .blocks import FamilyNotPortedError
from .registry import build_model
from .transformer import TransformerLM, lm_params_from_reference

__all__ = ["FamilyNotPortedError", "TransformerLM", "build_model",
           "lm_params_from_reference"]
