"""LM model stack for the dense, MoE, RWKV6, hybrid (Mamba) and VLM
families: layers, blocks, the decoder-only transformer and the registry."""
from .blocks import FamilyNotPortedError
from .registry import build_model, example_batch, input_specs
from .transformer import TransformerLM, lm_params_from_reference

__all__ = ["FamilyNotPortedError", "TransformerLM", "build_model",
           "example_batch", "input_specs", "lm_params_from_reference"]
