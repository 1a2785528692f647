"""LM model stack for the dense, MoE, RWKV6, hybrid (Mamba), VLM and
enc-dec families: layers, blocks, the decoder-only transformer, the
encoder-decoder and the registry."""
from .encdec import EncDecLM, encdec_params_from_reference
from .registry import build_model, example_batch, input_specs
from .transformer import TransformerLM, lm_params_from_reference

__all__ = ["EncDecLM", "TransformerLM", "build_model",
           "encdec_params_from_reference", "example_batch", "input_specs",
           "lm_params_from_reference"]
