from . import ops  # noqa: F401
from .flash import FlashAttentionLimitError
from .kernel import DecodeAttentionLimitError
from .ops import (decode_attention, decode_attention_ref, flash_attention,
                  flash_attention_ref)

__all__ = ["DecodeAttentionLimitError", "FlashAttentionLimitError",
           "decode_attention", "decode_attention_ref", "flash_attention",
           "flash_attention_ref", "ops"]
