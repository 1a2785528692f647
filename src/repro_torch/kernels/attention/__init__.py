from . import ops  # noqa: F401
from .kernel import DecodeAttentionLimitError
from .ops import decode_attention, decode_attention_ref

__all__ = ["DecodeAttentionLimitError", "decode_attention",
           "decode_attention_ref", "ops"]
