"""Wrapper + plain version of the decode-attention kernel."""
from __future__ import annotations

from . import kernel as _kernel
from . import ref as _ref

decode_attention = _kernel.decode_attention
decode_attention_ref = _ref.decode_attention
