"""Wrappers + plain versions of the attention kernels."""
from __future__ import annotations

from . import flash as _flash
from . import kernel as _kernel
from . import ref as _ref

decode_attention = _kernel.decode_attention
decode_attention_ref = _ref.decode_attention
flash_attention = _flash.flash_attention
flash_attention_ref = _ref.flash_attention
