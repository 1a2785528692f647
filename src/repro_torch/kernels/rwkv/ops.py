"""Wrapper + plain versions of the WKV kernel."""
from __future__ import annotations

from . import kernel as _kernel
from . import ref as _ref

wkv_chunked = _kernel.wkv_chunked
wkv_chunked_ref = _ref.wkv_chunked
wkv_ref = _ref.wkv
