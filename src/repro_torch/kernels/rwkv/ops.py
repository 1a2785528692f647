"""Wrapper + plain versions of the WKV kernel."""
from __future__ import annotations

from . import kernel as _kernel
from . import ref as _ref

wkv_chunked = _kernel.wkv_chunked
wkv_chunked_ref = _ref.wkv_chunked
wkv_chunked_bwd = _kernel.wkv_chunked_bwd
wkv_chunked_bwd_ref = _ref.wkv_chunked_bwd
wkv_ref = _ref.wkv
