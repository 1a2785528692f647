from . import ops  # noqa: F401
from .kernel import WKVLimitError
from .ops import wkv_chunked, wkv_chunked_ref, wkv_ref

__all__ = ["WKVLimitError", "ops", "wkv_chunked", "wkv_chunked_ref",
           "wkv_ref"]
