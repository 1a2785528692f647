from .pipeline import DataConfig, TokenStream, make_global_batch

__all__ = ["DataConfig", "TokenStream", "make_global_batch"]
