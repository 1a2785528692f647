"""rwkv6-7b [ssm]: 32L d=4096 (attention-free, data-dependent decay, Finch)
d_ff=14336 vocab=65536. long_500k runs (O(1) state). [arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # wkv heads of size 64
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    norm="layernorm",
    source="arXiv:2404.05892",
)
