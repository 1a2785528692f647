"""seamless-m4t-medium [audio]: enc-dec 12L d=1024 16H (kv=16) d_ff=4096
vocab=256206. Transformer BACKBONE only; the audio frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,             # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=256206,
    norm="layernorm",
    act="gelu",
    n_stub_tokens=1024,      # audio frames fed to the encoder (stub)
    skip_shapes=("long_500k",),
    source="arXiv:2308.11596",
)
