"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (MHA kv=32) d_ff=8192 vocab=32064;
phi3-mini backbone + CLIP vision frontend. Backbone only; the modality
frontend is a STUB (input_specs provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab=32064,
    n_stub_tokens=576,      # CLIP 24x24 patch embeddings (stub)
    skip_shapes=("long_500k",),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
