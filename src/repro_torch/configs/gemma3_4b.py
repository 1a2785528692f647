"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global attention, 1024-token sliding window, 128k context.
long_500k runs: 5/6 of layers are sliding-window; global layers decode with
sequence-sharded KV (DESIGN.md §4). [hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab=262144,
    local_global_ratio=(5, 1),
    window=1024,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-4b (unverified)",
)
