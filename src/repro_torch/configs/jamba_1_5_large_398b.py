"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576,
Mamba+attention 1:7 interleave (1 attention layer per 8), MoE 16e top-2
every other layer. long_500k runs (hybrid). [arXiv:2403.19887; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, moe_every=2),
    hybrid_period=8,
    hybrid_attn_index=0,
    d_state=16,
    expand=2,
    optimizer="adafactor",
    source="arXiv:2403.19887",
)
