"""kimi-k2-1t-a32b [moe]: 61L d=7168 64H (GQA kv=8) d_ff=2048 (expert)
vocab=163840, MoE 384 experts top-8, shared expert — trillion-param MoE.
[arXiv:2501.kimi2; unverified]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=2048,
    vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, moe_every=1,
                  shared_expert=True, capacity_factor=1.0),
    rope_theta=50000.0,
    optimizer="adafactor",   # fp32 Adam for 1T params needs >4 pods
    skip_shapes=("long_500k",),
    source="arXiv:2501.kimi2 (unverified)",
)
