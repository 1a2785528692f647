"""Config system: model architecture + input-shape specs, as plain
dataclasses.

One file per assigned architecture in this package; each exports CONFIG
(the same values as the reference package's ``repro/configs``).
``reduced()`` returns a same-family miniature for CPU tests; the full
configs run on the card (``chip_smoke.py`` serves starcoder2-3b at full
width and depth).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    moe_every: int = 1          # every n-th layer is MoE
    shared_expert: bool = False
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    moe: Optional[MoEConfig] = None
    # attention pattern: period of (local:global); window size for local
    local_global_ratio: Optional[Tuple[int, int]] = None  # e.g. (5, 1)
    window: Optional[int] = None
    # hybrid (jamba): layers per period that are attention (rest = mamba)
    hybrid_period: Optional[int] = None
    hybrid_attn_index: int = 0
    # ssm / mamba / rwkv
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # enc-dec
    n_encoder_layers: Optional[int] = None
    # vlm / audio stubs
    n_stub_tokens: int = 0       # patch/frame embeddings prepended
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    optimizer: str = "adamw"     # adamw | adafactor (low-mem for XXL archs)
    # skip list for shapes inapplicable to this arch (DESIGN.md §4)
    skip_shapes: Tuple[str, ...] = ()
    source: str = ""
    # -- perf variants (EXPERIMENTS §Perf): defaults are the paper-faithful
    # baseline; the hillclimbed configuration sets chunked/sort.
    attention_impl: str = "naive"    # naive | chunked
    moe_dispatch: str = "onehot"     # onehot | sort

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        p = self.vocab * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.family == "ssm":
            # rwkv6: 5 square time-mix matrices + 2 channel-mix matrices
            blk = 5 * d * d + 2 * d * self.d_ff
            p += L * (blk + 4 * d)
            return p
        def ffn_dense(dff):
            return 3 * d * dff if self.act == "swiglu" else 2 * d * dff
        n_attn_layers = L
        n_mamba_layers = 0
        if self.hybrid_period:
            n_attn_layers = L // self.hybrid_period
            n_mamba_layers = L - n_attn_layers
        p += n_attn_layers * attn
        d_inner = self.expand * d
        p += n_mamba_layers * (2 * d * d_inner + d_inner * d
                               + d_inner * self.d_state * 2)
        if self.moe:
            n_moe = L // self.moe.moe_every
            n_dense = L - n_moe
            p += n_moe * (self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                          + d * self.moe.n_experts)
            if self.moe.shared_expert:
                p += n_moe * 3 * d * self.moe.d_ff_expert
            p += n_dense * ffn_dense(self.d_ff)
        else:
            p += L * ffn_dense(self.d_ff)
        if self.n_encoder_layers:
            p += self.n_encoder_layers * (attn + ffn_dense(self.d_ff))
            p += L * attn  # cross attention
        return p

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        full = self.n_params()
        n_moe = L // self.moe.moe_every
        all_experts = n_moe * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        active = n_moe * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return full - all_experts + active

    def reduced(self) -> "ModelConfig":
        """Miniature same-family config for CPU smoke tests."""
        n_layers = min(self.n_layers, 4)
        if self.hybrid_period:
            n_layers = min(self.n_layers, self.hybrid_period)
        if self.local_global_ratio:
            n_layers = sum(self.local_global_ratio)  # one full l:g period
        changes = dict(
            n_layers=n_layers,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads <
            self.n_heads else 4,
            d_head=32,
            d_ff=256,
            vocab=512,
            window=min(self.window, 16) if self.window else None,
            d_state=8,
            n_encoder_layers=2 if self.n_encoder_layers else None,
            n_stub_tokens=min(self.n_stub_tokens, 8),
        )
        if self.moe:
            changes["moe"] = MoEConfig(
                n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=128,
                moe_every=self.moe.moe_every,
                shared_expert=self.moe.shared_expert)
        if self.hybrid_period:
            changes["hybrid_period"] = min(self.hybrid_period, 4)
            changes["n_layers"] = changes["hybrid_period"]
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
