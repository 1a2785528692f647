"""Deterministic sharded data pipeline, the counterpart of the reference's
``repro/data/pipeline.py``.

Synthetic token streams are counter-based: the batch of (step, shard) is
drawn from numpy's Philox generator keyed by (seed, step, shard), so every
data-parallel shard produces its batch independently with no host I/O, any
shard can be recomputed after a restart (fault tolerance without
data-loader checkpoints), and elastic re-sharding is a pure re-indexing.
The draws are the port's own: they do not reproduce the reference's
threefry bits (``jax.random.randint``), only its properties. The
memory-mapped binary-token file source and the stub ``frames`` /
``stub_embeds`` (``np.random.default_rng(seed + step)``) are plain numpy
arithmetic and give the reference's arrays exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None     # None = synthetic


class TokenStream:
    """data_shard i of n: yields (local_batch, seq) int32 token batches."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        if self._mm is None:
            # counter-based: deterministic, recomputable, shard-independent
            rng = np.random.Generator(np.random.Philox(
                np.random.SeedSequence([cfg.seed, step, self.shard])))
            return rng.integers(0, cfg.vocab, (self.local_batch, cfg.seq_len),
                                dtype=np.int32)
        # file-backed: strided window per (step, shard, row)
        n_tokens = self._mm.shape[0]
        rows = []
        for b in range(self.local_batch):
            idx = (step * cfg.global_batch
                   + self.shard * self.local_batch + b)
            start = (idx * cfg.seq_len) % max(n_tokens - cfg.seq_len, 1)
            rows.append(np.asarray(self._mm[start:start + cfg.seq_len]))
        return np.stack(rows).astype(np.int32) % self.cfg.vocab

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_global_batch(cfg: DataConfig, step: int, model_cfg=None
                      ) -> Dict[str, np.ndarray]:
    """Whole global batch (single-host path)."""
    stream = TokenStream(cfg, shard=0, num_shards=1)
    batch = {"tokens": stream.batch_at(step)}
    if model_cfg is not None and getattr(model_cfg, "n_stub_tokens", 0):
        rng = np.random.default_rng(cfg.seed + step)
        key = "stub_embeds" if model_cfg.family == "vlm" else "frames"
        if model_cfg.family in ("vlm", "encdec"):
            batch[key] = rng.standard_normal(
                (cfg.global_batch, model_cfg.n_stub_tokens,
                 model_cfg.d_model)).astype(np.float32)
    return batch
