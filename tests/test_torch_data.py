"""The port's data pipeline (``repro_torch.data``) against the reference's
``repro.data``: the file-backed token source and the stub ``frames`` /
``stub_embeds`` are plain numpy arithmetic and must equal the reference's
arrays exactly; the synthetic stream is the port's own counter-based
draw (numpy's Philox keyed by (seed, step, shard)), held to the
reference's properties: deterministic, recomputable, shard-independent,
in range, int32 (``test_substrates``' data test, mirrored)."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as rget_config
from repro.data import (DataConfig as RDataConfig,
                        TokenStream as RTokenStream,
                        make_global_batch as rmake_global_batch)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenStream, make_global_batch


def test_data_deterministic_and_sharded():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=8)
    s0 = TokenStream(cfg, shard=0, num_shards=4)
    s1 = TokenStream(cfg, shard=1, num_shards=4)
    b0a, b0b = s0.batch_at(3), s0.batch_at(3)
    np.testing.assert_array_equal(b0a, b0b)        # recomputable
    assert not np.array_equal(s0.batch_at(3), s1.batch_at(3))
    assert s0.batch_at(3).shape == (2, 16)
    assert s0.batch_at(3).dtype == np.int32


def test_synthetic_stream_is_counter_based():
    """A batch depends on (seed, step, shard) alone: iteration order, a
    fresh stream and a restarted one give the same arrays; another seed or
    step gives others; every token lies in [0, vocab)."""
    cfg = DataConfig(vocab=37, seq_len=64, global_batch=6, seed=5)
    it = iter(TokenStream(cfg))
    first = [next(it) for _ in range(4)]
    fresh = TokenStream(cfg)
    for step, b in enumerate(first):
        np.testing.assert_array_equal(fresh.batch_at(step), b)
        assert b.min() >= 0 and b.max() < 37
    assert not np.array_equal(first[0], first[1])
    other = TokenStream(dataclasses.replace(cfg, seed=6))
    assert not np.array_equal(other.batch_at(0), first[0])
    # shard i of n is independent of n's other shards
    s2 = TokenStream(cfg, shard=2, num_shards=3)
    np.testing.assert_array_equal(s2.batch_at(1), s2.batch_at(1))


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_file_backed_source_equals_reference(tmp_path, num_shards):
    """The memory-mapped source gives the reference's windows, modulo the
    vocab, for every (step, shard)."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(
        np.int32).tofile(path)
    kw = dict(vocab=300, seq_len=48, global_batch=8, path=str(path))
    for shard in range(num_shards):
        got = TokenStream(DataConfig(**kw), shard, num_shards)
        want = RTokenStream(RDataConfig(**kw), shard, num_shards)
        for step in (0, 1, 7, 50):
            g, w = got.batch_at(step), want.batch_at(step)
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-medium",
                                  "granite-3-2b"])
def test_global_batch_stub_inputs_equal_reference(tmp_path, arch):
    """``make_global_batch``'s keys, and its ``stub_embeds`` (VLM) or
    ``frames`` (enc-dec), equal the reference's; with a file-backed
    source the tokens too."""
    path = tmp_path / "tokens.bin"
    np.arange(4000, dtype=np.int32).tofile(path)
    kw = dict(vocab=512, seq_len=16, global_batch=3, seed=4, path=str(path))
    for step in (0, 3):
        got = make_global_batch(DataConfig(**kw), step,
                                get_config(arch).reduced())
        want = rmake_global_batch(RDataConfig(**kw), step,
                                  rget_config(arch).reduced())
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
