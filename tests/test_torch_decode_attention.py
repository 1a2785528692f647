"""decode_attention (kernel row 11) on the CPU: the plain version against
the reference's Pallas kernel in interpret mode at the mask's edges, the
split of long contexts (``kernel.plan``, ``kernel.chunk_ranges``) and its
merge arithmetic, the kernel's routes, and the pieces of ``chip_smoke.py``
that plant faults in the kernel's source.

The CUDA kernel itself has no CPU mode; its cases on the card are the
``decode`` tests of ``tests/test_torch_gpu.py``. Tolerances: the plain
version against the reference at fp32 rtol 1e-5 / atol 1e-6 (the order of
the softmax's sums), as ``tests/test_torch_models.py`` holds it.
"""
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import decode_attention as rdecode_attention
from repro_torch.kernels.attention import decode_attention
from repro_torch.kernels.attention import kernel as kern

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "decode_attention.cu"

#: the shapes the split is planned for: the serving step, a long context
#: and gemma3-4b's windowed layers, GQA-repeated
SERVING = (64, 64, 24, 128, torch.bfloat16)
LONG = (8, 4096, 24, 128, torch.bfloat16)
WINDOWED = (16, 2048, 8, 256, torch.bfloat16)


def _case(B, C, H, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, C, H, Dh)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _admitted(C, pos, window):
    """The reference's mask as a row range: (lo, hi), empty when lo > hi."""
    lo = max(0, pos - window + 1) if window else 0
    return lo, min(pos, C - 1)


# ---------------------------------------------------------------------------
# the plain version against the reference at the mask's edges
# ---------------------------------------------------------------------------
EDGES = {
    # name: (B, C, H, Dh, window, pos for each b)
    "pos_negative": (3, 24, 2, 32, None, [-1, -7, 5]),
    "window_past_context": (2, 24, 2, 32, 4, [30, 27]),
    "pos_past_context": (3, 24, 2, 32, None, [24, 1000, 23]),
    "pos_past_context_window": (2, 24, 2, 32, 6, [25, 26]),
    "window_one": (3, 24, 2, 32, 1, [0, 11, 23]),
    "window_over_context": (3, 24, 2, 32, 40, [0, 11, 23]),
    "dh256_window": (2, 48, 2, 256, 16, [47, 9]),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_plain_matches_reference_at_the_mask_edges(name):
    B, C, H, Dh, window, pos = EDGES[name]
    q, k, v = _case(B, C, H, Dh, seed=len(name))
    pos = np.asarray(pos, np.int32)
    want = rdecode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)),
                             window=window, interpret=True)
    t = torch.as_tensor
    got = decode_attention(t(q), t(k), t(v), t(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for b, p in enumerate(pos):
        lo, hi = _admitted(C, int(p), window)
        if lo > hi:   # nothing admitted: the mean of V over all C rows
            np.testing.assert_allclose(got[b].numpy(), v[b].mean(0),
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------
PLANNED = [SERVING, LONG, WINDOWED, (2, 129, 4, 128, torch.bfloat16),
           (1, 1000, 2, 64, torch.float32), (3, 40, 5, 64, torch.float32),
           (2, 2048, 8, 256, torch.float32),
           (1, 50_000, 1, 128, torch.float32)]


@pytest.mark.parametrize("shape", PLANNED)
@pytest.mark.parametrize("window", [None, 1, 37, 1024])
def test_chunks_cover_the_admitted_range_once_in_order(shape, window):
    """The plan sizes its chunks over the longest range a row can admit,
    min(C, window) rows; an empty range's C rows still take at most
    ``chunks`` chunks."""
    B, C, H, Dh, dt = shape
    rows, chunks = kern.plan(B, C, H, Dh, dt, window)
    span = min(C, window or C)
    assert 1 <= rows <= C and chunks <= kern.MAX_CHUNKS
    assert chunks == 1 or chunks == -(-span // rows)
    step = max(1, C // 97)
    for pos in list(range(-3, C + (window or 0) + 3, step)) + [C - 1, C]:
        ranges, empty = kern.chunk_ranges(C, pos, window, rows, chunks)
        lo, hi = _admitted(C, pos, window)
        assert empty == (lo > hi)
        if empty:
            lo, hi = 0, C - 1
        assert 1 <= len(ranges) <= chunks
        assert ranges[0][0] == lo and ranges[-1][1] == hi
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert c == b + 1          # in order, no row twice or missed
        most = rows if not empty else max(rows, -(-C // chunks))
        assert all(a <= b and b - a + 1 <= most for a, b in ranges)


def test_plan_splits_only_what_cannot_fill_the_card():
    # the serving step's 1,536 (b, h) rows fill the card unsplit
    assert kern.plan(*SERVING) == (64, 1)
    for shape in (LONG, WINDOWED):
        B, C, H, Dh, dt = shape
        rows, chunks = kern.plan(*shape)
        assert chunks > 1 and rows % kern.CHUNK_ALIGN == 0
        assert B * H * chunks >= kern.FILL_ITEMS
        assert rows * 2 * Dh * dt.itemsize >= kern.MIN_CHUNK_BYTES
    assert kern.plan(*LONG) == (384, 11)
    assert kern.plan(*WINDOWED) == (128, 16)
    # gemma3-4b's local layers: chunks sized over the 1,024-row window,
    # so that every chunk of a row at pos >= 1,023 holds admitted rows
    assert kern.plan(*WINDOWED, 1024) == (64, 16)
    assert len(kern.chunk_ranges(2048, 2047, 1024, 64, 16)[0]) == 16
    # a pure function of the shapes and the window
    assert kern.plan(*LONG) == kern.plan(8, 4096, 24, 128, torch.bfloat16)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_split_threshold(dt):
    """Few (b, h) rows split a context longer than one least chunk (64 KB
    of K and V), and never a shorter one; the gpu tests run both sides."""
    least = kern.MIN_CHUNK_BYTES // (2 * 128 * dt.itemsize)
    assert least % kern.CHUNK_ALIGN == 0
    assert kern.plan(2, least, 4, 128, dt) == (least, 1)
    assert kern.plan(2, least + 1, 4, 128, dt) == (least, 2)
    assert kern.plan(64, 10 ** 4, 24, 128, dt).chunks == 1


def _emulated(q, k, v, pos, window, rows, chunks, drop_last=False):
    """The kernel's split-and-merge arithmetic in fp32: per chunk of
    ``chunk_ranges`` its max m, normalizer l and sums o, then the chunks
    merged in chunk order (``drop_last``: the merge misses the last chunk,
    the fault ``chip_smoke.py`` plants in the kernel's source)."""
    B, C, H, Dh = k.shape
    scale = 1.0 / math.sqrt(Dh)
    out = torch.empty(B, H, Dh)
    for b in range(B):
        ranges, empty = kern.chunk_ranges(C, int(pos[b]), window, rows,
                                          chunks)
        if drop_last and len(ranges) > 1:
            ranges = ranges[:-1]
        for h in range(H):
            parts = []
            for lo, hi in ranges:
                kc, vc = k[b, lo:hi + 1, h], v[b, lo:hi + 1, h]
                s = torch.full((hi - lo + 1,), kern.ref.NEG_INF) if empty \
                    else (kc @ q[b, h]) * scale
                m = s.max()
                p = torch.exp(s - m)
                parts.append((m, p.sum(), p @ vc))
            M = max(m for m, _, _ in parts)
            L = sum(l * torch.exp(m - M) for m, l, _ in parts)
            O = sum(o * torch.exp(m - M) for m, _, o in parts)
            out[b, h] = O / L
    return out


@pytest.mark.parametrize("window", [None, 9, 200])
def test_split_and_merge_matches_plain(window):
    """The merge, with the split forced on (8-row chunks over the window's
    span; the empty range's 150 rows in as many), against the plain
    version at fp32 rtol 1e-5; a merge that drops the last chunk does not
    pass."""
    B, C, H, Dh = 4, 150, 2, 32
    q, k, v = (torch.as_tensor(a) for a in _case(B, C, H, Dh, seed=3))
    pos = torch.tensor([-2, 40, 149, 300], dtype=torch.int32)
    want = kern.ref.decode_attention(q, k, v, pos, window)
    chunks = -(-min(C, window or C) // 8)
    got = _emulated(q, k, v, pos, window, 8, chunks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    bad = _emulated(q, k, v, pos, window, 8, chunks, drop_last=True)
    assert not torch.allclose(bad, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# routes, shared memory, the C interface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dh,dt,want", [
    (128, torch.bfloat16, (16, 16, 1)), (128, torch.float32, (16, 32, 1)),
    (256, torch.bfloat16, (16, 32, 1)), (256, torch.float32, (16, 32, 2)),
    (64, torch.float32, (16, 16, 1)), (16, torch.bfloat16, (16, 4, 1)),
    (60, torch.float32, (16, 16, 1)), (512, torch.bfloat16, (16, 32, 2)),
    # rows of more than 64 vectors take slices of 64
    (512, torch.float32, (16, 32, 2)), (520, torch.bfloat16, (16, 32, 2)),
    # rows 16-byte vectors do not divide take the widest that do
    (60, torch.bfloat16, (8, 16, 1)), (6, torch.float32, (8, 4, 1)),
    (61, torch.bfloat16, (2, 32, 2)), (61, torch.float32, (4, 32, 2))])
def test_route(dh, dt, want):
    q = torch.zeros(2, 3, dh, dtype=dt)
    k = torch.zeros(2, 5, 3, dh, dtype=dt)
    assert kern.route(q, k, k) == want


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_route_narrows_the_vector_for_unaligned_operands(dt):
    k = torch.zeros(2, 6, 3, 128, dtype=dt)
    full = (16, 32 if dt == torch.float32 else 16, 1)
    assert kern.route(k[:, 0], k[:, 1:], k[:, 1:]) == full
    flat = torch.zeros(2 * 5 * 3 * 128 + 1, dtype=dt)[1:].view(2, 5, 3, 128)
    size = flat.element_size()
    want = (size, 32, 2)
    assert kern.route(k[:, 0], flat, flat) == want
    assert kern.route(k[:, 0], k[:, 1:], flat) == want


def test_refusal_keeps_the_first_designs_measure():
    """The refusal is unchanged (C up to 57,720 at Dh = 128); the kernel
    itself takes no shared memory."""
    assert kern.smem_bytes(57_720, 128) <= kern.SMEM_LIMIT
    assert kern.smem_bytes(57_721, 128) > kern.SMEM_LIMIT
    text = SOURCE.read_text()
    assert "__shared__" not in text
    assert "args, 0, s);" in text


def test_c_interface_matches_the_wrapper():
    """The ctypes argument types name every parameter of
    ``decode_attention_launch``, and the merge takes no float atomics."""
    text = SOURCE.read_text()
    sig = re.search(r'extern "C" int decode_attention_launch\((.*?)\)\s*\{',
                    text, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]

    class Lib:
        class decode_attention_launch:  # noqa: N801 (a C symbol)
            pass

    fn = kern.entry(Lib)
    assert len(fn.argtypes) == len(params) == 20
    kinds = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}
    for p, t in zip(params, fn.argtypes):
        ctype = re.sub(r"\s*\w+$", "", p).replace("const ", "").replace(
            " ", "")
        assert t.__name__ == kinds[ctype], p
    assert re.findall(r"atomic\w+\(([^,]+),", text) == ["ticket"]


# ---------------------------------------------------------------------------
# chip_smoke.py's planted merge fault and its timing helpers
# ---------------------------------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_planted_merge_fault_drops_the_last_chunk():
    mod = _smoke()
    text = SOURCE.read_text()
    bad = mod.dropped_chunk_source(text)
    head = re.search(r"void merge_chunks\(.*?\{\n  --n_used;\n", bad, re.S)
    assert head and bad.replace("\n  --n_used;", "", 1) == text


def test_cold_copies_exceed_twice_the_l2():
    """The copies a cold timing rotates over: between two calls on one
    copy the others read more than twice the L2."""
    mod = _smoke()
    assert mod.cold_copies(30_670_000) == 5
    assert mod.cold_copies(403_000_000) == 2
    for b in (1, 10 ** 6, 30_670_000, 5 * 10 ** 7, 2 * mod.L2_BYTES):
        assert (mod.cold_copies(b) - 1) * b > 2 * mod.L2_BYTES
