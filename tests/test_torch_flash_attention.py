"""The port's prefill flash attention against the reference package on the
same seeded numpy inputs: ``kernels.attention.flash_attention`` (on the CPU
its plain version, the online-softmax loop of ``ref.py``),
``layers.attention(impl="cuda")`` and ``layers.attention_chunked`` against
the reference's Pallas ``flash_attention`` in interpret mode at the cases
and tolerances of ``test_attention_rwkv_kernels.py`` (rtol/atol 2e-4 in
fp32, 3e-2 in bf16) and at shapes its divisor search never sees; a row that
admits no key (the mean of V on both sides); ``q_offset``, which the port
keeps and the reference's ``attention(impl="pallas")`` drops; the typed
limit; ``chip_smoke.py``'s fp32 parity check against CPU emulations of the
kernel's three tf32 products and of one; and a reduced gemma3-4b forward
with ``attention_impl="chunked"`` against the reference's own chunked
forward. On the CPU nothing launches; the CUDA kernel runs in
``test_torch_gpu.py`` and ``chip_smoke.py``."""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.kernels.attention import flash_attention as rflash
from repro.models import layers as rlayers
from repro.models.transformer import TransformerLM as RTransformerLM
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.attention import (FlashAttentionLimitError,
                                           flash_attention,
                                           flash_attention_ref)
from repro_torch.models import TransformerLM, lm_params_from_reference
from repro_torch.models import layers

F32_TOL = 2e-4
BF16_TOL = 3e-2
ROOT = Path(__file__).resolve().parents[1]


def _qkv(b, sq, sk, hq, hkv, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, dh)).astype(dtype)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(dtype)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(dtype)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == ml_dtypes.bfloat16 else torch.float32)
        for a in arrays]


def _port_routes(q, k, v, **kw):
    """The port's three routes to the kernel (its plain version here)."""
    before = flash_attention.launches
    outs = {"flash_attention": flash_attention(q, k, v, **kw),
            "attention_cuda": layers.attention(q, k, v, impl="cuda", **kw),
            "attention_chunked": layers.attention_chunked(q, k, v, **kw)}
    assert flash_attention.launches == before     # CPU: plain, no launch
    return outs


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the reference kernel's own cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    dict(b=1, s=256, hq=4, hkv=4, dh=64),            # MHA
    dict(b=2, s=128, hq=8, hkv=2, dh=32),            # GQA 4:1
    dict(b=1, s=512, hq=2, hkv=1, dh=64),            # MQA
], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_kernel(cfg, causal):
    q, k, v = _qkv(cfg["b"], cfg["s"], cfg["s"], cfg["hq"], cfg["hkv"],
                   cfg["dh"], seed=cfg["s"] + cfg["hq"])
    want = rflash(q, k, v, causal=causal, bq=64, bk=64, interpret=True)
    for out in _port_routes(*_torch(q, k, v), causal=causal).values():
        assert out.dtype == torch.float32 and out.shape == q.shape
        _close(out, want, F32_TOL)


def test_matches_reference_kernel_sliding_window():
    q, k, v = _qkv(1, 256, 256, 4, 4, 32, seed=3)
    want = rflash(q, k, v, causal=True, window=64, bq=64, bk=64,
                  interpret=True)
    for out in _port_routes(*_torch(q, k, v), causal=True,
                            window=64).values():
        _close(out, want, F32_TOL)


def test_matches_reference_kernel_bf16():
    q, k, v = _qkv(1, 128, 128, 4, 4, 64, seed=4, dtype=ml_dtypes.bfloat16)
    want = rflash(q, k, v, causal=True, bq=64, bk=64, interpret=True)
    for out in _port_routes(*_torch(q, k, v), causal=True).values():
        assert out.dtype == torch.bfloat16
        _close(out, want, BF16_TOL)


# ---------------------------------------------------------------------------
# shapes the reference's divisor search never sees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk,dh,causal,window", [
    (97, 97, 64, True, None),         # no useful divisor
    (97, 97, 96, True, 32),           # phi-3-vision's head
    (40, 97, 112, False, 32),         # kimi-k2's head, Sq != Sk
    (97, 40, 256, True, 32),          # gemma3's head, Sq > Sk
    (64, 160, 128, True, None),       # Sq < Sk
], ids=["ragged", "dh96", "dh112-sq<sk", "dh256-sq>sk", "dh128-sq<sk"])
def test_matches_reference_kernel_at_odd_shapes(sq, sk, dh, causal, window):
    """GQA 2:1; the reference kernel shrinks bq and bk to divisors (97 is
    prime), the port masks its ragged tiles."""
    q, k, v = _qkv(2, sq, sk, 4, 2, dh, seed=sq * sk + dh)
    want = rflash(q, k, v, causal=causal, window=window, interpret=True)
    xla = rlayers.attention_xla(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(np.asarray(want), np.asarray(xla),
                               rtol=F32_TOL, atol=F32_TOL)
    for out in _port_routes(*_torch(q, k, v), causal=causal,
                            window=window).values():
        _close(out, want, F32_TOL)


def test_a_row_that_admits_no_key_gets_the_mean_of_v():
    """Non-causal with a window and Sq > Sk: rows q_pos >= Sk - 1 + window
    admit no key. Every score is -1e30, so the reference kernel and
    attention_xla give those rows the mean of V; so does the port."""
    q, k, v = _qkv(1, 96, 32, 4, 2, 64, seed=7)
    kw = dict(causal=False, window=16)
    want = np.asarray(rflash(q, k, v, interpret=True, **kw))
    xla = np.asarray(rlayers.attention_xla(q, k, v, **kw))
    mean = np.repeat(v.mean(axis=1), 2, axis=1)           # (1, Hq, Dh)
    empty = np.arange(96) >= 32 - 1 + 16
    assert empty.any() and not empty.all()
    for ref_out in (want, xla):
        np.testing.assert_allclose(
            ref_out[:, empty], np.broadcast_to(mean[:, None],
                                               ref_out[:, empty].shape),
            rtol=1e-5, atol=1e-5)
    for out in _port_routes(*_torch(q, k, v), **kw).values():
        _close(out, want, F32_TOL)
        _close(out, xla, F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, 24)])
def test_q_offset_is_kept(causal, window):
    """A 16-row chunk at positions 40..55 against 56 keys, as a chunked
    prefill would call it, against the reference's attention_xla with the
    same q_offset; the reference's impl="pallas" drops q_offset and
    computes the chunk as if it sat at positions 0..15 (a reference-side
    fault), which the port's impl="cuda" does not."""
    q, k, v = _qkv(2, 16, 56, 4, 2, 32, seed=11)
    kw = dict(causal=causal, window=window)
    want = np.asarray(rlayers.attention_xla(q, k, v, q_offset=40, **kw))
    for out in _port_routes(*_torch(q, k, v), q_offset=40, **kw).values():
        _close(out, want, F32_TOL)
    dropped = np.asarray(rlayers.attention(q, k, v, q_offset=40,
                                           impl="pallas", **kw))
    at_zero = np.asarray(rlayers.attention_xla(q, k, v, **kw))
    np.testing.assert_allclose(dropped, at_zero, rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(dropped - want).max() > 0.1


def test_heads_the_kernel_cannot_tile_are_refused_on_every_device():
    """Wider than 256 (the output tile's registers) or not a multiple of 4
    (rows load as 4-element groups): FlashAttentionLimitError on the CPU
    as on the card; Hq not a multiple of Hkv: ValueError."""
    q = torch.zeros(1, 4, 2, 288)
    with pytest.raises(FlashAttentionLimitError, match="288"):
        flash_attention(q, q, q)
    with pytest.raises(FlashAttentionLimitError):
        layers.attention(q, q, q, impl="cuda")
    q = torch.zeros(1, 4, 2, 62)
    with pytest.raises(FlashAttentionLimitError, match="multiples of 4"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 256)
    assert flash_attention(q, q, q).shape == (1, 4, 2, 256)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8),
                        torch.zeros(1, 4, 2, 8))


def test_plain_version_takes_any_chunk():
    """attention_chunked's bk is a CPU-side argument: any chunk gives the
    same function."""
    q, k, v = _torch(*_qkv(1, 50, 50, 2, 1, 16, seed=2))
    want = flash_attention_ref(q, k, v, window=9)
    for bk in (1, 7, 50, 4096):
        got = layers.attention_chunked(q, k, v, window=9, bk=bk)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_source_is_a_hand_written_hopper_kernel():
    """The CUDA source names the TPU kernel it replaces and its bound (the
    tf32 tensor cores' 495 TFLOP/s), takes its products as tf32 mma.sync
    MMAs and stages its tiles with cp.async (both through the shared
    header it includes), builds with the others, and calls no library
    kernel and no atomic."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert "repro/kernels/attention/kernel.py::" in src
    assert "495 TFLOP/s" in src
    assert "flash_attention" in build.KERNELS
    headers = re.findall(r'#include "([^"]+)"', src)
    assert headers == ["mma_tf32.cuh"]
    whole = src + "".join((build.CSRC / h).read_text() for h in headers)
    assert re.search(r"mma\.sync\.aligned\.m16n8k8\.\S*tf32", whole)
    assert "cp.async" in whole and "cvt.rna.tf32.f32" not in whole
    for call in ("cublas", "cudnn", "scaled_dot_product", "atomicadd",
                 "torch"):
        assert call not in whole.lower()
    assert not re.search(r"\b(atom|red)\.", whole)
    # the split lives in the header alone
    wkv = (build.CSRC / "wkv.cu").read_text()
    assert '#include "mma_tf32.cuh"' in wkv
    for body in (src, wkv):
        assert "0xffffe000u" not in body and "mma.sync.aligned" not in body


def test_shared_memory_fits_a_block_at_every_head():
    """One block's shared memory at every head width the wrapper takes,
    fp32 and bf16, fits Hopper's 227 KB."""
    from repro_torch.kernels.attention import flash
    assert flash.smem_bytes(256) == (160 * 272 + 32 * 260) * 4 == 207_360
    assert flash.smem_bytes(256, 2) == (160 * 272 + 32 * 264) * 2
    assert max(flash.smem_bytes(dh, size) for dh in range(4, 257, 4)
               for size in (2, 4)) <= flash.SMEM_LIMIT == 232_448


def test_backward_source_takes_its_products_on_the_tensor_cores():
    """The backward's CUDA source takes bf16 products as m16n8k16 MMAs fed
    by ldmatrix (and ldmatrix.trans for the transposed operands), fp32 ones
    as the shared header's tf32 MMAs, stages tiles with cp.async, and calls
    no library kernel and no atomic."""
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "flash_attention_bwd" in build.KERNELS
    assert re.findall(r'#include "([^"]+)"', src) == ["mma_tf32.cuh"]
    assert re.search(r"mma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16", src)
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    assert "mma_tf32(" in src and "cp_async16(" in src
    whole = src + (build.CSRC / "mma_tf32.cuh").read_text()
    for call in ("cublas", "cudnn", "scaled_dot_product", "atomicadd",
                 "torch"):
        assert call not in whole.lower()
    assert not re.search(r"\b(atom|red)\.", whole)


def _source_plan(dh, size):
    """The backward source's ``Plan<T, DP>`` at a head of ``dh`` with
    ``size``-byte elements, evaluated from the source's own text: each of
    its ``static constexpr`` constants and functions, with C++'s
    operators, casts and ternaries read as Python's. So the test holds the
    tiling the kernel compiles, not a copy of it."""
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    env = {name: int(val) for name, val in re.findall(
        r"^constexpr int(?:64_t)? (kR|kSmemSM) = (\d+);", src, re.M)}
    assert set(env) == {"kR", "kSmemSM"}
    env["DP"] = -(-dh // 64) * 64
    body = re.search(r"struct Plan \{\n(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//.*", "", body)

    def py(expr):
        expr = expr.replace("static_cast<int>(sizeof(T))", str(size))
        expr = re.sub(r"static_cast<int64_t>\(sizeof\(T\)\)", str(size),
                      expr)
        expr = expr.replace("sizeof(T)", str(size))
        expr = re.sub(r"(\d)LL\b", r"\1", expr)
        expr = expr.replace("&&", " and ").replace("||", " or ")
        expr = expr.replace("/", "//")
        cond = re.fullmatch(r"(.+?)\?(.+):(.+)", expr, re.S)
        if cond:
            expr = f"({cond[2]}) if ({cond[1]}) else ({cond[3]})"
        return " ".join(expr.split())

    for m in re.finditer(
            r"static constexpr \w+ (\w+)(?: = (.*?);|\((.*?)\) \{\s*"
            r"return (.*?);\s*\})", body, re.S):
        name, value, args, ret = m.groups()
        if value is not None:
            env[name] = eval(py(value), {}, env)
        else:
            params = ", ".join(a.split()[-1] for a in args.split(","))
            env[name] = eval(f"lambda {params}: {py(ret)}", env)
    return env


@pytest.mark.parametrize("size", [2, 4])
def test_backward_shared_memory_fits_a_block_at_every_head(size):
    """Both backward passes' shared memory (the source's ``Plan``, read by
    ``_source_plan``) fits Hopper's 227 KB at every head width the wrapper
    takes, Dh 4 to 256 in steps of 4, and the blocks a pass puts on an SM
    fit its 228 KB together (1 KB reserved a block); the tiles shrink with
    Dh in fp32 only; the wrapper's grid takes the source's resident tile."""
    from repro_torch.kernels.attention import flash
    plans = set()
    for dh in range(4, 257, 4):
        p = _source_plan(dh, size)
        for nbytes, blocks in ((p["kSmemDkdv"], p["kBlocks2"]),
                               (p["kSmemDq"], p["kBlocks4"])):
            assert nbytes <= flash.SMEM_LIMIT == 232_448
            assert (nbytes + 1024) * blocks <= p["kSmemSM"] == 233_472
        plans.add((p["DP"], p["kS"]))
    assert flash.BWD_TILE == p["kR"] == 64
    # bf16 at Dh 256, one block an SM and one buffer: K, V (64 x 264), Q,
    # dO (64 x 264), P, dS as hi and lo planes (4 x 64 x 72), lse and D
    # (2 x 64)
    p = _source_plan(256, 2)
    assert p["kSmemDkdv"] == \
        (2 * 64 * 264 + 2 * 64 * 264 + 4 * 64 * 72) * 2 + 2 * 64 * 4
    # bf16 at starcoder2-3b's Dh 128: two blocks an SM, one buffer; at
    # LM100M's Dh 64 two buffers
    for dh, want in ((128, (2, 1, 2, 1)), (64, (2, 2, 2, 2))):
        p = _source_plan(dh, 2)
        assert (p["kBlocks2"], p["kStages2"], p["kBlocks4"],
                p["kStages4"]) == want
    want = {(64, 64), (128, 64), (192, 64), (256, 64)} if size == 2 else \
        {(64, 64), (128, 32), (192, 32), (256, 32)}
    assert plans == want


def test_planted_first_head_fault_changes_only_the_query_head_sum():
    """``chip_smoke.first_head_source`` finds the in-order sum over a KV
    head's query heads once in the backward's source, in the reduce
    kernel, and changes nothing else."""
    mod, _ = _smoke()
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    bad = mod.first_head_source(text)
    assert bad != text
    assert bad.replace("r < 1; ++r", "r < rep; ++r", 1) == text
    body = re.search(r"flash_bwd_reduce\(.*?\n}\n", bad, re.S).group(0)
    assert "for (int r = 0; r < 1; ++r) {" in body


# ---------------------------------------------------------------------------
# chip_smoke.py's fp32 parity against emulated tf32 products
# ---------------------------------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    smoke = mod.Smoke()
    smoke.dev = torch.device("cpu")
    return mod, smoke


def _emulated(shape, seed, **kw):
    """The float64 attention with the limit's terms, the plain version,
    and the emulations of three tf32 products and of one."""
    mod, smoke = _smoke()
    kw = dict(dict(window=None, q_offset=0), **kw)
    q, k, v = _torch(*_qkv(*shape, seed=seed))
    want, tmax, a, count = smoke.flash_terms(q, k, v, **kw)
    plain = flash_attention_ref(q, k, v, **kw)
    three, one = (smoke.flash_tf32_only(q, k, v, products=n, **kw)
                  for n in (3, 1))
    return mod, smoke, (want, tmax, a, count), plain, three, one


@pytest.mark.parametrize("shape,kw", [
    ((1, 97, 160, 2, 1, 256), dict(causal=True, q_offset=63)),
    ((1, 200, 200, 4, 2, 256), dict(causal=True, window=64)),
], ids=["ragged-q_offset", "window"])
def test_three_tf32_products_pass_the_limit_and_fp32_parity(shape, kw):
    """The kernel's fp32 route emulated on the CPU (hi hi + hi lo + lo hi
    of tf32 operands) passes the attention limit and parity with the plain
    version at Dh = 256, Sq ragged against the 64-row tile."""
    mod, smoke, (want, tmax, a, count), plain, three, _ = _emulated(
        shape, seed=21, **kw)
    assert smoke.flash_within(three, want, tmax, a, count, 0.0)[0]
    assert smoke.flash_within(plain, want, tmax, a, count, 0.0)[0]
    ok, ratio = mod.parity(three, plain, want)
    assert ok and ratio < 0.5
    assert mod.parity(plain, plain, want) == (True, 1 / mod.PARITY)


def test_one_tf32_product_fails_fp32_parity_where_the_limit_cannot():
    """One tf32 product a product (B = 1, S = 1,024, Hq 2, Hkv 1, Dh 256,
    causal): the attention limit rejects it only through the first rows,
    which admit few keys, and passes it within 1.5x on the rows with 512
    keys or more; parity with the plain version rejects it by more than
    CONTROL_MARGIN everywhere."""
    mod, smoke, (want, tmax, a, count), plain, three, one = _emulated(
        (1, 1024, 1024, 2, 1, 256), seed=0, causal=True)
    long = count >= 512
    r_all = smoke.flash_within(one, want, tmax, a, count, 0.0)[2]
    r_long = smoke.flash_within(one[:, long], want[:, long], tmax[:, long],
                                a[:, long], count[long], 0.0)[2]
    assert r_all > 1 and r_long < 1.5
    ok, par = mod.parity(one, plain, want)
    assert not ok and par >= mod.CONTROL_MARGIN
    ok, par_long = mod.parity(one[:, long], plain[:, long], want[:, long])
    assert not ok and par_long >= mod.CONTROL_MARGIN
    assert mod.parity(three, plain, want)[0]


# ---------------------------------------------------------------------------
# the path: a reduced gemma3-4b forward with attention_impl="chunked"
# ---------------------------------------------------------------------------
def test_gemma3_chunked_forward_matches_reference(monkeypatch):
    """Reduced gemma3-4b (6 layers, 5:1 local:global, window 16) with the
    reference's PRNGKey(0) weights carried across, fp32 activations, 40
    tokens (past the window), attention_impl="chunked" on both sides, at
    test_torch_models.py's forward tolerance (rtol/atol 1e-5)."""
    rcfg = dataclasses.replace(rget_config("gemma3-4b").reduced(),
                               activation_dtype="float32",
                               attention_impl="chunked")
    cfg = dataclasses.replace(get_config("gemma3-4b").reduced(),
                              activation_dtype="float32",
                              attention_impl="chunked")
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    toks = np.random.default_rng(5).integers(0, cfg.vocab,
                                             (2, 40)).astype(np.int32)
    want, _ = rmodel.forward(rparams, {"tokens": jnp.asarray(toks)})
    from repro_torch.models import blocks
    calls, real = [], blocks.attention_chunked

    def counted(*args, **kw):
        calls.append(kw.get("window"))
        return real(*args, **kw)

    monkeypatch.setattr(blocks, "attention_chunked", counted)
    got, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
    assert calls == [16] * 5 + [None]             # 5 local, 1 global
    assert got.shape == (2, 40, model.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain, _ = TransformerLM(dataclasses.replace(
        cfg, attention_impl="naive")).forward(
        params, {"tokens": torch.as_tensor(toks)})
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
