"""The port's serving path against the reference's (``test_serving.py``):
the paged KV pool, every ``PagedAttnDecode`` level against the
reference's ``xla`` level, the generated attention kernel's Triton source
under the CPU emulator of ``tests/test_torch_grid.py`` against its plain
block program, greedy streams token-identical to the reference
``Scheduler`` (reduced starcoder2-3b, gemma3-4b and llama4-scout-17b-a16e
with the reference's weights carried across), the serving step's grid-kernel count and names
equal to the reference's, chunked prefill, the compile-cache bucket reuse
and sampling. Everything runs on the CPU (``device="cpu"``): each kernel
takes its plain version; the card runs them in ``test_torch_gpu.py`` and
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.frontends.api import Program as RProgram
from repro.library import PagedAttnDecode as RPagedAttnDecode
from repro.models.transformer import TransformerLM as RTransformerLM
from repro.pipeline import lower as rlower
from repro.pipeline.cache import CompilationCache as RCompilationCache
from repro.serving import Scheduler as RScheduler
from repro_torch import programs
from repro_torch.configs import get_config
from repro_torch.core.sdfg import Tasklet
from repro_torch.models import TransformerLM, lm_params_from_reference
from repro_torch.pipeline import lower
from repro_torch.pipeline.cache import CompilationCache
from repro_torch.serving import (KVPagePool, PageError, Scheduler,
                                 decode_pipeline)
from repro_torch.serving import compile as serving_compile

from test_torch_grid import _emulated_launch


def _models(arch, f32=True):
    """The reference model and PRNGKey(0) weights, and the port's model
    with the same weights."""
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    if f32:
        rcfg = dataclasses.replace(rcfg, activation_dtype="float32")
        cfg = dataclasses.replace(cfg, activation_dtype="float32")
    rmodel, model = RTransformerLM(rcfg), TransformerLM(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_reference(model, jax.tree.map(np.asarray,
                                                          rparams))
    return rmodel, rparams, model, params


@pytest.fixture(scope="module")
def starcoder():
    return _models("starcoder2-3b")


@pytest.fixture(scope="module")
def llama4():
    return _models("llama4-scout-17b-a16e")


@pytest.fixture(scope="module")
def starcoder_bf16():
    return _models("starcoder2-3b", f32=False)


def _serve(model, params, prompts, new, **kw):
    s = Scheduler(model, params, device="cpu",
                  compile_cache=CompilationCache(), **kw)
    for p in prompts:
        s.submit(list(map(int, p)), new)
    reqs = s.run()
    s.check_invariants()
    return s, [r.tokens_out for r in reqs]


def _rserve(model, params, prompts, new, **kw):
    s = RScheduler(model, params, compile_cache=RCompilationCache(), **kw)
    for p in prompts:
        s.submit(list(map(int, p)), new)
    reqs = s.run()
    return s, [r.tokens_out for r in reqs]


# ---------------------------------------------------------------------------
# KVPagePool (test_serving.py::TestPagePool)
# ---------------------------------------------------------------------------
class TestPagePool:
    def _pool(self, n_pages=8, page_size=4):
        return KVPagePool({0: (2, 8)}, n_pages, page_size, device="cpu")

    def test_pool_runs_on_the_card_unless_given_a_device(self):
        if torch.cuda.is_available():
            assert KVPagePool({0: (2, 8)}, 8, 4).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                KVPagePool({0: (2, 8)}, 8, 4)

    def test_null_page_never_allocated(self):
        pool = self._pool()
        pages = pool.alloc(pool.num_free, reserved=False)
        assert 0 not in pages
        assert len(pages) == pool.n_pages - 1

    def test_reserve_alloc_free_roundtrip(self):
        pool = self._pool()
        pool.reserve(3)
        assert pool.available == 7 - 3
        pages = pool.alloc(2)
        assert pool._reserved == 1
        pool.free(pages)
        pool.unreserve(1)
        assert pool.num_free == 7 and pool.available == 7

    def test_overcommit_rejected(self):
        pool = self._pool()
        pool.reserve(5)
        with pytest.raises(PageError):
            pool.reserve(3)
        with pytest.raises(PageError):
            pool.alloc(3, reserved=False)

    def test_double_free_and_null_free_rejected(self):
        pool = self._pool()
        (pg,) = pool.alloc(1, reserved=False)
        pool.free([pg])
        with pytest.raises(PageError):
            pool.free([pg])
        with pytest.raises(PageError):
            pool.free([0])

    def test_write_prefill_pads_to_page(self):
        pool = self._pool()
        pages = pool.alloc(2, reserved=False)
        k = torch.ones((6, 2, 8))  # 6 tokens over 2x4-slot pages
        pool.write_prefill(0, pages, k, 2 * k)
        got = pool.k_pages[0][torch.as_tensor(pages)].reshape(8, 2, 8)
        assert torch.all(got[:6] == 1.0) and torch.all(got[6:] == 0.0)
        assert pool.k_pages[0].dtype == torch.bfloat16

    def test_snapshot_restore_and_seize(self):
        pool = self._pool()
        pages = pool.alloc(2, reserved=False)
        pool.write_prefill(0, pages, torch.full((5, 2, 8), 3.0),
                           torch.full((5, 2, 8), -1.0))
        snap = pool.snapshot()
        other = self._pool()
        other.restore(snap)
        assert torch.equal(other.k_pages[0], pool.k_pages[0])
        assert other.num_free == pool.num_free
        seized = other.seize()
        assert other.num_free == 0 and other.stats()["seized"] == 5
        other.release(seized)
        with pytest.raises(PageError):
            other.release(seized)


# ---------------------------------------------------------------------------
# PagedAttnDecode: every level against the reference's xla level
# ---------------------------------------------------------------------------
def _rattn_program(B, C, H, Dh, window, dtype):
    p = RProgram("decode_attention")
    q = p.input("q", (B, H, Dh), dtype)
    k = p.input("k", (B, C, H, Dh), dtype)
    v = p.input("v", (B, C, H, Dh), dtype)
    pos = p.input("pos", (B,), "int32")
    out = p.add_op(RPagedAttnDecode("attn0", window=window),
                   {"q": q, "k": k, "v": v, "pos": pos},
                   out_shapes={"out": (B, H, Dh)}, out_dtypes={"out": dtype})
    p.output("out", out)
    return p.finalize()


def _attn_inputs(B, C, H, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, C, H, Dh)).astype(np.float32)
            for _ in range(2))
    pos = rng.integers(0, C, B).astype(np.int32)
    pos[0] = 1
    return q, k, v, pos


@pytest.mark.parametrize("level", ["torch", "cuda", "generic", "flash"])
@pytest.mark.parametrize("shape", [(3, 40, 5, 64, None), (20, 32, 4, 32, 6)])
def test_paged_attn_levels_match_reference_xla(level, shape):
    B, C, H, Dh, window = shape
    q, k, v, pos = _attn_inputs(B, C, H, Dh, seed=B + C)
    rc = rlower(_rattn_program(B, C, H, Dh, window, "float32")).compile(
        backend="jnp", expansion_level="xla", cache=None)
    want = np.asarray(rc(q=q, k=k, v=v, pos=pos)["out"])
    sdfg = programs.decode_attention_program(B, C, H, Dh, window)
    c = lower(sdfg).compile("cuda", expansion_level=level, cache=None,
                            device="cpu")
    t = torch.as_tensor
    got = c(q=t(q), k=t(k), v=t(v), pos=t(pos))["out"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    kernels = c.report["grid_kernels"]
    assert kernels == (["attn0_grid_tiled"] if level in ("cuda", "generic")
                       else [])


@pytest.mark.parametrize("shape", [(3, 40, 5, 64, None, "float32"),
                                   (20, 100, 4, 128, 9, "float32"),
                                   (4, 33, 2, 64, None, "bfloat16")])
def test_generated_attention_source_matches_plain(shape):
    """The Triton source of the ``cuda`` level's row kernel, run by the
    CPU emulator, against the plain block program (one, several and a
    partial chunk of the context; a partial tile of b at B = 20)."""
    B, C, H, Dh, window, dt = shape
    sdfg = programs.decode_attention_program(B, C, H, Dh, window, dt)
    c = lower(sdfg).compile("cuda", cache=None, device="cpu")
    (kernel,) = {id(n.map): n.map.annotations["grid_kernel"]
                 for st in c.sdfg.states for n in st.nodes
                 if "grid_kernel" in getattr(getattr(n, "map", None),
                                             "annotations", {})}.values()
    assert kernel.desc.row and kernel.desc.n_kept * kernel.desc.n_lanes \
        >= B * H
    compile(kernel.source, "<generated>", "exec")
    tdt = getattr(torch, dt)
    q, k, v, pos = (torch.as_tensor(a) for a in _attn_inputs(B, C, H, Dh,
                                                             seed=C))
    q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
    want = c(q=q, k=k, v=v, pos=pos)["out"]
    outs = {"out": torch.zeros(B, H, Dh, dtype=tdt)}
    _emulated_launch(kernel.desc, kernel.source,
                     {"q": q, "k": k, "v": v, "pos": pos}, outs)
    tol = 2.0 ** -7 if dt == "bfloat16" else 1e-5
    torch.testing.assert_close(outs["out"].float(), want.float(), rtol=tol,
                               atol=tol)


def _attn_kernel(c):
    (kernel,) = {id(n.map): n.map.annotations["grid_kernel"]
                 for st in c.sdfg.states for n in st.nodes
                 if "grid_kernel" in getattr(getattr(n, "map", None),
                                             "annotations", {})}.values()
    return kernel


#: positions that cross the fused loop's range: an all-masked row (-1, the
#: mean of V), past the context, at and one past a 32-row chunk edge, the
#: last row and one past it, and, with a window, a window whose low end is
#: past 0 and one that admits nothing (C + 20)
EDGE_POS = (-1, 20, 31, 32, 63, 64, 0, 9, 99, 100, 103, 120, 33)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(18, 100, 4, 128, 9),
                                   (9, 100, 3, 128, None),
                                   (6, 64, 2, 128, 5), (18, 64, 4, 64, None)])
def test_generated_attention_source_at_mask_edges(shape, dt):
    """The fused attention source (one pass, the loop range from pos),
    run by the CPU emulator, against the plain block program and the
    reference's ``PagedAttnDecode`` at its ``pallas`` level in interpret
    mode on the same numpy inputs (bf16 inputs rounded to bf16 for both):
    several 32-row chunks (Dh = 128) and a context of one chunk (C = 64
    at Dh = 64), with and without a window, partial b tiles at B = 18,
    and positions at every edge of the range (``EDGE_POS``, relative to C
    where past it)."""
    B, C, H, Dh, window = shape
    sdfg = programs.decode_attention_program(B, C, H, Dh, window, dt)
    c = lower(sdfg).compile("cuda", cache=None, device="cpu")
    kernel = _attn_kernel(c)
    tdt = getattr(torch, dt)
    q, k, v, _ = (torch.as_tensor(a).to(tdt)
                  for a in _attn_inputs(B, C, H, Dh, seed=C + B))
    pos = np.resize(np.asarray(EDGE_POS), B)
    pos = np.where(pos >= 99, pos - 100 + C, pos).astype(np.int32)
    tpos = torch.as_tensor(pos)
    want = c(q=q, k=k, v=v, pos=tpos)["out"]
    outs = {"out": torch.zeros(B, H, Dh, dtype=tdt)}
    _emulated_launch(kernel.desc, kernel.source,
                     {"q": q, "k": k, "v": v, "pos": tpos}, outs)
    tol = 2.0 ** -7 if dt == "bfloat16" else 1e-5
    torch.testing.assert_close(outs["out"].float(), want.float(), rtol=tol,
                               atol=tol)
    rc = rlower(_rattn_program(B, C, H, Dh, window, "float32")).compile(
        backend="pallas", cache=None)
    ref = np.asarray(rc(q=q.float().numpy(), k=k.float().numpy(),
                        v=v.float().numpy(), pos=pos)["out"])
    np.testing.assert_allclose(outs["out"].float().numpy(), ref, rtol=tol,
                               atol=tol)


def _defs(src):
    """name -> the names its assignments read, over the whole source."""
    import re
    out = {}
    for line in src.splitlines():
        m = re.match(r"\s*(\w+) = (.*)", line)
        if m:
            out.setdefault(m.group(1), set()).update(
                re.findall(r"[A-Za-z_]\w*", m.group(2)))
    return out


def _reads(defs, names, target):
    """Whether any of ``names`` depends on ``target`` through ``defs``."""
    seen, todo = set(), list(names)
    while todo:
        n = todo.pop()
        if n == target:
            return True
        if n not in seen:
            seen.add(n)
            todo.extend(defs.get(n, ()))
    return False


@pytest.mark.parametrize("C", [512, 64, 32])
def test_attention_source_loads_k_once_over_the_mask_range(C):
    """The serving attention source (B = 64, H = 24, Dh = 128, bf16) loads
    K once, inside the one loop over 32-row chunks, whose bounds and whose
    chunk mask come from pos (C = 512, the serving buckets' C = 64, and a
    context of one chunk, C = 32); V once beside it."""
    import re
    sdfg = programs.decode_attention_program(64, C, 24, 128, None,
                                             "bfloat16")
    src = _attn_kernel(lower(sdfg).compile("cuda", cache=None,
                                           device="cpu")).source
    lines = src.splitlines()
    k_loads = [ln for ln in lines if "tl.load(in_1 " in ln]
    v_loads = [ln for ln in lines if "tl.load(in_2 " in ln]
    loops = [ln for ln in lines if ln.lstrip().startswith("for ")]
    assert len(k_loads) == len(v_loads) == 1
    defs = _defs(src)
    mask = re.search(r"mask=(.*), other=", k_loads[0]).group(1)
    assert _reads(defs, re.findall(r"[A-Za-z_]\w*", mask), "in_3")  # pos
    (loop,) = loops
    assert k_loads[0].startswith(" " * 8)       # inside the loop
    bounds = re.search(r"range\((.*)\):", loop).group(1)
    assert _reads(defs, re.findall(r"[A-Za-z_]\w*", bounds), "in_3")


def test_row_body_without_the_mask_form_walks_the_whole_axis(monkeypatch):
    """A softmax argument masked at a literal above -1e30 (here -1.0) is
    not the mask form: the fused loop walks all C = 100 positions from 0,
    and the source still computes the plain block program."""
    from repro_torch.library import attention as lib
    real = lib.vocab
    fake = type("vocab", (), {n: staticmethod(getattr(real, n))
                              for n in dir(real) if not n.startswith("_")})
    fake.where = staticmethod(lambda c, a, b: real.where(
        c, a, -1.0 if b == lib.NEG_INF else b))
    monkeypatch.setattr(lib, "vocab", fake)
    B, C, H, Dh = 5, 100, 2, 128
    sdfg = programs.decode_attention_program(B, C, H, Dh, 9)
    c = lower(sdfg).compile("cuda", cache=None, device="cpu")
    kernel = _attn_kernel(c)
    loops = [ln for ln in kernel.source.splitlines()
             if ln.lstrip().startswith("for ")]
    assert len(loops) == 1 and "in range(0, 100, 32):" in loops[0]
    assert kernel.source.count("tl.load(in_1 ") == 1
    q, k, v, pos = (torch.as_tensor(a)
                    for a in _attn_inputs(B, C, H, Dh, seed=3))
    want = c(q=q, k=k, v=v, pos=pos)["out"]
    outs = {"out": torch.zeros(B, H, Dh)}
    _emulated_launch(kernel.desc, kernel.source,
                     {"q": q, "k": k, "v": v, "pos": pos}, outs)
    torch.testing.assert_close(outs["out"], want, rtol=1e-5, atol=1e-5)


def test_softmax_with_another_consumer_keeps_its_plain_path(monkeypatch):
    """A softmax whose probabilities reach p @ V through another operation
    (here a product by 1.0) is not the one-pass form: the row emitter
    refuses it with a typed reason, so the scope stays on its plain path
    and computes what the fused kernel's program computes."""
    B, C, H, Dh = 5, 64, 2, 128
    q, k, v, pos = (torch.as_tensor(a)
                    for a in _attn_inputs(B, C, H, Dh, seed=5))
    fused = lower(programs.decode_attention_program(B, C, H, Dh)).compile(
        "cuda", cache=None, device="cpu")
    want = fused(q=q, k=k, v=v, pos=pos)["out"]
    from repro_torch.library import attention as lib
    real = lib.vocab
    fake = type("vocab", (), {n: staticmethod(getattr(real, n))
                              for n in dir(real) if not n.startswith("_")})
    fake.softmax = staticmethod(lambda x: real.softmax(x) * 1.0)
    monkeypatch.setattr(lib, "vocab", fake)
    report = {}
    decode_pipeline().run(
        lower(programs.decode_attention_program(B, C, H, Dh)).sdfg,
        report=report)
    assert report["grid_kernels"] == []
    assert report["grid_fallbacks"] == [
        ("attn0_grid_tiled", "row body: a softmax consumed other than by "
                             "p @ V or a sum over its axis")]
    c = lower(programs.decode_attention_program(B, C, H, Dh)).compile(
        "cuda", cache=None, device="cpu")
    torch.testing.assert_close(c(q=q, k=k, v=v, pos=pos)["out"], want,
                               rtol=1e-5, atol=1e-5)


def test_planted_range_fault_fails_the_comparison():
    """The attention source with its range one row short (ending at
    pos - 1), as ``chip_smoke.py`` plants it on the card, no longer
    computes the plain block program."""
    import re
    B, C, H, Dh = 6, 64, 2, 128
    sdfg = programs.decode_attention_program(B, C, H, Dh)
    c = lower(sdfg).compile("cuda", cache=None, device="cpu")
    kernel = _attn_kernel(c)
    bad, n = re.subn(r"(ri\d+) = tl\.minimum\(\1, (\d+)\)",
                     r"\1 = tl.minimum(\1, \2) - 1", kernel.source)
    assert n == 1
    q, k, v, pos = (torch.as_tensor(a)
                    for a in _attn_inputs(B, C, H, Dh, seed=4))
    want = c(q=q, k=k, v=v, pos=pos)["out"]
    outs = {"out": torch.zeros(B, H, Dh)}
    _emulated_launch(kernel.desc, bad, {"q": q, "k": k, "v": v, "pos": pos},
                     outs)
    assert not torch.allclose(outs["out"], want, rtol=1e-3, atol=1e-3)


def test_row_cost_model_counts_one_iteration():
    """GridConversion charges a row kernel one (b, h) iteration's chunks,
    so the full-width serving scope (B = 64, C = 512, H = 24, Dh = 128,
    bf16) converts."""
    sdfg = programs.decode_attention_program(64, 512, 24, 128, None,
                                             "bfloat16")
    low = lower(sdfg)
    from repro_torch.pipeline import PassManager
    report = {}
    decode_pipeline().run(low.sdfg, report=report)
    assert report["grid_kernels"] == ["attn0_grid_tiled"]
    assert report["grid_converted"][0]["vmem_bytes"] < 232_448
    assert not report["grid_skipped"] and not report["grid_fallbacks"]
    assert isinstance(decode_pipeline(dtype_aware_sublanes=True), PassManager)


# ---------------------------------------------------------------------------
# greedy streams against the reference Scheduler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-4b",
                                  "llama4-scout-17b-a16e"])
def test_tokens_match_reference_scheduler(arch):
    """test_serving.py:188's geometry: 4 requests in 4 slots."""
    rmodel, rparams, model, params = _models(arch)
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 6), 0, model.cfg.vocab))
    kw = dict(max_slots=4, page_size=8, n_pages=32, max_model_len=64,
              prefill_chunk=4)
    _, want = _rserve(rmodel, rparams, prompts, 5, **kw)
    s, got = _serve(model, params, prompts, 5, **kw)
    assert got == want
    assert all(st.rung == "grid" for st in s.compiler._steps.values())


def test_padding_lane_matches_reference_scheduler(starcoder):
    """test_serving.py:233: 3 requests in 4 slots (one padding lane)."""
    rmodel, rparams, model, params = starcoder
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (3, 5), 0, model.cfg.vocab))
    kw = dict(max_slots=4, page_size=8, n_pages=32, max_model_len=64,
              prefill_chunk=4)
    _, want = _rserve(rmodel, rparams, prompts, 4, **kw)
    _, got = _serve(model, params, prompts, 4, **kw)
    assert got == want


def test_moe_padding_lane_matches_reference_scheduler(llama4):
    """Reduced llama4-scout (an MoE layer everywhere): 3 requests in 4
    slots. The padding lane's token goes through the router and the
    one-hot dispatch with the live lanes' (its activations are finite, so
    the 0 x its row terms stay 0) and changes no live stream."""
    rmodel, rparams, model, params = llama4
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (3, 5), 0, model.cfg.vocab))
    kw = dict(max_slots=4, page_size=8, n_pages=32, max_model_len=64,
              prefill_chunk=4)
    _, want = _rserve(rmodel, rparams, prompts, 4, **kw)
    s, got = _serve(model, params, prompts, 4, **kw)
    assert got == want
    assert any(B > len(prompts) for B, _ in s.compiler._steps)


def test_moe_step_structure_matches_reference(llama4):
    """The MoE model's compiled step at test_serving.py:206's geometry
    (B = 16, fp32, dtype-aware sublanes): the same buckets, the same grid
    kernels (one attention kernel per layer; the MoE FFN is a whole-array
    tasklet, as in the reference), the same fused regions, no fallback."""
    rmodel, rparams, model, params = llama4
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (16, 6), 0, model.cfg.vocab))
    kw = dict(max_slots=16, page_size=8, n_pages=64, max_model_len=64,
              prefill_chunk=8, dtype_aware_sublanes=True)
    rs, want = _rserve(rmodel, rparams, prompts, 3, **kw)
    s, got = _serve(model, params, prompts, 3, **kw)
    assert got == want
    assert sorted(s.compiler._steps) == sorted(rs.compiler._steps)
    for key, step in s.compiler._steps.items():
        rep, rrep = step.report, rs.compiler._steps[key].report
        assert rep["grid_kernels"] == rrep["grid_kernels"] == [
            f"attn{li}_grid_tiled" for li in range(model.cfg.n_layers)]
        assert rep.get("fused_regions", []) == rrep.get("fused_regions", [])
        assert not rep["grid_fallbacks"] and not rep["grid_skipped"]
        labels = {n.label for st in step.compiled.sdfg.states
                  for n in st.nodes if isinstance(n, Tasklet)}
        assert {f"ffn{li}" for li in range(model.cfg.n_layers)} <= labels


def test_grid_kernels_in_compiled_step_match_reference(starcoder):
    """test_serving.py:206's geometry (B = 16, fp32, dtype-aware
    sublanes): the same tokens and the same grid kernels, one attention
    kernel per layer. The block differs by design: the reference tiles b
    into its 8-row fp32 sublane (block rows 8); the Hopper tile table's
    fp32 rows are 16, so b = 16 stays whole (one program per (b, h) row
    either way in the port: block rows 1)."""
    rmodel, rparams, model, params = starcoder
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (16, 6), 0, model.cfg.vocab))
    kw = dict(max_slots=16, page_size=8, n_pages=64, max_model_len=64,
              prefill_chunk=8, dtype_aware_sublanes=True)
    rs, want = _rserve(rmodel, rparams, prompts, 4, **kw)
    s, got = _serve(model, params, prompts, 4, **kw)
    assert got == want
    assert sorted(s.compiler._steps) == sorted(rs.compiler._steps)
    rep = s.compiler._steps[max(s.compiler._steps)].report
    rrep = rs.compiler._steps[max(rs.compiler._steps)].report
    assert rep["grid_kernels"] == rrep["grid_kernels"]
    assert len(rep["grid_kernels"]) == model.cfg.n_layers
    assert all("attn" in k for k in rep["grid_kernels"])
    assert rrep["grid_converted"][0]["block_shape"][0] == 8
    assert rep["grid_converted"][0]["block_shape"] == [1, 4, 32]
    assert not rep["grid_fallbacks"] and not rep["grid_skipped"]


def test_flash_level_streams_match_grid(starcoder):
    """The hand kernel's level (its plain version here) serves the same
    streams as the generated kernels."""
    _, _, model, params = starcoder
    prompts = np.random.default_rng(4).integers(0, model.cfg.vocab, (5, 7))
    kw = dict(max_slots=8, page_size=8, n_pages=32, max_model_len=64,
              prefill_chunk=4)
    s, grid = _serve(model, params, prompts, 6, **kw)
    f, flash = _serve(model, params, prompts, 6, expansion_level="flash",
                      **kw)
    assert flash == grid
    for sched, kernels in ((s, True), (f, False)):
        rep = sched.compiler._steps[max(sched.compiler._steps)].report
        assert bool(rep["grid_kernels"]) == kernels


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_chunked_prefill_matches_reference(chunk):
    """Prefill through decode_step in chunks (the scheduler's path) against
    the reference's same chunking on gemma3-4b (the sliding window), fp32
    cache; the sampled token is the whole-prompt one. (The reference's own
    chunked-vs-whole 2e-6 check fails on XLA CPU; it is not copied.)"""
    rmodel, rparams, model, params = _models("gemma3-4b")
    prompt = np.arange(1, 12) % model.cfg.vocab
    L = len(prompt)

    def run(m, p, cache, step, arr, c):
        logits, i = None, 0
        while i < L:
            logits, cache = step(p, cache, arr(prompt[None, i:i + c]))
            i += c
        return logits, cache

    rlog, _ = run(rmodel, rparams, rmodel.init_cache(1, L, jnp.float32),
                  jax.jit(rmodel.decode_step),
                  lambda a: jnp.asarray(a, jnp.int32), chunk)
    rwhole, _ = jax.jit(rmodel.decode_step)(
        rparams, rmodel.init_cache(1, L, jnp.float32),
        jnp.asarray(prompt[None], jnp.int32))
    log, cache = run(model, params, model.init_cache(1, L, torch.float32),
                     model.decode_step,
                     lambda a: torch.as_tensor(a, dtype=torch.int32), chunk)
    np.testing.assert_allclose(log[0, -1].numpy(),
                               np.asarray(rlog[0, -1]), rtol=1e-5, atol=1e-5)
    assert int(log[0, -1].argmax()) == int(np.asarray(rwhole[0, -1]).argmax())
    assert cache["pos"] == L


# ---------------------------------------------------------------------------
# scheduler behaviour (port only)
# ---------------------------------------------------------------------------
def test_admit_evict_no_leaks(starcoder_bf16):
    _, _, model, params = starcoder_bf16
    sched = Scheduler(model, params, max_slots=3, page_size=8, n_pages=24,
                      max_model_len=64, prefill_chunk=4, device="cpu",
                      compile_cache=CompilationCache())
    rng = np.random.RandomState(0)
    for i in range(7):
        L = int(rng.randint(2, 14))
        sched.submit(list(rng.randint(0, model.cfg.vocab, size=L)),
                     int(rng.randint(2, 9)))
        if i % 2 == 0:
            sched.step()
            sched.check_invariants()
    reqs = sched.run()
    sched.check_invariants()
    assert len(reqs) == 7 and all(r.done for r in reqs)
    assert sched.pool.num_free == sched.pool.n_pages - 1
    assert sched.pool._reserved == 0
    assert not np.any(sched.block_table)


def test_queue_waits_for_pages(starcoder_bf16):
    _, _, model, params = starcoder_bf16
    sched = Scheduler(model, params, max_slots=2, page_size=8, n_pages=4,
                      max_model_len=32, prefill_chunk=8, device="cpu",
                      compile_cache=CompilationCache())
    for _ in range(2):
        sched.submit(list(range(1, 9)), 8)
    sched.step()
    assert sum(r is not None for r in sched.slots) == 1
    assert len(sched.queue) == 1
    assert len(sched.run()) == 2
    sched.check_invariants()


def test_bucket_reuse_hits_cache(starcoder_bf16):
    _, _, model, params = starcoder_bf16
    cc = CompilationCache()

    def run_once():
        sched = Scheduler(model, params, max_slots=3, page_size=8,
                          n_pages=24, max_model_len=64, prefill_chunk=4,
                          compile_cache=cc, device="cpu")
        for _ in range(3):
            sched.submit(list(range(1, 6)), 4)
        sched.run()

    run_once()
    first = dict(cc.stats)
    assert first["misses"] >= 1
    run_once()  # identical workload -> identical (B, ctx) buckets
    second = cc.stats
    assert second["misses"] == first["misses"]
    assert second["hits"] == first["hits"] + first["misses"]


def test_sampling(starcoder_bf16):
    _, _, model, params = starcoder_bf16
    with pytest.raises(ValueError):
        Scheduler(model, params, temperature=-0.1, device="cpu")
    with pytest.raises(ValueError):
        Scheduler(model, params, top_k=0, device="cpu")
    row = np.asarray([0.0, 3.0, 2.5, -1.0, 2.9], np.float32)
    greedy = Scheduler(model, params, device="cpu",
                       compile_cache=CompilationCache())
    assert greedy._sample(row) == 1
    sched = Scheduler(model, params, temperature=1.0, top_k=2, seed=11,
                      device="cpu", compile_cache=CompilationCache())
    assert {sched._sample(row) for _ in range(200)} == {1, 4}
    prompts = [list(np.random.RandomState(5).randint(1, 500, 6))
               for _ in range(3)]
    kw = dict(max_slots=3, page_size=8, n_pages=24, max_model_len=64,
              prefill_chunk=4, temperature=0.8, top_k=8)
    first = _serve(model, params, prompts, 6, seed=3, **kw)[1]
    assert first == _serve(model, params, prompts, 6, seed=3, **kw)[1]
    assert any(len(set(t)) > 1 for t in first)


def test_sharded_serving_waits_for_shard_map(starcoder_bf16):
    _, _, model, params = starcoder_bf16
    with pytest.raises(NotImplementedError, match="step 10c"):
        Scheduler(model, params, n_shards=2, device="cpu")
    s = Scheduler(model, params, device="cpu")
    with pytest.raises(NotImplementedError, match="step 10c"):
        s.shrink(1)


def test_in_place_donation_and_fault_tolerant_copies(starcoder_bf16):
    """A donating step writes the pool's page arrays in place (no copy);
    a non-donating one leaves its inputs intact."""
    _, _, model, params = starcoder_bf16
    for donate in (True, False):
        s = Scheduler(model, params, max_slots=2, page_size=8, n_pages=16,
                      max_model_len=32, prefill_chunk=8, device="cpu",
                      donate=donate, compile_cache=CompilationCache())
        s.submit([1, 2, 3], 3)
        s.step()                       # admission + the first decode step
        before = {li: (t, t.clone()) for li, t in s.pool.k_pages.items()}
        B, ctx = s._buckets([r for r in s.slots if r is not None])
        out = s.compiler.step_for(B, ctx)(s._step_kwargs(B, ctx))
        for li, (t, copy) in before.items():
            assert (out[f"kp{li}"] is t) == donate
            assert torch.equal(t, copy) != donate


# ---------------------------------------------------------------------------
# the RWKV6 family: per-slot recurrent state rows, no attention
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rwkv():
    return _models("rwkv6-7b")


RWKV_GEOMETRY = dict(max_slots=4, page_size=8, n_pages=32, max_model_len=64)


@pytest.mark.parametrize("chunk", [4, 16])
def test_rwkv_streams_match_reference_scheduler(rwkv, chunk):
    """test_serving.py:187's rwkv6-7b case (4 prompts of 6, prefill chunks
    of 4: the sequential WKV), and prompts of 36 in chunks of 16: the
    chunked WKV from the zero state, then from the first chunk's state,
    then 4 tokens through the scan."""
    rmodel, rparams, model, params = rwkv
    L = 6 if chunk == 4 else 36
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, L), 0, model.cfg.vocab))
    kw = dict(RWKV_GEOMETRY, prefill_chunk=chunk)
    _, want = _rserve(rmodel, rparams, prompts, 5, **kw)
    s, got = _serve(model, params, prompts, 5, **kw)
    assert got == want
    assert all(st.rung == "grid" for st in s.compiler._steps.values())
    assert not s.compiler.events and s.n_fallback_steps == 0


def test_rwkv_state_specs_and_grid_kernels_match_reference(rwkv):
    """The state rows' names, shapes and dtypes are the reference's, and
    the compiled step lists the same grid kernels (none: RWKV layers are
    whole-array tasklets without maps) at test_serving.py's geometry."""
    from repro.serving.compile import state_specs as rstate_specs
    rmodel, rparams, model, params = rwkv
    specs = serving_compile.state_specs(model)
    assert specs == rstate_specs(rmodel)
    H, hd, D = model.cfg.n_heads, model.cfg.head_dim, model.cfg.d_model
    assert specs["st0__wkv"] == (0, (H, hd, hd), "float32")
    assert specs["st3__shift2"] == (3, (1, D), "float32")
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 6), 0, model.cfg.vocab))
    kw = dict(RWKV_GEOMETRY, prefill_chunk=4)
    rs, _ = _rserve(rmodel, rparams, prompts, 3, **kw)
    s, _ = _serve(model, params, prompts, 3, **kw)
    assert sorted(s.compiler._steps) == sorted(rs.compiler._steps)
    for key, step in s.compiler._steps.items():
        rep, rrep = step.report, rs.compiler._steps[key].report
        assert rep["grid_kernels"] == rrep["grid_kernels"] == []
    assert set(s.compiler._donate) == set(specs)


RWKV_PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2]]


def _rwkv_sched(rwkv, **kw):
    _, _, model, params = rwkv
    return Scheduler(model, params, device="cpu",
                     compile_cache=CompilationCache(),
                     **{**RWKV_GEOMETRY, "page_size": 4, "n_pages": 32,
                        "max_model_len": 32, "prefill_chunk": 4,
                        "cache_dtype": "float32", **kw})


def _rwkv_streams(sched):
    for p in RWKV_PROMPTS:
        sched.submit(p, 8)
    out = {r.rid: r.tokens_out for r in sched.run()}
    sched.check_invariants()
    return out


@pytest.fixture(scope="module")
def rwkv_baseline(rwkv):
    """Fault-free RWKV streams, equal to the reference Scheduler's."""
    rmodel, rparams, _, _ = rwkv
    s = RScheduler(rmodel, rparams, compile_cache=RCompilationCache(),
                   max_slots=4, page_size=4, n_pages=32, max_model_len=32,
                   prefill_chunk=4, cache_dtype="float32")
    for p in RWKV_PROMPTS:
        s.submit(p, 8)
    want = {r.rid: r.tokens_out for r in s.run()}
    assert _rwkv_streams(_rwkv_sched(rwkv)) == want
    return want


@pytest.mark.parametrize("to_dir", [False, True])
def test_rwkv_snapshot_restore_token_exact(rwkv, rwkv_baseline, tmp_path,
                                           to_dir):
    """Mid-decode snapshot of an RWKV scheduler (its state rows
    ``st{li}__*`` included) restored into a fresh one: both continue to
    the baseline's streams."""
    s = _rwkv_sched(rwkv)
    for p in RWKV_PROMPTS:
        s.submit(p, 8)
    for _ in range(3):
        s.step()
    assert any(bool(a.abs().sum()) for a in s.states.values())
    if to_dir:
        restored = _rwkv_sched(rwkv).restore_from_dir(
            s.snapshot_to_dir(tmp_path / "snap"))
    else:
        restored = _rwkv_sched(rwkv).restore(s.snapshot())
    for name, a in s.states.items():
        assert torch.equal(restored.states[name], a)
    assert {r.rid: r.tokens_out for r in s.run()} == rwkv_baseline
    assert {r.rid: r.tokens_out for r in restored.run()} == rwkv_baseline
    restored.check_invariants()


def test_rwkv_preemption_re_prefill_token_exact(rwkv, rwkv_baseline):
    """Page pressure preempts requests mid-decode, and readmission
    re-prefills prompt + generated tokens from a zero state into the
    request's new slot row: the streams are the baseline's."""
    from repro_torch.serving import FaultInjector, ServeFaultPlan
    plan = ServeFaultPlan(page_pressure_at=1, page_pressure_release_at=8)
    s = _rwkv_sched(rwkv, injector=FaultInjector(plan))
    assert _rwkv_streams(s) == rwkv_baseline
    assert s.n_preemptions >= 1
    assert any(e["kind"] == "preempt" and e["kept_tokens"] > 1
               for e in s.events)


def test_rwkv_recompute_recovery_token_exact(rwkv, rwkv_baseline):
    """A failing step under donation takes the recompute rung: every state
    row is re-zeroed and every active request re-prefilled."""
    from repro_torch.serving import FaultInjector, ServeFaultPlan
    s = _rwkv_sched(rwkv, injector=FaultInjector(
        ServeFaultPlan(step_exception_at=2)), donate=True)
    assert _rwkv_streams(s) == rwkv_baseline
    assert s.n_recomputes == 1


def test_rwkv_state_rows_written_in_place(rwkv):
    """A donating step writes the scheduler's state rows in place (no
    copy); a non-donating one leaves its inputs intact."""
    for donate in (True, False):
        s = _rwkv_sched(rwkv, donate=donate)
        s.submit([1, 2, 3], 3)
        s.step()
        B, ctx = s._buckets([r for r in s.slots if r is not None])
        kwargs = s._step_kwargs(B, ctx)
        before = {n: kwargs[n].clone() for n in s.states}
        out = s.compiler.step_for(B, ctx)(kwargs)
        for n in s.states:
            assert (out[n].data_ptr() == s.states[n].data_ptr()) == donate
            assert torch.equal(kwargs[n], before[n]) != donate


def test_rwkv_wkv_kernel_that_cannot_launch_raises(rwkv, monkeypatch):
    """A chunked WKV that fails raises out of ``Scheduler.run``: the
    admission prefill has no fallback to the plain version."""
    from repro_torch.models import blocks

    def refused(*args, **kw):
        raise RuntimeError("wkv_chunked: CUDA error 1 at launch")

    monkeypatch.setattr(blocks, "wkv_chunked", refused)
    s = _rwkv_sched(rwkv, prefill_chunk=16)
    s.submit(list(range(1, 17)), 3)
    with pytest.raises(RuntimeError, match="wkv_chunked"):
        s.run()
    assert s.n_fallback_steps == 0 and not s.compiler.events
