"""The port's grid backend (``cuda``) against the reference's Pallas
backend in interpret mode, on the slice's programs at the reference's own
test sizes: identical ``report["grid_kernels"]`` and ``grid_fallbacks``,
outputs within rtol 1e-4 / atol 1e-5 (``test_pallas_grid.py``).

On the CPU the cuda backend runs each kernel's plain block program. The
generated Triton source is checked twice here: it parses, and — run by a
small CPU emulator of the part of ``triton.language`` it uses — it
computes what the plain block program computes. The emulator checks the
rules a Triton compile would (power-of-two block shapes) and that no
masked-in access leaves its tensor."""
import ast
import builtins
import itertools
import sys
import types
import zlib

import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from benchmarks import axpydot as ref_axpydot, gemver as ref_gemver
from benchmarks import jacobi_chain as ref_jacobi, lenet as ref_lenet
from benchmarks import stencil_bench as ref_stencil
from repro.pipeline import (ExpandLibraryNodesPass as RExpand,
                            GridConversionPass as RGrid,
                            MapFusionPass as RFusion,
                            MapTilingPass as RTiling,
                            PassManager as RPassManager,
                            SetExpansionPreferencePass as RPref,
                            lower as rlower)
from repro.transforms import MapFusion as RMapFusion
from repro_torch import programs
from repro_torch.codegen import cuda_backend
from repro_torch.frontends import blas
from repro_torch.frontends.api import Program
from repro_torch.pipeline import (ExpandLibraryNodesPass, GridConversionPass,
                                  MapFusionPass, MapTilingPass, PassManager,
                                  SetExpansionPreferencePass, lower)
from repro_torch.transforms import MapFusion

import test_map_fusion as ref_programs
from test_torch_ir import _port_builder


# ---------------------------------------------------------------------------
# a CPU emulator of the generated kernels' Triton vocabulary
# ---------------------------------------------------------------------------

def _pow2(n):
    return n > 0 and n & (n - 1) == 0


class _PtrType:
    def __init__(self, element_ty):
        self.element_ty = element_ty


class _Ptr:
    """A pointer, or a tensor of pointers, into a flat CPU tensor."""

    def __init__(self, store, offs=0):
        self.store, self.offs = store, offs
        self.dtype = _PtrType(store.dtype)

    def __add__(self, o):
        return _Ptr(self.store, self.offs + o)

    __radd__ = __add__


class _Lang:
    float32, float16, bfloat16 = torch.float32, torch.float16, torch.bfloat16
    int64, int32 = torch.int64, torch.int32

    def __init__(self):
        self.pid = (0, 0, 0)

    def program_id(self, axis):
        return torch.tensor(self.pid[axis], dtype=torch.int32)

    def arange(self, start, end):
        assert _pow2(end - start), f"tl.arange extent {end - start}"
        return torch.arange(start, end, dtype=torch.int32)

    def zeros(self, shape, dtype):
        assert all(_pow2(n) for n in shape), shape
        return torch.zeros(shape, dtype=dtype)

    def full(self, shape, value, dtype):
        assert all(_pow2(n) for n in shape), shape
        return torch.full(shape, value, dtype=dtype)

    @staticmethod
    def _index(ptr, mask):
        offs = torch.as_tensor(ptr.offs, dtype=torch.int64)
        mask = torch.ones((), dtype=torch.bool) if mask is None else mask
        offs, mask = torch.broadcast_tensors(offs, torch.as_tensor(mask))
        bad = mask & ((offs < 0) | (offs >= ptr.store.numel()))
        assert not bool(bad.any()), "a masked-in access leaves its tensor"
        return offs.clamp(0, ptr.store.numel() - 1), mask

    def load(self, ptr, mask=None, other=0.0):
        offs, mask = self._index(ptr, mask)
        val = ptr.store[offs]
        return torch.where(mask, val, torch.as_tensor(other, dtype=val.dtype))

    def store(self, ptr, val, mask=None):
        offs, mask = self._index(ptr, mask)
        val = torch.broadcast_to(torch.as_tensor(val).to(ptr.store.dtype),
                                 offs.shape)
        ptr.store[offs[mask]] = val[mask]

    @staticmethod
    def where(c, a, b):
        return torch.where(torch.as_tensor(c), torch.as_tensor(a),
                           torch.as_tensor(b))

    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)

    @staticmethod
    def max(x, axis):
        return torch.amax(x, dim=axis)

    @staticmethod
    def min(x, axis):
        return torch.amin(x, dim=axis)

    @staticmethod
    def maximum(a, b):
        return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))

    @staticmethod
    def minimum(a, b):
        return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))

    @staticmethod
    def range(start, end, step=1, num_stages=None):
        assert num_stages is None or num_stages >= 1, num_stages
        return builtins.range(start, end, step)

    @staticmethod
    def exp(x):
        return torch.exp(x)

    @staticmethod
    def abs(x):
        return torch.abs(x)

    @staticmethod
    def expand_dims(x, axis):
        return torch.as_tensor(x).unsqueeze(axis)


class _Kernel:
    def __init__(self, fn, lang):
        self.fn, self.lang = fn, lang

    def __getitem__(self, grid):
        def run(*args, num_warps=4):
            ptrs = [_Ptr(a.view(-1)) if isinstance(a, torch.Tensor) else a
                    for a in args]
            for pid in itertools.product(*[range(g) for g in grid]):
                self.lang.pid = tuple(pid) + (0,) * (3 - len(pid))
                self.fn(*ptrs)
        return run


def _load_emulated(src):
    lang = _Lang()
    triton = types.ModuleType("triton")
    triton.jit = lambda fn: _Kernel(fn, lang)
    tl = types.ModuleType("triton.language")
    for name in dir(lang):
        if not name.startswith("_"):
            setattr(tl, name, getattr(lang, name))
    triton.language = tl
    saved = {k: sys.modules.get(k) for k in ("triton", "triton.language")}
    sys.modules["triton"], sys.modules["triton.language"] = triton, tl
    try:
        ns = {}
        exec(compile(src, "<generated>", "exec"), ns)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return ns


def _emulated_launch(desc, src, inputs, outputs):
    ns = _load_emulated(src)
    for name, grid, args in cuda_backend.launch_plan(desc, inputs, outputs):
        ns[name][grid](*args, num_warps=cuda_backend._num_warps(desc))


@pytest.fixture
def emulated(monkeypatch):
    """Route the cuda backend's launches on CPU tensors through the
    emulator instead of the plain block programs."""
    monkeypatch.setattr(cuda_backend, "_on_cpu", lambda tensors: False)
    monkeypatch.setattr(cuda_backend, "launch_kernel", _emulated_launch)


# ---------------------------------------------------------------------------
# the slice's programs, built by both packages
# ---------------------------------------------------------------------------

def _axpy(pkg_program, pkg_blas, n):
    p = pkg_program("axpy")
    ah = p.scalar_input("a", "float32")
    xh, yh = p.input("x", (n,)), p.input("y", (n,))
    p.output("z", pkg_blas.axpy(ah, xh, yh))
    return p.finalize()


def _pipelines(ref_passes, port_passes, name):
    return (RPassManager(ref_passes, name=name),
            PassManager(port_passes, name=name))


def _acc(fused, tile=128):
    r = [RPref(("accumulate", "generic")), RExpand()]
    t = [SetExpansionPreferencePass(("accumulate", "generic")),
         ExpandLibraryNodesPass()]
    if fused:
        r.append(RFusion())
        t.append(MapFusionPass())
    r += [RTiling(tile_size=tile), RGrid()]
    t += [MapTilingPass(tile_size=tile), GridConversionPass()]
    return _pipelines(r, t, f"acc_f{int(fused)}")


def _chain(order):
    r = [RPref(("accumulate", "generic")), RExpand()]
    t = [SetExpansionPreferencePass(("accumulate", "generic")),
         ExpandLibraryNodesPass()]
    if order == "fuse_first":
        r += [RFusion(), RTiling()]
        t += [MapFusionPass(), MapTilingPass()]
    else:
        r += [RTiling(), RFusion()]
        t += [MapTilingPass(), MapFusionPass()]
    return _pipelines(r + [RGrid()], t + [GridConversionPass()],
                      f"chain_{order}")


def _vec(rng, n, k):
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _case(name):
    """(reference SDFG, port SDFG, compile kwargs for each, inputs)."""
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    if name == "axpy_generic":
        from repro.frontends import blas as rblas
        from repro.frontends.api import Program as RProgram
        n = 2048
        x, y = _vec(rng, n, 2)
        kw = {"expansion_level": "generic"}
        return (_axpy(RProgram, rblas, n), _axpy(Program, blas, n), kw, kw,
                {"a": np.float32(0.7), "x": x, "y": y})
    if name == "axpydot_generic":
        n = 2048
        x, y, w = _vec(rng, n, 3)
        kw = {"expansion_level": "generic"}
        return (ref_axpydot.build(n), programs.axpydot(n), kw, kw,
                {"a": np.float32(-0.3), "x": x, "y": y, "w": w})
    if name.startswith("axpydot_acc") or name.startswith("dag_acc"):
        n = 2048
        fused = name.endswith("fused") and not name.endswith("unfused")
        rp, tp = _acc(fused)
        d = {"a": np.float32(0.7)}
        if name.startswith("dag"):
            d["b"] = np.float32(-0.4)
            d.update(zip("xyuv", _vec(rng, n, 4)))
            return (ref_axpydot.build_two_producer(n),
                    programs.axpydot_two_producer(n),
                    {"pipeline": rp}, {"pipeline": tp}, d)
        d.update(zip("xyw", _vec(rng, n, 3)))
        return (ref_axpydot.build(n), programs.axpydot(n),
                {"pipeline": rp}, {"pipeline": tp}, d)
    if name == "gemver_generic":
        n = 64
        d = {k: rng.standard_normal((n, n) if k == "A" else n)
             .astype(np.float32)
             for k in ("A", "u1", "v1", "u2", "v2", "y", "z")}
        kw = {"expansion_level": "generic"}
        return ref_gemver.build(n), programs.gemver(n), kw, kw, d
    if name.startswith("gemver_chain"):
        n = 96
        rp, tp = _chain(name.split("-")[1])
        d = {k: rng.standard_normal((n, n) if k == "A" else n)
             .astype(np.float32)
             for k in ("A", "u1", "v1", "u2", "v2", "xw")}
        return (ref_gemver.build_chain(n), programs.gemver_chain(n),
                {"pipeline": rp}, {"pipeline": tp}, d)
    if name.startswith("rowsum"):
        tiled = name.endswith("tiled") and not name.endswith("untiled")
        n, m = (128, 96) if tiled else (48, 32)
        rs, ts = ref_programs._wcr_chain_sdfg(n, m), \
            programs.rowsum_shift(n, m)
        assert rs.apply(RMapFusion) == ts.apply(MapFusion) == 1
        d = {"A": rng.standard_normal((n, m)).astype(np.float32),
             "y": rng.standard_normal(n).astype(np.float32)}
        if tiled:
            return rs, ts, {}, {}, d
        rp, tp = _pipelines([RGrid()], [GridConversionPass()], "wcr_untiled")
        return rs, ts, {"pipeline": rp}, {"pipeline": tp}, d
    if name == "convblock":
        b = 2
        d = {"x": rng.standard_normal((b, 1, 28, 28)).astype(np.float32),
             "W": (0.1 * rng.standard_normal((8, 1, 5, 5))).astype(np.float32),
             "bias": (0.1 * rng.standard_normal(8)).astype(np.float32)}
        return ref_lenet._convblock_sdfg(b), programs.convblock(b), {}, {}, d
    if name == "jacobi_chain":
        n = ref_jacobi.N_SMALL
        return (ref_jacobi._chain_sdfg(n), programs.jacobi_chain(n), {}, {},
                {"a": rng.standard_normal(n).astype(np.float32)})
    if name.startswith("star5"):
        # 20 x 24 and 64 x 64: interior rows (18, 62) that no power-of-two
        # tile of 4 to 16 rows divides take 2-row tiles, not a partial one
        n, m = {"star5": (34, 34), "star5-20x24": (20, 24),
                "star5-64x64": (64, 64)}[name]
        return (ref_stencil._star_sdfg(n, m), programs.star5(n, m), {}, {},
                {"a": rng.standard_normal((n, m)).astype(np.float32)})
    # the fusion programs of test_map_fusion.py under the default pipeline
    builder, kw = {
        "pair": ("_pair_sdfg", {}),
        "pair_halo": ("_pair_sdfg", {"n": 64, "cons_params": {"j": (0, 63)},
                                     "offset": 1}),
        "two_producer": ("_two_producer_sdfg", {"n": 128}),
        "two_intermediate": ("_two_intermediate_sdfg", {"n": 64}),
        "three_scope": ("_three_scope_sdfg", {"n": 32,
                                              "s_transient": False}),
    }[name]
    rs = getattr(ref_programs, builder)(**kw)
    ts = _port_builder(builder)(**kw)
    assert rs.apply(RMapFusion) == ts.apply(MapFusion)
    # explicit tiles on both sides: the reference's default pipeline
    # takes its CPU-interpret calibration row (64, 32), the port its
    # Hopper tile table, and the kernel names follow the tiling
    rp, tp = _pipelines([RTiling(tile_size=64, second_size=32), RGrid()],
                        [MapTilingPass(tile_size=64, second_size=32),
                         GridConversionPass()], "fused_tiled")
    d = {k: rng.standard_normal(desc.shape[0].as_int()).astype(np.float32)
         for k, desc in ts.arrays.items()
         if not desc.transient and k in ("x", "y")}
    return rs, ts, {"pipeline": rp}, {"pipeline": tp}, d


CASES = ["axpy_generic", "axpydot_generic", "axpydot_acc_unfused",
         "axpydot_acc_fused", "dag_acc_unfused", "dag_acc_fused",
         "gemver_generic", "gemver_chain-fuse_first",
         "gemver_chain-tile_first", "rowsum_untiled", "rowsum_tiled",
         "pair", "pair_halo", "two_producer", "two_intermediate",
         "three_scope", "convblock", "jacobi_chain", "star5", "star5-20x24",
         "star5-64x64"]

#: the slice's programs must convert every scope the reference converts
SLICE = {"axpy_generic", "axpydot_generic", "axpydot_acc_unfused",
         "axpydot_acc_fused", "dag_acc_unfused", "dag_acc_fused",
         "gemver_generic", "gemver_chain-fuse_first",
         "gemver_chain-tile_first", "rowsum_untiled", "rowsum_tiled",
         "convblock", "jacobi_chain", "star5", "star5-20x24", "star5-64x64"}


def _compile(name):
    rs, ts, rkw, tkw, d = _case(name)
    cr = rlower(rs).compile("pallas", cache=None, **rkw)
    ct = lower(ts).compile("cuda", cache=None, device="cpu", **tkw)
    return cr, ct, d


def _sources(compiled):
    out = {}
    for st in compiled.sdfg.states:
        for nd in st.nodes:
            k = getattr(getattr(nd, "map", None), "annotations", {}).get(
                cuda_backend.KERNEL_ANNOTATION)
            if k is not None:
                out[k.desc.name] = k.source
    return out


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("name", CASES)
def test_grid_backend_matches_pallas(name):
    cr, ct, d = _compile(name)
    assert ct.report["grid_kernels"] == cr.report["grid_kernels"]
    assert [lbl for lbl, _ in ct.report["grid_fallbacks"]] == \
        [lbl for lbl, _ in cr.report["grid_fallbacks"]]
    assert sorted(ct.report["grid_skipped"]) == \
        sorted(cr.report["grid_skipped"])
    if name in SLICE - {"axpydot_generic"}:  # its unrolled reduce phase
        assert ct.report["grid_fallbacks"] == []  # is no grid in either
        assert ct.report["grid_kernels"]
    orf, ot = cr(**d), ct(**d)
    assert set(ot) == set(orf)
    for k in orf:
        np.testing.assert_allclose(_np(ot[k]).reshape(np.shape(orf[k])),
                                   _np(orf[k]), rtol=1e-4, atol=1e-5)
    srcs = _sources(ct)
    assert sorted(srcs) == sorted(ct.report["grid_kernels"])
    for src in srcs.values():
        ast.parse(src)


def test_reference_kernel_lists_at_reference_sizes():
    """The lists the reference's own tests pin, reached by the port."""
    expect = {
        "axpy_generic": ["axpy0_map_tiled"],
        "axpydot_acc_fused": ["axpy0_map+dot0_acc_tiled"],
        "gemver_generic": ["ger0_map+ger1_map_tiled", "gemv0_rows",
                           "gemv1_rows"],
        "convblock": ["conv+pool_tiled"],
        "jacobi_chain": ["jacobi0+jacobi1+jacobi2+jacobi3_tiled"],
        "star5": ["star_tiled"],
    }
    for name, kernels in expect.items():
        _, ct, _ = _compile(name)
        assert ct.report["grid_kernels"] == kernels
    _, ct, _ = _compile("axpydot_generic")
    assert any(k.startswith("axpy0_map+dot0_stream")
               for k in ct.report["grid_kernels"])
    for name, count in (("axpydot_acc_unfused", 2), ("dag_acc_unfused", 3),
                        ("dag_acc_fused", 1), ("rowsum_tiled", 1),
                        ("rowsum_untiled", 1)):
        _, ct, _ = _compile(name)
        assert len(ct.report["grid_kernels"]) == count, name


@pytest.mark.parametrize("name,count", [("convblock", 2),
                                        ("jacobi_chain", 4)])
def test_perstage_pipeline_gives_one_kernel_a_stage(name, count):
    """The cuda default pipeline minus MapFusion (``programs.
    perstage_pipeline``) leaves each stage its own grid kernel, as the
    reference's per-stage baselines do, and computes the same result."""
    rs, ts, _, _, d = _case(name)
    ref_pipe = (ref_lenet if name == "convblock" else
                ref_jacobi)._perstage_pipeline()
    cr = rlower(rs).compile("pallas", cache=None, pipeline=ref_pipe)
    ct = lower(ts).compile("cuda", cache=None, device="cpu",
                           pipeline=programs.perstage_pipeline())
    assert len(ct.report["grid_kernels"]) == count
    assert ct.report["grid_kernels"] == cr.report["grid_kernels"]
    fused = lower(ts).compile("cuda", cache=None, device="cpu")(**d)
    out = ct(**d)
    for k in fused:
        np.testing.assert_allclose(_np(out[k]), _np(fused[k]), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("name", sorted(SLICE))
def test_generated_triton_computes_the_plain_program(name, emulated):
    """The generated Triton kernels, run by the emulator, against the
    plain block programs; every launch moves its emitter's counter."""
    rs, ts, _, tkw, d = _case(name)
    ct = lower(ts).compile("cuda", cache=None, device="cpu", **tkw)
    kernels = ct.report["grid_kernels"]
    two_phase = name.startswith("rowsum")
    counter = cuda_backend.run_two_phase if two_phase \
        else cuda_backend.run_grid_kernel
    before = counter.launches
    got = ct(**d)
    assert counter.launches == before + len(kernels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_backend, "_on_cpu", lambda tensors: True)
        want = ct(**d)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4,
                                   atol=1e-5)


def test_untraceable_body_is_a_typed_compile_time_refusal():
    """A tasklet body outside the traceable vocabulary leaves its scope on
    the interpreter path with a typed refusal in ``grid_fallbacks`` — and
    the program still runs."""
    from repro_torch.core.memlet import Memlet, Subset
    from repro_torch.core.sdfg import SDFG
    from repro_torch.core.symbolic import sym
    n = 256
    s = SDFG("untraceable")
    s.add_array("x", (n,), "float32")
    s.add_array("out", (n,), "float32")
    st = s.add_state("main", is_start=True)
    i = sym("i")
    st.add_mapped_tasklet(
        "sine", {"i": (0, n)},
        inputs={"v": Memlet.simple("x", Subset.indices([i]))},
        outputs={"o": Memlet.simple("out", Subset.indices([i]))},
        fn=lambda v: torch.sin(v))
    c = lower(s).compile("cuda", cache=None, device="cpu")
    assert c.report["grid_kernels"] == []
    (label, reason), = c.report["grid_fallbacks"]
    assert label.startswith("sine") and "not traceable" in reason
    assert any(r["code"].startswith("GRD") or r["code"]
               for r in c.report["refusals"])
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(_np(c(x=x)["out"]), np.sin(x), rtol=1e-6)


def test_two_stage_reduction_splits_a_small_kept_grid():
    """A scalar-output reduction spreads its steps over a fixed number of
    programs and sums the partials in a second, fixed-order kernel."""
    _, ct, _ = _compile("axpydot_acc_fused")
    from repro_torch.core.sdfg import MapEntry
    (kernel,) = [nd.map.annotations[cuda_backend.KERNEL_ANNOTATION]
                 for st in ct.sdfg.states for nd in st.nodes
                 if isinstance(nd, MapEntry) and cuda_backend.
                 KERNEL_ANNOTATION in nd.map.annotations]
    assert kernel.desc.n_kept == 1 and kernel.desc.splits > 1
    assert "_final(" in kernel.source and "atomic" not in kernel.source


def test_gemver_kernel_list_at_paper_n_matches_reference():
    """At the paper's N = 16,384 MapTiling tiles gemver's row maps too, in
    both packages: the list ``chip_smoke.py`` holds the card to."""
    n = programs.GEMVER_N
    kw = {"expansion_level": "generic"}
    cr = rlower(ref_gemver.build(n)).compile("pallas", cache=None, **kw)
    ct = lower(programs.gemver(n)).compile("cuda", cache=None, device="cpu",
                                           **kw)
    assert ct.report["grid_kernels"] == cr.report["grid_kernels"] == [
        "ger0_map+ger1_map_tiled", "gemv0_rows_tiled", "gemv1_rows_tiled"]
    assert ct.report["grid_fallbacks"] == cr.report["grid_fallbacks"] == []


@pytest.mark.parametrize("name", ["gemver_generic", "dag_acc_unfused",
                                  "rowsum_tiled"])
def test_launch_counts_per_kernel_name(name, emulated):
    """Each launch adds one to its wrapper's count under the kernel's name;
    the plain block programs (CPU tensors) add nothing."""
    from collections import Counter
    _, ts, _, tkw, d = _case(name)
    ct = lower(ts).compile("cuda", cache=None, device="cpu", **tkw)

    def counts():
        return Counter(cuda_backend.run_grid_kernel.launches_by_name) + \
            Counter(cuda_backend.run_two_phase.launches_by_name)

    seen = []
    cuda_backend.LAUNCH_OBSERVERS.append(
        lambda kernel, *_: seen.append(kernel.desc.name))
    try:
        before = counts()
        ct(**d)
        assert counts() - before == Counter(ct.report["grid_kernels"])
        assert sorted(seen) == sorted(ct.report["grid_kernels"])
    finally:
        cuda_backend.LAUNCH_OBSERVERS.pop()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_backend, "_on_cpu", lambda tensors: True)
        before = counts()
        ct(**d)
        assert counts() == before and len(seen) == len(
            ct.report["grid_kernels"])


@pytest.mark.parametrize("fault", ["no_kernel", "stale_labels"])
def test_converted_scope_that_cannot_launch_raises(fault):
    """A scope GridConversionPass converted never drops quietly to the
    interpreter: a missing kernel or a stale chain is an error."""
    from repro_torch.core.sdfg import MapEntry, Tasklet
    _, ts, _, tkw, d = _case("gemver_generic")
    ct = lower(ts).compile("cuda", cache=None, device="cpu", **tkw)
    entry = next(nd for st in ct.sdfg.states for nd in st.nodes
                 if isinstance(nd, MapEntry)
                 and cuda_backend.KERNEL_ANNOTATION in nd.map.annotations)
    if fault == "no_kernel":
        del entry.map.annotations[cuda_backend.KERNEL_ANNOTATION]
    else:
        st = next(st for st in ct.sdfg.states if entry in st.nodes)
        inner = st.scope_children()[entry]
        next(n for n in inner if isinstance(n, Tasklet)).label += "_edited"
    with pytest.raises(cuda_backend.GridLaunchError):
        ct(**d)


@pytest.mark.parametrize("n", [2 ** 16 + 512, 2 ** 18 + 512])
def test_plain_program_batches_by_the_window_not_the_container(n,
                                                              monkeypatch):
    """A windowed operand gathers its window per grid step, so the plain
    block program's batches hold as many steps as the window allows: the
    jacobi chain's steps fit one batch at every size (sized by the
    container's extent, their count grew with its square)."""
    seen = []
    monkeypatch.setattr(cuda_backend, "_on_cpu", lambda tensors: False)
    monkeypatch.setattr(cuda_backend, "launch_kernel", lambda *args: None)
    monkeypatch.setattr(cuda_backend, "LAUNCH_OBSERVERS",
                        [lambda kernel, program, *_: seen.append(program)])
    ct = lower(programs.jacobi_chain(n)).compile("cuda", cache=None,
                                                 device="cpu")
    ct(a=np.zeros(n, np.float32))
    (program,) = seen
    assert any(es.fact.windows for es in program.spec.inputs)
    assert len(list(program._batches(torch.device("cpu")))) == 1


# ---------------------------------------------------------------------------
# the launch geometry chosen for the H100 (``cuda_backend._span``)
# ---------------------------------------------------------------------------

def _descs(compiled):
    return {k.desc.name: k.desc for st in compiled.sdfg.states
            for k in (getattr(getattr(nd, "map", None), "annotations",
                              {}).get(cuda_backend.KERNEL_ANNOTATION)
                      for nd in st.nodes) if k is not None}


def _meta_plan(desc):
    """``launch_plan`` on meta tensors of the operands' shapes (no data)."""
    ins = {a.container: torch.empty(a.shape, device="meta")
           for a in desc.loads}
    outs = {o.access.container: torch.empty(o.access.shape, device="meta")
            for o in desc.outputs}
    return cuda_backend.launch_plan(desc, ins, outs)


def test_launch_plan_is_worked_out_once(monkeypatch):
    """Every launch of a kernel shares one static plan (argument order,
    grids, partials sizes), worked out at its first launch; only the
    operands and the partials buffers are new each time."""
    ct = lower(programs.gemver(300)).compile(
        "cuda", cache=None, device="cpu", expansion_level="generic")
    d = _descs(ct)["gemv1_rows_tiled"]
    made = []
    real = cuda_backend._TritonEmitter
    monkeypatch.setattr(cuda_backend, "_TritonEmitter",
                        lambda *a: made.append(a) or real(*a))
    first, again = _meta_plan(d), _meta_plan(d)
    assert d.splits > 1 and [n for n, _, _ in first] == [
        n for n, _, _ in again] == [f"{d.fn}_main", f"{d.fn}_final"]
    assert [g for _, g, _ in first] == [g for _, g, _ in again]
    assert len(made) == 2           # the plan's emitter and _part_sizes'
    assert first[0][2][-1] is not again[0][2][-1]   # fresh partials


def test_launch_plan_fills_the_card_at_the_paper_sizes():
    """At the paper's sizes every streaming kernel gives the card at least
    ``FILL_PROGRAMS`` programs, a flat map's program holds at least 1,024
    elements (one contiguous range), and MapTiling's tiles are unchanged."""
    fill = cuda_backend.FILL_PROGRAMS
    ct = lower(programs.gemver(programs.GEMVER_N)).compile(
        "cuda", cache=None, device="cpu", expansion_level="generic")
    descs = _descs(ct)
    for name in ("gemv0_rows_tiled", "gemv1_rows_tiled"):
        d = descs[name]
        assert d.tiles == (("i_in", 128, 128),) and d.n_kept == 128
        (main, grid, _), (final, fgrid, _) = _meta_plan(d)
        assert main.endswith("_main") and final.endswith("_final")
        assert grid[0] * grid[1] >= fill and fgrid == (128,)
        chunk = d.chunk
        assert chunk % 32 == 0      # 128-byte rows of gemv1's chunks
        assert -(-programs.GEMVER_N // chunk) <= 1024
    n = programs.AXPYDOT_N
    for fused, names in ((False, ("axpy0_map_tiled", "axpy1_map_tiled",
                                  "dot0_acc_tiled")),
                         (True, ("axpy1_map+axpy0_map+dot0_acc_tiled",))):
        ct = lower(programs.axpydot_two_producer(n)).compile(
            "cuda", cache=None, device="cpu",
            pipeline=programs.axpydot_grid_pipeline(fused))
        descs = _descs(ct)
        assert sorted(descs) == sorted(names)
        for name in names:
            d = descs[name]
            assert d.tiles == (("i_in", 128, 128),)
            plan = _meta_plan(d)
            grid = plan[0][1]
            assert grid[0] * (grid[1] if len(grid) > 1 else 1) >= fill
            assert d.blocks[0] >= 1024
            if d.kept:      # a flat map: N over its programs
                assert len(plan) == 1 and n // grid[0] >= 1024
            else:           # a split reduction and its fixed-order final
                assert [p[0].rsplit("_", 1)[1] for p in plan] == \
                    ["main", "final"]


def _ragged(name, rng):
    """(reference SDFG, port SDFG, reference kwargs, port kwargs, inputs)
    at sizes that are no whole tile or chunk."""
    if name == "gemver":
        n = 300     # 3 tiles, the last partial; windows of 300
        d = {k: rng.standard_normal((n, n) if k == "A" else n)
             .astype(np.float32)
             for k in ("A", "u1", "v1", "u2", "v2", "y", "z")}
        kw = {"expansion_level": "generic"}
        return ref_gemver.build(n), programs.gemver(n), kw, kw, d
    if name == "rowsum":
        # m a whole number of tiles: the port refuses a partial tile
        # along the summed axis (ROADMAP, open faults)
        n, m = 300, 256
        rs, ts = ref_programs._wcr_chain_sdfg(n, m), \
            programs.rowsum_shift(n, m)
        assert rs.apply(RMapFusion) == ts.apply(MapFusion) == 1
        return rs, ts, {}, {}, {
            "A": rng.standard_normal((n, m)).astype(np.float32),
            "y": rng.standard_normal(n).astype(np.float32)}
    n = 2900        # 23 tiles, the last of 84 elements
    fused = name.endswith("_fused")
    rp, tp = _acc(fused)
    d = {"a": np.float32(0.7)}
    if name.startswith("dag"):
        d["b"] = np.float32(-0.4)
        d.update(zip("xyuv", _vec(rng, n, 4)))
        return (ref_axpydot.build_two_producer(n),
                programs.axpydot_two_producer(n), {"pipeline": rp},
                {"pipeline": tp}, d)
    d.update(zip("xyw", _vec(rng, n, 3)))
    return (ref_axpydot.build(n), programs.axpydot(n), {"pipeline": rp},
            {"pipeline": tp}, d)


RAGGED = ["gemver", "rowsum", "axpydot_unfused", "axpydot_fused",
          "dag_unfused", "dag_fused"]


@pytest.mark.parametrize("fill", [cuda_backend.FILL_PROGRAMS, 4])
@pytest.mark.parametrize("name", RAGGED)
def test_emulated_geometry_matches_pallas_at_ragged_sizes(name, fill,
                                                         emulated,
                                                         monkeypatch):
    """The generated kernels at ragged sizes, run by the emulator, against
    the reference's Pallas backend in interpret mode: at the default
    ``FILL_PROGRAMS`` (gemver's row maps split each window of 300 into 5
    ranges of chunks of 64, the last chunk partial, summed by a ``_final``
    launch) and at 4, where the row maps split in 2 and the flat maps and
    reductions join tiles into programs of up to 512 lanes with a partial
    last group. The data is drawn from a seed fixed by the case's name
    (``zlib.crc32``, the same in every process). Each output is a sum of
    products whose terms may cancel (gemver's w sums 300 terms of size
    about 1e3 to values below 1), so it is held elementwise to
    4 eps32 sqrt(L) (||t||_2 + |want|): L the length of the longest sum
    (the program's size), ||t||_2 the 2-norm of the output's terms, read
    from the reference's ``jnp`` run on the squared inputs (constants
    inside a program, at most 2 here, are not squared)."""
    monkeypatch.setattr(cuda_backend, "FILL_PROGRAMS", fill)
    monkeypatch.setattr(cuda_backend, "FLAT_LANES", 512)
    rng = np.random.default_rng(zlib.crc32(f"{name}/ragged".encode()))
    rs, ts, rkw, tkw, d = _ragged(name, rng)
    cr = rlower(rs).compile("pallas", cache=None, **rkw)
    ct = lower(ts).compile("cuda", cache=None, device="cpu", **tkw)
    assert ct.report["grid_kernels"] == cr.report["grid_kernels"]
    descs = _descs(ct).values()
    # the two-phase kernel keeps its geometry; at 23 tiles the flat
    # kernels join tiles only when 4 programs fill the card
    if name == "gemver":
        assert sum(dd.window_split for dd in descs) == 2
    elif fill == 4 and name != "rowsum":
        assert any(dd.span for dd in descs)
    orf, ot = cr(**d), ct(**d)
    sq = rlower(rs).compile("jnp", cache=None)(
        **{k: np.multiply(v, v) for k, v in d.items()})
    L = max(np.size(v) for v in d.values() if np.ndim(v) == 1)
    for k in orf:
        want = _np(orf[k]).astype(np.float64)
        norm2 = np.sqrt(np.abs(_np(sq[k]).astype(np.float64)))
        limit = 4 * 2.0 ** -23 * np.sqrt(L) * (norm2 + np.abs(want))
        got = _np(ot[k]).reshape(np.shape(want)).astype(np.float64)
        assert (np.abs(got - want) <= limit).all(), \
            float((np.abs(got - want) / limit).max())


@pytest.mark.parametrize("name", ["gemver", "dag_fused", "axpydot_unfused"])
def test_emulated_runs_are_byte_identical(name, emulated, monkeypatch):
    """No atomics and one summation order per output: two runs of the
    generated kernels give the same bytes."""
    monkeypatch.setattr(cuda_backend, "FILL_PROGRAMS", 4)
    monkeypatch.setattr(cuda_backend, "FLAT_LANES", 512)
    _, ts, _, tkw, d = _ragged(name, np.random.default_rng(5))
    ct = lower(ts).compile("cuda", cache=None, device="cpu", **tkw)
    one, two = ct(**d), ct(**d)
    for k in one:
        assert torch.equal(torch.as_tensor(one[k]), torch.as_tensor(two[k]))
    for src in _sources(ct).values():
        assert "atomic" not in src


def _rowsum_compiled(n, m):
    ts = programs.rowsum_shift(n, m)
    assert ts.apply(MapFusion) == 1
    return lower(ts).compile("cuda", cache=None, device="cpu")


@pytest.mark.parametrize("n,m,group", [(300, 256, 2), (256, 640, 4)])
def test_two_phase_rowsum_steps_groups_of_tiles(n, m, group, emulated,
                                                monkeypatch):
    """Row 2's reduction loop (``_reduction_span``) steps over G column
    tiles at a time, software-pipelined (``tl.range(..., num_stages)``):
    G = 2 when its 2 tiles fill one group, G = 4 with a partial last group
    of 1 tile of 5, masked. Run by the emulator, it matches the
    reference's Pallas kernel (interpret mode) and the plain block program
    at the grid tests' tolerance, two runs give the same bytes, and the
    kernel name, ``grid_kernels`` and ``grid_converted`` are those of the
    one-tile loop."""
    rng = np.random.default_rng(n + m)
    rs = ref_programs._wcr_chain_sdfg(n, m)
    assert rs.apply(RMapFusion) == 1
    d = {"A": rng.standard_normal((n, m)).astype(np.float32),
         "y": rng.standard_normal(n).astype(np.float32)}
    cr = rlower(rs).compile("pallas", cache=None)
    ct = _rowsum_compiled(n, m)
    (desc,) = _descs(ct).values()
    tiles = -(-m // 128)
    assert desc.group == group and desc.blocks[1] == 128 * group
    src = _sources(ct)["rowsum+shift_tiled"]
    assert (f"for r in tl.range(0, {tiles}, {group}, num_stages="
            f"{cuda_backend.TWO_PHASE_STAGES}):") in src
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_backend, "_reduction_span", lambda desc: None)
        one_tile = _rowsum_compiled(n, m)
    assert f"for r in range(0, {tiles}):" in _sources(one_tile)[
        "rowsum+shift_tiled"]
    assert ct.report["grid_kernels"] == one_tile.report["grid_kernels"] == \
        cr.report["grid_kernels"] == ["rowsum+shift_tiled"]
    assert ct.report["grid_converted"] == one_tile.report["grid_converted"]
    got, again = ct(**d)["out"], ct(**d)["out"]
    assert torch.equal(got, again)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_backend, "_on_cpu", lambda tensors: True)
        plain = ct(**d)["out"]
    for want in (cr(**d)["out"], plain):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4)
