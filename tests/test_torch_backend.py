"""The port's structural interpreter (backend ``torch``) against the
reference's (``jnp``) on the slice's programs, with the same seeded numpy
inputs, at the reference's own bound (rtol 1e-4, ``test_pallas_grid.py``);
and the port's device rules: ``cuda`` unless ``device="cpu"`` is passed,
no silent CPU fallback, numpy inputs moved to the compiled device."""
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registers the reference's fusions)
import repro_torch.kernels  # noqa: F401  (registers the port's fusions)
from benchmarks import axpydot as ref_axpydot, gemver as ref_gemver
from repro.pipeline import (DeviceOffloadPass as RDeviceOffloadPass,
                            StreamingCompositionPass as RStreamingPass,
                            StreamingMemoryPass as RStreamingMemoryPass,
                            lower as rlower)
from repro.transforms import MapFusion as RMapFusion
from repro_torch import programs
from repro_torch.pipeline import (COMPILATION_CACHE, DeviceOffloadPass,
                                  StreamingCompositionPass,
                                  StreamingMemoryPass, lower)
from repro_torch.transforms import MapFusion

import test_map_fusion as ref_programs


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _gemver_inputs(n, seed=6):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n, n) if k == "A" else n)
            .astype(np.float32)
            for k in ("A", "u1", "v1", "u2", "v2", "y", "z")}


@pytest.mark.parametrize("passes", ["none", "offload", "streamed",
                                    "streamed_memory"])
def test_axpydot_torch_matches_jnp(passes):
    n = 4099
    rng = np.random.default_rng(5)
    a = np.float32(-0.3)
    x, y, w = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    plist = {"none": [], "offload": ["off"], "streamed": ["off", "sc"],
             "streamed_memory": ["off", "sc", "sm"]}[passes]
    rp = [{"off": RDeviceOffloadPass, "sc": RStreamingPass,
           "sm": RStreamingMemoryPass}[p]() for p in plist]
    tp = [{"off": DeviceOffloadPass, "sc": StreamingCompositionPass,
           "sm": StreamingMemoryPass}[p]() for p in plist]
    cj = rlower(ref_axpydot.build(n)).optimize(rp).compile("jnp", cache=None)
    ct = lower(programs.axpydot(n)).optimize(tp).compile(
        "torch", device="cpu", cache=None)
    oj = _np(cj(a=a, x=x, y=y, w=w)["result"]).ravel()
    ot = ct(a=a, x=x, y=y, w=w)["result"]
    assert isinstance(ot, torch.Tensor) and ot.device.type == "cpu"
    np.testing.assert_allclose(_np(ot).ravel(), oj, rtol=1e-4)


@pytest.mark.parametrize("variant", ["plain", "manual", "both_streamed"])
def test_gemver_torch_matches_jnp(variant):
    n = 64
    d = _gemver_inputs(n)
    kw = {"plain": {}, "manual": {"manual_replication": True},
          "both_streamed": {"manual_replication": True,
                            "replica_in_hbm": False}}[variant]
    cj = rlower(ref_gemver.build(n, **kw)).compile("jnp", cache=None)
    ct = lower(programs.gemver(n, **kw)).compile("torch", device="cpu",
                                                 cache=None)
    oj, ot = cj(**d), ct(**d)
    for k in ("x_out", "w_out"):
        np.testing.assert_allclose(_np(ot[k]), _np(oj[k]), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("pref", [("generic",), ("accumulate", "generic")])
def test_gemver_chain_torch_matches_jnp(pref):
    """The fused chain (expansion preference, then MapFusion) on both
    interpreters."""
    from repro.pipeline import (ExpandLibraryNodesPass as RExpand,
                                MapFusionPass as RFusion,
                                PassManager as RPassManager,
                                SetExpansionPreferencePass as RPref)
    from repro_torch.pipeline import (ExpandLibraryNodesPass, MapFusionPass,
                                      PassManager,
                                      SetExpansionPreferencePass)
    n = 96
    d = _gemver_inputs(n, seed=12)
    d = {k: d[k] for k in ("A", "u1", "v1", "u2", "v2")} | {"xw": d["y"]}
    cj = rlower(ref_gemver.build_chain(n)).compile(
        "jnp", cache=None, pipeline=RPassManager(
            [RPref(pref), RExpand(), RFusion()], name="chain"))
    ct = lower(programs.gemver_chain(n)).compile(
        "torch", device="cpu", cache=None, pipeline=PassManager(
            [SetExpansionPreferencePass(pref), ExpandLibraryNodesPass(),
             MapFusionPass()], name="chain"))
    np.testing.assert_allclose(_np(ct(**d)["w_out"]), _np(cj(**d)["w_out"]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,m", [(48, 32), (128, 96)])
def test_rowsum_shift_torch_matches_jnp(n, m):
    rs, ts = ref_programs._wcr_chain_sdfg(n, m), programs.rowsum_shift(n, m)
    assert rs.apply(RMapFusion) == ts.apply(MapFusion) == 1
    rng = np.random.default_rng(31)
    A = rng.standard_normal((n, m)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    oj = _np(rlower(rs).compile("jnp", cache=None)(A=A, y=y)["out"])
    ot = _np(lower(ts).compile("torch", device="cpu", cache=None)(A=A, y=y)
             ["out"])
    np.testing.assert_allclose(ot, oj, rtol=1e-4, atol=1e-5)


def test_quickstart_flow_on_cpu():
    """The quickstart: offload + streaming composition, both backends,
    the Axpy->Dot fusion, and a cache hit on recompile."""
    n = 1 << 12
    rng = np.random.default_rng(0)
    a = np.float32(0.7)
    x, y, w = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    want = float(np.dot((a * x.astype(np.float64) + y), w))
    for backend in ("torch", "cuda"):
        c = lower(programs.axpydot(n)).optimize(
            [DeviceOffloadPass(), StreamingCompositionPass()]).compile(
            backend, device="cpu")
        got = float(c(a=a, x=x, y=y, w=w)["result"].reshape(-1)[0])
        assert abs(got - want) <= 1e-4 * abs(want)
        assert c.report["fused_regions"] == (["Axpy+Dot"]
                                             if backend == "cuda" else [])
    before = COMPILATION_CACHE.stats["hits"]
    lower(programs.axpydot(n)).optimize(
        [DeviceOffloadPass(), StreamingCompositionPass()]).compile(
        "cuda", device="cpu")
    assert COMPILATION_CACHE.stats["hits"] == before + 1


def test_device_is_part_of_the_cache_key():
    s = programs.axpydot(64)
    c1 = lower(s).compile("torch", device="cpu")
    assert c1.device == torch.device("cpu")
    assert c1.cache_key[-1] == "cpu"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_compile_defaults_to_cuda_and_raises_without_gpu(no_gpu, backend):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lower(programs.axpydot(64)).compile(backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lower(programs.axpydot(64)).compile(backend, device="cuda")


def test_sharded_compile_is_refused_and_bad_verify_mode_raises():
    """ShardMapPass partitions the program, but building the shard-local
    program is ROADMAP step 10a: the compile raises on both backends,
    naming it, instead of running a shard-local callable on global inputs.
    A verify mode the harness does not know raises too."""
    from repro_torch.analysis.selftest import rows_sdfg
    from repro_torch.pipeline import default_pipeline
    for backend in ("torch", "cuda"):
        pm = default_pipeline(backend, n_shards=2, mesh_sig="m")
        with pytest.raises(NotImplementedError, match="step 10a"):
            lower(rows_sdfg()).compile(backend, pipeline=pm, cache=None,
                                       device="cpu")
        with pytest.raises(ValueError, match="verify"):
            lower(rows_sdfg()).compile(backend, cache=None, device="cpu",
                                       verify="bogus")


@pytest.mark.parametrize("backend,ref_backend", [("torch", "jnp"),
                                                 ("cuda", "pallas")])
def test_default_pipeline_keeps_the_reference_pass_order(backend,
                                                         ref_backend):
    from repro.pipeline import default_pipeline as rdefault
    from repro_torch.pipeline import default_pipeline
    assert [p.name for p in default_pipeline(backend).passes] == \
        [p.name for p in rdefault(ref_backend).passes]
