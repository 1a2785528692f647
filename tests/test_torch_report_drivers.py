"""The port's BLAS and LeNet report drivers (``repro_torch.benchmarks.
{axpydot,gemver,lenet,jacobi_chain}``) and the ``quickstart`` and
``lenet_pipeline`` examples against the reference's
(``benchmarks/*.py``, ``examples/*.py``), on the CPU at the small sizes:
the reference's report names in its order, the off-chip volumes equal to
the reference's own builders' at the paper's sizes, and the grid-kernel
counts of every compiled variant equal to the reference's compile of the
same program at the same size.

The reference's rows are taken without timing, as
``tests/test_torch_fig19.py`` takes them: the names from its ``run``'s
source, the volumes and kernels from its builders and pipelines. The
port's drivers run with a clock that calls each timed function once (the
outputs are still held to their oracles) and records each race instead of
deciding it: a race is a claim about the card, decided in the chip run;
on the CPU the plain versions' races are ties (ROADMAP §3). The harness
itself is exercised too, with that clock, through ``run.main``."""
import ast
from pathlib import Path

import numpy as np
import pytest

import repro.kernels  # noqa: F401
from benchmarks import axpydot as ref_axpydot, gemver as ref_gemver
from benchmarks import jacobi_chain as ref_jacobi, lenet as ref_lenet
from repro.frontends.ml import build_lenet as rbuild_lenet
from repro.frontends.ml import init_lenet_params as rinit_lenet
from repro.pipeline import (ExpandLibraryNodesPass as RExpand,
                            GridConversionPass as RGrid,
                            MapFusionPass as RFusion,
                            MapTilingPass as RTiling,
                            PassManager as RPassManager,
                            SetExpansionPreferencePass as RPref,
                            lower as rlower)
from repro.transforms import (DeviceOffload as RDeviceOffload,
                              StreamingComposition as RStreamingComposition,
                              StreamingMemory as RStreamingMemory)
from repro_torch.benchmarks import axpydot, clock, gemver, jacobi_chain, lenet
from repro_torch.benchmarks import run as bench_run
from repro_torch.examples import lenet_pipeline, quickstart

DRIVERS = {"axpydot": (axpydot, ref_axpydot),
           "gemver": (gemver, ref_gemver),
           "lenet": (lenet, ref_lenet),
           "jacobi_chain": (jacobi_chain, ref_jacobi)}


class StubClock:
    """Calls each timed function once; keeps each race's claim."""

    where = "CPU (plain versions)"

    def __init__(self):
        self.races = []

    def ms(self, fn, reps=None):
        fn()
        return 1.0

    def check_race(self, winner_ms, loser_ms, claim):
        self.races.append(claim)


def _reference_names(module):
    """The names the reference driver's ``run`` reports, in source order."""
    tree = ast.parse(Path(module.__file__).read_text())
    (run,) = [n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run"]
    calls = [n for n in ast.walk(run) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "report"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    names = []
    for c in calls:
        arg = c.args[0]
        if isinstance(arg, ast.Constant):
            names.append(arg.value)
        else:       # gemver's f"gemver_{name}_volume_GiB" in its loop
            names.append(ast.unparse(arg))
    return names


def _expand_loops(names, variants):
    out = []
    loop = [n for n in names if n.startswith("f'")]
    for n in names:
        if n.startswith("f'"):
            if n == loop[0]:
                for v in variants:
                    out += [eval(m, {"name": v}) for m in loop]
            continue
        out.append(n)
    return out


def _run_port(name):
    mod, _ = DRIVERS[name]
    rows, stub = [], StubClock()

    def report(bname, value, derived="", backend="cuda", **extra):
        rows.append({"name": bname, "value": value, "derived": derived,
                     **extra})
    out = mod.run(report, small=True, device="cpu", clock=stub)
    return rows, out, stub


@pytest.fixture(scope="module", params=sorted(DRIVERS))
def port(request):
    return (request.param,) + _run_port(request.param)


def test_driver_reports_the_reference_names_in_order(port):
    name, rows, _, stub = port
    ref = DRIVERS[name][1]
    want = _reference_names(ref)
    if name == "gemver":
        want = _expand_loops(want, ("naive", "streaming", "manual",
                                    "both_streamed"))
    assert [r["name"] for r in rows] == want
    assert all(r["value"] > 0 for r in rows)
    timed = [r for r in rows if r["name"].endswith("_ms")]
    assert timed and all("CPU" in r["derived"] for r in timed)
    assert stub.races     # every driver keeps its race


def _ref_grid(fused, tiled=True):
    """The reference's Table-1 grid pipeline (its ``run``'s local
    ``grid_pipeline``)."""
    passes = [RPref(("accumulate", "generic")), RExpand()]
    if fused:
        passes.append(RFusion())
    if tiled:
        passes.append(RTiling(tile_size=128))
    passes.append(RGrid())
    return RPassManager(passes, name=f"grid_f{int(fused)}_t{int(tiled)}")


def _ref_axpydot_volumes():
    n = ref_axpydot.PAPER_N
    naive = ref_axpydot.build(n)
    naive.apply(RDeviceOffload)
    streamed = ref_axpydot.build(n)
    streamed.apply(RDeviceOffload)
    streamed.apply(RStreamingComposition)
    streamed.apply(RStreamingMemory)
    pes = len([s for s in streamed.states if s.label == "main"][0]
              .processing_elements())
    return {"naive": naive.off_chip_volume(),
            "stream": streamed.off_chip_volume()}, pes


def test_axpydot_volumes_and_kernels_are_the_references():
    rows, out, _ = _run_port("axpydot")
    vols, pes = _ref_axpydot_volumes()
    assert out["volumes"] == vols and out["pes"] == pes
    by = {r["name"]: r["value"] for r in rows}
    assert by["axpydot_naive_volume_GiB"] == vols["naive"] / 2**30
    assert by["axpydot_stream_volume_GiB"] == vols["stream"] / 2**30
    assert by["axpydot_stream_PEs"] == pes
    assert out["fused_regions"] == ["Axpy+Dot"]
    gn = 65_536
    un = max(1024, gn // 32)
    ref = {"unfused": (ref_axpydot.build, gn, _ref_grid(False)),
           "fused": (ref_axpydot.build, gn, _ref_grid(True)),
           "untiled": (ref_axpydot.build, un, _ref_grid(True, False)),
           "tiled_small": (ref_axpydot.build, un, _ref_grid(True)),
           "dag_unfused": (ref_axpydot.build_two_producer, gn,
                           _ref_grid(False)),
           "dag_fused": (ref_axpydot.build_two_producer, gn,
                         _ref_grid(True))}
    for variant, (build, n, pipe) in ref.items():
        want = rlower(build(n)).compile("pallas", pipeline=pipe,
                                        cache=None).report["grid_kernels"]
        assert len(out["grid_kernels"][variant]) == len(want), variant
    by_extra = {r["name"]: r for r in rows}
    assert by_extra["axpydot_dag_unfused_ms"]["grid_kernels"] == 3
    assert by_extra["axpydot_dag_fused_ms"]["grid_kernels"] == 1


def test_gemver_volumes_and_kernels_are_the_references():
    rows, out, _ = _run_port("gemver")
    want = {name: ref_gemver._kernel_volume(s) for name, s in
            ref_gemver._variants(ref_gemver.PAPER_N).items()}
    assert out["volumes"] == want
    by = {r["name"]: r["value"] for r in rows}
    for name, v in want.items():
        assert by[f"gemver_{name}_volume_GiB"] == v / 2**30
    gn = 64
    for variant, fused, tiled in (("unfused", False, True),
                                  ("fused", True, True),
                                  ("untiled", True, False)):
        ref = rlower(ref_gemver.build(gn)).compile(
            "pallas", pipeline=ref_gemver._grid_pipeline(fused, tiled),
            cache=None).report["grid_kernels"]
        assert len(out["grid_kernels"][variant]) == len(ref), variant
    cn = gemver.CHAIN_N_SMALL
    for variant, pref in (("dag", ("accumulate", "generic")),
                          ("pairwise", ("generic",))):
        ref = rlower(ref_gemver.build_chain(cn)).compile(
            "pallas", pipeline=ref_gemver._chain_pipeline(variant, pref),
            cache=None).report["grid_kernels"]
        assert len(out["chain_kernels"][variant]) == len(ref), variant


def test_lenet_volumes_and_kernels_are_the_references():
    rows, out, _ = _run_port("lenet")
    params = rinit_lenet()
    want = ref_lenet._volumes(ref_lenet.PAPER_BATCH, params)
    assert out["volumes"] == want
    by = {r["name"]: r["value"] for r in rows}
    for k in ("naive", "const", "stream"):
        assert by[f"lenet_{k}_volume_GiB"] == want[k] / 2**30
    ref_fused = rlower(ref_lenet._convblock_sdfg(2)).compile(
        "pallas", cache=None).report["grid_kernels"]
    ref_perstage = rlower(ref_lenet._convblock_sdfg(2)).compile(
        "pallas", pipeline=ref_lenet._perstage_pipeline(),
        cache=None).report["grid_kernels"]
    assert len(out["convblock_kernels"]["fused"]) == len(ref_fused) == 1
    assert len(out["convblock_kernels"]["perstage"]) == \
        len(ref_perstage) == 2
    ref_ladder = rlower(rbuild_lenet(20))
    from repro.pipeline import (DeviceOffloadPass, InputToConstantPass,
                                StreamingCompositionPass)
    regions = ref_ladder.optimize(
        [InputToConstantPass(parameters=params), DeviceOffloadPass(),
         StreamingCompositionPass()]).compile(
            "pallas", cache=None).report["fused_regions"]
    assert out["fused_regions"] == regions


def test_jacobi_chain_kernels_are_the_references():
    rows, out, _ = _run_port("jacobi_chain")
    n = ref_jacobi.N_SMALL
    assert jacobi_chain.N_SMALL == n
    cf = rlower(ref_jacobi._chain_sdfg(n)).compile("pallas", cache=None)
    cp = rlower(ref_jacobi._chain_sdfg(n)).compile(
        "pallas", pipeline=ref_jacobi._perstage_pipeline(), cache=None)
    assert len(out["fused"]) == len(cf.report["grid_kernels"]) == 1
    assert len(out["perstage"]) == len(cp.report["grid_kernels"]) == 4
    assert out["tasklets"] == \
        cf.report["grid_converted"][0].get("tasklets") == 16
    assert rows[0]["grid_kernels"] == 1 and rows[1]["grid_kernels"] == 4


def test_harness_runs_the_drivers_in_the_reference_order(monkeypatch,
                                                         tmp_path, capsys):
    """``run.main`` knows the four drivers in ``benchmarks/run.py``'s
    order and writes each one's record (with the stub clock)."""
    monkeypatch.setattr(clock, "Clock", lambda device: StubClock())
    for mod in (axpydot, gemver, lenet, jacobi_chain):
        monkeypatch.setattr(mod, "Clock", lambda device: StubClock())
    rc = bench_run.main(["--only", "axpydot,gemver,lenet,jacobi_chain",
                         "--small", "--device", "cpu", "--json",
                         str(tmp_path)])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"BENCH_{m}.json" for m in ("axpydot", "gemver", "jacobi_chain",
                                    "lenet")]
    tree = ast.parse(Path(ref_axpydot.__file__).with_name("run.py")
                     .read_text())
    (modules,) = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "modules"]
    ref_order = [k.value for k in modules.keys
                 if k.value in ("axpydot", "gemver", "lenet", "jacobi_chain")]
    printed = [line.split(",")[0] for line in
               capsys.readouterr().out.splitlines()
               if line and not line.startswith(("#", "name,"))]
    firsts = sorted(("axpydot", "gemver", "lenet", "jacobi_chain"),
                    key=lambda m: next(i for i, p in enumerate(printed)
                                       if p.startswith(m)))
    assert firsts == ref_order


def test_quickstart_matches_the_reference_flow():
    out = quickstart.main(["--device", "cpu"])
    assert out["torch"]["fused_regions"] == []
    assert out["cuda"]["fused_regions"] == ["Axpy+Dot"]
    for b in ("torch", "cuda"):
        assert abs(out[b]["result"] - out["expected"]) < \
            1e-3 * abs(out["expected"])
    assert out["cache"][1]["hits"] == out["cache"][0]["hits"] + 1
    # the reference's volumes and processing elements for the same ladder
    from repro.pipeline import (DeviceOffloadPass, PassManager,
                                StreamingCompositionPass,
                                StreamingMemoryPass, VectorizationPass)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ref_quickstart", Path(ref_axpydot.__file__).parents[1] /
        "examples" / "quickstart.py")
    ref_qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_qs)
    lowered = ref_qs.axpydot.lower(1 << 20)
    lowered.optimize([DeviceOffloadPass()])
    v0 = lowered.sdfg.off_chip_volume()
    lowered.optimize(PassManager([VectorizationPass(width=128),
                                  StreamingCompositionPass(),
                                  StreamingMemoryPass()]))
    main = [s for s in lowered.sdfg.states if s.label == "main"][0]
    assert out["volumes"] == (v0, lowered.sdfg.off_chip_volume())
    assert out["pes"] == len(main.processing_elements())


def test_lenet_pipeline_matches_the_reference_flow():
    out = lenet_pipeline.main(["--device", "cpu"])
    params = rinit_lenet()
    from repro.pipeline import (DeviceOffloadPass, InputToConstantPass,
                                StreamingCompositionPass)
    l1 = rlower(rbuild_lenet(100)).optimize([DeviceOffloadPass()])
    l2 = rlower(rbuild_lenet(100)).optimize(
        [InputToConstantPass(parameters=params), DeviceOffloadPass()])
    v_const = l2.sdfg.off_chip_volume()
    l2.optimize([StreamingCompositionPass()])
    assert out["volumes"] == (l1.sdfg.off_chip_volume(), v_const,
                              l2.sdfg.off_chip_volume())
    assert out["fused_regions"] == l2.compile(
        "pallas", cache=None).report["fused_regions"]
    assert out["probs"].shape == (100, 10)
    np.testing.assert_allclose(out["probs"].sum(1).numpy(), 1.0, rtol=1e-5)
