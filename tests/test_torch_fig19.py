"""The paper's Fig. 19 in the port against the reference package on the same
seeded numpy inputs: the star kernels' wrappers (``diffusion2d``,
``jacobi3d``, ``diffusion3d``) against the reference's Pallas kernels in
interpret mode at the shapes and tolerances of ``test_kernels.py`` and at
shapes the Pallas kernels' divisor search never sees; what the kernels
refuse, on the CPU as on the card; the port's Fig.-19 benchmark
(``repro_torch.benchmarks.stencil_bench``) against the reference's
``benchmarks/stencil_bench.py`` at the small sizes; and the port's
``stencil_pipeline`` example against the reference's flow. On the CPU the
wrappers run their plain versions and launch nothing; the CUDA kernels run
in ``test_torch_gpu.py`` and ``chip_smoke.py``."""
import ast
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from benchmarks import stencil_bench as ref_bench
from repro.frontends.stencil import build_stencil_program as rbuild
from repro.kernels import stencil as rstencil
from repro.pipeline import (DeviceOffloadPass as RDeviceOffloadPass,
                            StreamingCompositionPass as RStreamingPass,
                            lower as rlower)
from repro_torch.benchmarks import stencil_bench
from repro_torch.examples import stencil_pipeline
from repro_torch.kernels import build, stencil
from repro_torch.kernels.stencil import star

ROOT = Path(__file__).resolve().parents[1]
CO = np.array([0.2, 0.1, 0.15, 0.25, 0.3], np.float32)


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the wrappers against the reference's Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hw", [(64, 48), (128, 128), (65, 33), (1, 1),
                                (67, 129)])
def test_diffusion2d_matches_reference_kernel(hw):
    """``test_kernels.py::test_diffusion2d``'s shapes at its bh = 16 and
    rtol 1e-5 / atol 1e-6, and shapes without a useful divisor."""
    a = _field(hw, hw[0] * hw[1])
    before = stencil.diffusion2d.launches
    got = stencil.diffusion2d(torch.from_numpy(a), torch.from_numpy(CO))
    assert stencil.diffusion2d.launches == before    # CPU: plain, no launch
    want = rstencil.diffusion2d(a, CO, bh=16, interpret=True)
    assert got.dtype == torch.float32 and got.shape == hw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 12, 10), (1, 1, 1), (17, 13, 11),
                                   (5, 33, 7)])
@pytest.mark.parametrize("kind", ["jacobi3d", "diffusion3d"])
def test_3d_stars_match_reference_kernels(kind, shape):
    """``test_kernels.py::test_jacobi3d_and_diffusion3d``'s (16, 12, 10) at
    bd = 4 (rtol 1e-5; atol 1e-6 for jacobi3d, 1e-5 for diffusion3d), and
    odd shapes."""
    a = _field(shape, sum(shape))
    fn = getattr(stencil, kind)
    args = () if kind == "jacobi3d" else (0.1,)
    before = fn.launches
    got = fn(torch.from_numpy(a), *args)
    assert fn.launches == before
    want = getattr(rstencil, kind)(a, *args, bd=4, interpret=True)
    atol = 1e-6 if kind == "jacobi3d" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)


def test_diffusion3d_alpha_is_a_runtime_scalar():
    a = _field((9, 10, 11), 3)
    for alpha in (0.0, 0.05, 0.37):
        got = stencil.diffusion3d(torch.from_numpy(a), alpha)
        want = rstencil.diffusion3d(a, alpha, bd=3, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# what the kernels take
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["diffusion2d", "jacobi3d", "diffusion3d"])
@pytest.mark.parametrize("bad", ["float64", "bfloat16", "rank",
                                 "non_contiguous", "empty"])
def test_refusals_on_the_cpu(kind, bad):
    """A float32 contiguous non-empty field of the kernel's rank, or
    StencilLimitError, on the CPU as on the card; nothing counts."""
    rank = 2 if kind == "diffusion2d" else 3
    a = torch.zeros((6,) * rank)
    a = {"float64": a.double(), "bfloat16": a.bfloat16(),
         "rank": a[0] if rank == 3 else a[None],
         "non_contiguous": a.transpose(0, 1),
         "empty": a[:0]}[bad]
    fn = getattr(stencil, kind)
    args = (CO,) if kind == "diffusion2d" else ()
    before = fn.launches
    with pytest.raises(stencil.StencilLimitError):
        fn(a, *args)
    assert fn.launches == before


def test_diffusion2d_takes_five_coefficients():
    with pytest.raises(ValueError, match="5"):
        stencil.diffusion2d(torch.zeros(4, 4), [1.0, 2.0])


def test_source_names_the_kernels_it_replaces_and_the_tiles():
    src = (build.CSRC / "stencil_star.cu").read_text()
    for fn in ("diffusion2d", "jacobi3d", "diffusion3d"):
        assert f"::{fn}" in src
    assert "repro/kernels/stencil/kernel.py::diffusion2d" in src
    assert "3.35 TB/s" in src and "atomic" not in src.lower().replace(
        "no atomics", "")
    assert "stencil_star" in build.KERNELS and "stencil" in build.KERNELS
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert (int(consts["kTileH"]), int(consts["kTileW"])) == star.TILE_2D
    assert (int(consts["k3TY"]), int(consts["k3TX"])) == star.TILE_3D
    assert int(consts["k3BD"]) == star.CHUNK_3D


def test_paper_domains_fill_the_card():
    """The paper's domains, cut by the kernels' tiles, give thousands of
    blocks for 132 SMs."""
    (H, W), (th, tw) = stencil_bench.DOM2D, star.TILE_2D
    assert (H // th) * (W // tw) == 131_072
    (D, H, W), (ty, tx) = stencil_bench.DOM3D, star.TILE_3D
    assert (D // star.CHUNK_3D) * (H // ty) * (W // tx) == 32_768


# ---------------------------------------------------------------------------
# the Fig.-19 benchmark against the reference's
# ---------------------------------------------------------------------------
def _collect():
    lines = []

    def report(name, value, derived="", backend="jnp", **extra):
        lines.append({"name": name, "value": value, "derived": derived,
                      "backend": backend, **extra})
    return lines, report


@pytest.fixture(scope="module")
def port_run():
    lines, report = _collect()
    out = stencil_bench.run(report, small=True, device="cpu")
    return lines, out


def _reference_run_source():
    """The syntax tree of the reference benchmark's ``run``."""
    tree = ast.parse(Path(ref_bench.__file__).read_text())
    (run,) = [n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run"]
    return run


def _reference_report_names(run):
    """The names ``run`` reports, in source order: the string literal that
    opens each ``report(...)`` call."""
    calls = [n for n in ast.walk(run) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "report"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [n.args[0].value for n in calls]


def _reference_chain_spec(run, chain_dom):
    """The two-iteration diffusion spec ``run`` builds (its ``spec = {...}``)
    over ``chain_dom``."""
    (node,) = [n for n in ast.walk(run) if isinstance(n, ast.Assign)
               and [getattr(t, "id", None) for t in n.targets] == ["spec"]]
    code = compile(ast.Expression(node.value), ref_bench.__file__, "eval")
    return eval(code, {"chain_dom": list(chain_dom)})


@pytest.fixture(scope="module")
def ref_run():
    """What the reference benchmark reports at its small sizes, taken from
    the reference without timing anything (its ``run`` also races two
    interpret-mode runs on the host clock): the report names in order, and
    the two-iteration chain's fused regions and off-chip volumes before and
    after StreamingComposition, as its ``run`` builds the chain."""
    from repro.transforms import DeviceOffload, StreamingComposition
    run = _reference_run_source()
    sdfg = rbuild(_reference_chain_spec(run, [128, 64]))
    sdfg.apply(DeviceOffload)
    v0 = sdfg.off_chip_volume()
    sdfg.apply(StreamingComposition)
    v1 = sdfg.off_chip_volume()
    fused = rlower(sdfg).compile("pallas").report["fused_regions"]
    return {"names": _reference_report_names(run),
            "chain": (str(fused), v0, v1)}


def test_bench_reports_the_reference_names_in_order(port_run, ref_run):
    lines, _ = port_run
    assert [ln["name"] for ln in lines] == ref_run["names"]
    assert [ln["name"] for ln in lines] == chip_smoke.FIG19_NAMES
    assert all(ln["value"] > 0 for ln in lines)
    assert all("CPU" in ln["derived"] for ln in lines
               if ln["name"] != "stencil_star_jnp_ms")


def test_bench_draws_the_reference_inputs(port_run):
    """The reference's stream: default_rng(0), fields in its order."""
    _, out = port_run
    rng = np.random.default_rng(0)
    for key, shape in (("diffusion2d", (512, 128)), ("jacobi3d", (32, 16, 16)),
                       ("star", (34, 34)), ("chain", (128, 64))):
        want = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(out[key]["a"].numpy(), want)
    assert out["diffusion3d"]["a"] is out["jacobi3d"]["a"]


def _volumes(derived):
    m = re.search(r"fused=(\[.*?\]); volume (\d+)->(\d+) B", derived)
    return m.group(1), int(m.group(2)), int(m.group(3))


def test_bench_chain_fuses_and_streams_like_the_reference(port_run,
                                                           ref_run):
    lines, out = port_run
    ours = _volumes(lines[-1]["derived"])
    assert ours == ref_run["chain"]
    assert ours == ("['Stencil+Stencil']", 196_688, 131_152)
    assert out["chain"]["fused"] == ["Stencil+Stencil"]
    assert out["chain"]["volumes"] == (196_688, 131_152)


def test_bench_grid_kernels_are_the_references(port_run):
    """The reference asserts ['star_tiled'] and ['star']; the port's benchmark
    reaches the same lists (its tile follows the Hopper table)."""
    lines, out = port_run
    assert out["star"]["kernels"] == (["star_tiled"], ["star"])
    star_line = lines[3]
    assert star_line["backend"] == "cuda"
    assert star_line["block_shape"] == out["star"]["block_shape"]


def _reference_outputs(out):
    """The reference's kernels and programs on the benchmark's inputs, as the
    reference benchmark runs them at its small sizes."""
    from repro.pipeline import GridConversionPass, PassManager
    from repro.transforms import DeviceOffload, StreamingComposition
    a2 = out["diffusion2d"]["a"].numpy()
    a3 = out["jacobi3d"]["a"].numpy()
    sa = out["star"]["a"].numpy()
    ac = out["chain"]["a"].numpy()
    sn, sm = sa.shape
    tiled = rlower(ref_bench._star_sdfg(sn, sm)).compile("pallas")
    untiled = rlower(ref_bench._star_sdfg(sn, sm)).compile(
        "pallas", pipeline=PassManager([GridConversionPass()],
                                       name="star_untiled"))
    sdfg = rbuild(stencil_bench.chain_spec(ac.shape))
    sdfg.apply(DeviceOffload)
    sdfg.apply(StreamingComposition)
    chain = rlower(sdfg).compile("pallas")
    return {
        "diffusion2d": rstencil.diffusion2d(a2, CO, bh=128),
        "jacobi3d": rstencil.jacobi3d(a3, bd=8),
        "diffusion3d": rstencil.diffusion3d(a3, 0.1, bd=8),
        "star_tiled": tiled(a=sa)["b"], "star_untiled": untiled(a=sa)["b"],
        "chain": chain(a=ac, b_coeffs=CO, d_coeffs=CO)["d"]}


@pytest.fixture(scope="module")
def ref_outputs(port_run):
    return _reference_outputs(port_run[1])


@pytest.mark.parametrize("name,tol", [
    ("diffusion2d", (1e-5, 1e-6)), ("jacobi3d", (1e-5, 1e-6)),
    ("diffusion3d", (1e-5, 1e-5)), ("star_tiled", (1e-5, 1e-6)),
    ("star_untiled", (1e-5, 1e-6)), ("chain", (1e-4, 1e-5))])
def test_bench_outputs_match_the_reference(port_run, ref_outputs, name,
                                            tol):
    _, out = port_run
    key, field = {"star_tiled": ("star", "tiled"),
                  "star_untiled": ("star", "untiled")}.get(name, (name, "out"))
    got = out[key][field]
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_outputs[name]),
                               rtol=tol[0], atol=tol[1])


def test_bench_needs_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stencil_bench.run(lambda *a, **k: None, small=True)


def test_calibrate_reports_the_references_sweep():
    """The sublane sweep's names and block shapes equal the reference's at
    the small size; it only reports (CALIBRATED_TILES stays empty)."""
    from repro_torch.pipeline import GridConversionPass
    ours, report = _collect()
    stencil_bench.calibrate(report, small=True, device="cpu")
    theirs, ref_report = _collect()
    ref_bench.calibrate(ref_report, small=True)
    assert [ln["name"] for ln in ours] == [ln["name"] for ln in theirs]
    for a, b in zip(ours[:-1], theirs[:-1]):
        assert re.search(r"blocks (\[.*?\])", a["derived"]).group(1) == \
            re.search(r"blocks (\[.*?\])", b["derived"]).group(1)
    assert ours[-1]["value"] in (2, 4, 8, 16)
    assert GridConversionPass.CALIBRATED_TILES == {}


def test_bench_main_prints_csv(capsys):
    stencil_bench.main(["--small", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,value,derived"
    assert [ln.split(",")[0] for ln in out[1:]] == chip_smoke.FIG19_NAMES


# ---------------------------------------------------------------------------
# the stencil_pipeline example against the reference's flow
# ---------------------------------------------------------------------------
def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_stencil_example", ROOT / "examples" / "stencil_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    staged = rlower(rbuild(mod.PROGRAM))
    staged.optimize([RDeviceOffloadPass()])
    v0 = staged.sdfg.off_chip_volume()
    staged.optimize([RStreamingPass()])
    v1 = staged.sdfg.off_chip_volume()
    c = staged.compile("pallas")
    a = np.random.default_rng(0).standard_normal(
        tuple(mod.PROGRAM["dimensions"])).astype(np.float32)
    out = np.asarray(c(a=a, b_coeffs=CO, d_coeffs=CO)["d"])
    return mod.PROGRAM, c.report["fused_regions"], (v0, v1), out


def test_example_matches_the_reference_flow(capsys):
    program, fused, volumes, want = _reference_example()
    assert stencil_pipeline.PROGRAM == program
    got = stencil_pipeline.main(["--device", "cpu"])
    assert "OK" in capsys.readouterr().out
    assert got["fused_regions"] == fused == ["Stencil+Stencil"]
    assert got["volumes"] == volumes == (12_582_992, 8_388_688)
    np.testing.assert_allclose(got["out"].numpy(), want, rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# chip_smoke.py's checks of the stars
# ---------------------------------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    smoke = mod.Smoke()
    smoke.dev = torch.device("cpu")
    return mod, smoke


@pytest.mark.parametrize("slab", [1 << 9, 1 << 26])
def test_smoke_star_oracle_passes_the_stars_and_rejects_the_faults(
        slab, monkeypatch):
    """``chip_smoke.py``'s float64 oracle, slab by slab or whole, passes the
    three stars and fails its two planted faults: diffusion2d with c1 and
    c2 exchanged, jacobi3d launched a slab of planes at a time."""
    mod, smoke = _smoke()
    monkeypatch.setattr(mod, "SLAB_POINTS", slab)
    g = torch.Generator().manual_seed(5)
    a2, a3 = torch.randn(97, 45, generator=g), torch.randn(40, 9, 13,
                                                           generator=g)
    co = tuple(float(c) for c in CO)
    c0, c1, c2, c3, c4 = co
    for kind, a, params, n in (("diffusion2d", a2, co, 5),
                               ("jacobi3d", a3, None, 7),
                               ("diffusion3d", a3, 0.1, 7)):
        fn = getattr(stencil, kind)
        got = fn(a, *(() if params is None else (params,)))
        oracle = mod.star_oracle(kind, a.shape[0], params)
        assert smoke.slab_within(got, a, oracle, 1, n)[0], kind
    bad = stencil.diffusion2d(a2, (c0, c2, c1, c3, c4))
    assert not smoke.slab_within(
        bad, a2, mod.star_oracle("diffusion2d", 97, co), 1, 5)[0]
    bad = torch.cat([stencil.jacobi3d(a3[s:s + 16]) for s in (0, 16, 32)])
    assert not smoke.slab_within(
        bad, a3, mod.star_oracle("jacobi3d", 40, None), 1, 7)[0]


def test_smoke_chain_and_star_oracles_match_the_plain_programs():
    """The slab oracles of the star5 program and the two-iteration chain
    equal the plain versions (the boundary of b stays 0; each stage's
    outside is 0)."""
    mod, smoke = _smoke()
    mod.SLAB_POINTS = 1 << 8
    from repro_torch import programs
    from repro_torch.pipeline import lower
    g = torch.Generator().manual_seed(6)
    a = torch.randn(37, 19, generator=g)
    b = lower(programs.star5(37, 19)).compile("torch", device="cpu",
                                              cache=None)(a=a)["b"]
    assert smoke.slab_within(b, a, mod.star_oracle("star", 37, None), 1,
                             5)[0]
    co = [float(c) for c in CO]
    d = stencil.stencil2d_chain_ref(a, [co, co],
                                    [programs.DIFFUSION_OFFSETS] * 2)
    assert smoke.slab_within(d, a, mod.star_oracle("chain", 37, co), 2,
                             10)[0]
    assert not smoke.slab_within(d, a, mod.star_oracle("chain", 37, co[::-1]),
                                 2, 10)[0]
