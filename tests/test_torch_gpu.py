"""The port on the card: the CUDA kernels and the generated Triton grid
kernels against their plain versions. Every test here is marked ``gpu``
and skips without an NVIDIA GPU; the file imports no JAX, so it runs where
only PyTorch, Triton and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from collections import Counter

import pytest
import torch

import repro_torch.kernels  # noqa: F401  (registers the fusions)
from repro_torch import programs
from repro_torch.codegen import cuda_backend
from repro_torch.codegen.torch_backend import classify_arguments
from repro_torch.kernels import attention as t_attn
from repro_torch.kernels import axpydot as t_axpydot, dot as t_dot
from repro_torch.kernels import gemm as t_gemm, stencil as t_stencil
from repro_torch.kernels import rwkv as t_rwkv
from repro_torch.pipeline import lower
from repro_torch.transforms import MapFusion

def _limit(norm2, want, n):
    """The bound chip_smoke.py states: 4 eps32 sqrt(L) (||t||_2 + |want|)
    with L = max(1024, n // 16384) for a sum of n terms."""
    return 4 * 2.0 ** -23 * max(1024, n // 16384) ** 0.5 * (
        float(norm2) + abs(float(want)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1023, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_kernels_match_plain(cuda_device, n, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x, y, w = (torch.randn(n, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    x64, y64, w64 = x.double(), y.double(), w.double()
    before = t_axpydot.axpydot.launches
    got = t_axpydot.axpydot(0.7, x, y, w)
    assert t_axpydot.axpydot.launches == before + 1
    want = t_axpydot.axpydot_ref(0.7, x, y, w)
    norm2 = ((0.49 * x64 * x64 + y64 * y64) * w64 * w64).sum().sqrt()
    assert float((got - want).abs()) <= _limit(norm2, want, n)
    got = t_dot.dot(x, w)
    want = t_dot.dot_ref(x, w)
    norm2 = (x64 * x64 * w64 * w64).sum().sqrt()
    assert float((got - want).abs()) <= _limit(norm2, want, n)
    assert torch.equal(t_dot.dot(x, w), got)   # deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1023, 1_000_003, 209_715_200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_dot_matches_plain_and_repeats_bytes(cuda_device, n, dtype):
    """The dot kernel (4 blocks an SM, one launch, the last block sums
    the partials) against its plain version under the smoke's bound, and
    byte-identical across runs, up to the paper's N."""
    g = torch.Generator(device=cuda_device).manual_seed(n + 1)
    x, w = (torch.randn(n, generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    before = t_dot.dot.launches
    got = t_dot.dot(x, w)
    assert t_dot.dot.launches == before + 1
    want = t_dot.dot_ref(x, w)
    x64, w64 = x.double(), w.double()
    norm2 = (x64 * x64 * w64 * w64).sum().sqrt()
    assert float((got - want).abs()) <= _limit(norm2, want, n)
    assert float((got.double() - (x64 * w64).sum()).abs()) <= \
        _limit(norm2, want, n)
    for _ in range(3):
        assert torch.equal(t_dot.dot(x, w), got)


@pytest.mark.gpu
def test_on_gpu_dot_launch_failure_raises_without_a_fallback(cuda_device,
                                                              monkeypatch):
    """A launch whose C entry point returns an error raises: no plain
    version on a CUDA tensor, and no launch is counted."""
    from repro_torch.kernels.dot import kernel as k
    x = torch.randn(4096, device=cuda_device)
    monkeypatch.setattr(k, "_entry", lambda: (lambda *args: 700))
    before = t_dot.dot.launches
    with pytest.raises(RuntimeError, match="dot"):
        t_dot.dot(x, x)
    assert t_dot.dot.launches == before


@pytest.mark.gpu
def test_on_gpu_gemver_at_the_paper_n_within_the_smoke_bound(cuda_device):
    """GEMVER at N = 16,384, whose row maps split each window into ranges
    of chunks summed by a ``_final`` launch, against float64 under
    ``chip_smoke.py``'s elementwise bound, and byte-identical across
    runs. (A 16,384-term sum is too long for the other grid tests' fixed
    tolerance against the CPU's plain programs.)"""
    n = programs.GEMVER_N
    c = lower(programs.gemver(n)).compile("cuda", cache=None,
                                          expansion_level="generic")
    assert c.report["grid_kernels"] == ["ger0_map+ger1_map_tiled",
                                        "gemv0_rows_tiled",
                                        "gemv1_rows_tiled"]
    g = torch.Generator(device=cuda_device).manual_seed(16384)
    d = {k: torch.randn(*((n, n) if k == "A" else (n,)), generator=g,
                        device=cuda_device)
         for k in ("A", "u1", "v1", "u2", "v2", "y", "z")}
    got = c(**d)
    again = c(**d)
    for k in ("x_out", "w_out"):
        assert torch.equal(got[k], again[k])
    B = d["A"].double() + torch.outer(d["u1"].double(), d["v1"].double())
    B += torch.outer(d["u2"].double(), d["v2"].double())
    y, z, x = d["y"].double(), d["z"].double(), got["x_out"].double()
    B2 = B * B
    for out, want, norm2 in (
            (got["x_out"], 0.9 * B.T @ y + z,
             (0.81 * B2.T @ (y * y) + z * z).sqrt()),
            (got["w_out"], 1.1 * B @ x, 1.1 * (B2 @ (x * x)).sqrt())):
        limit = 4 * 2.0 ** -23 * 1024 ** 0.5 * (norm2 + want.abs())
        assert bool(((out.double() - want).abs() <= limit).all())


def _program(name):
    n = 4099
    if name == "axpydot_unfused":
        return (programs.axpydot(n),
                {"pipeline": programs.axpydot_grid_pipeline(False)})
    if name == "axpydot_fused":
        return (programs.axpydot(n),
                {"pipeline": programs.axpydot_grid_pipeline(True)})
    if name == "gemver":
        return programs.gemver(256), {"expansion_level": "generic"}
    if name == "gemver_ragged":     # 3 tiles, windows of 300
        return programs.gemver(300), {"expansion_level": "generic"}
    if name == "gemver_chain":
        return (programs.gemver_chain(256),
                {"pipeline": programs.gemver_chain_pipeline()})
    if name == "convblock":
        return programs.convblock(3), {}
    if name == "convblock_perstage":
        return (programs.convblock(3),
                {"pipeline": programs.perstage_pipeline()})
    if name == "jacobi_chain":
        return programs.jacobi_chain(4099 + 512), {}
    if name == "star5":
        return programs.star5(131, 67), {}
    # the two-phase kernel: a partial column tile, two full groups of four
    # reduction tiles a loop step, and a last group of one with a partial
    # row tile
    s = programs.rowsum_shift(*{"rowsum": (256, 192),
                                "rowsum_full_groups": (256, 1024),
                                "rowsum_partial_group": (300, 640)}[name])
    assert s.apply(MapFusion) == 1
    return s, {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["axpydot_unfused", "axpydot_fused",
                                  "gemver", "gemver_ragged",
                                  "gemver_chain", "rowsum",
                                  "rowsum_full_groups",
                                  "rowsum_partial_group",
                                  "convblock", "convblock_perstage",
                                  "jacobi_chain", "star5"])
def test_on_gpu_grid_kernels_match_plain(cuda_device, name):
    """The same compiled program on the card (generated Triton kernels) and
    on the CPU (their plain block programs)."""
    sdfg, kw = _program(name)
    c_gpu = lower(sdfg).compile("cuda", cache=None, **kw)
    c_cpu = lower(sdfg).compile("cuda", cache=None, device="cpu", **kw)
    assert c_gpu.report["grid_kernels"] == c_cpu.report["grid_kernels"]
    g = torch.Generator().manual_seed(7)
    args = {}
    for k in classify_arguments(sdfg)[0]:
        desc = sdfg.arrays[k]
        shape = tuple(int(s.as_int()) for s in getattr(desc, "shape", ()))
        args[k] = torch.randn(shape, generator=g)
    def counts():
        return Counter(cuda_backend.run_grid_kernel.launches_by_name) + \
            Counter(cuda_backend.run_two_phase.launches_by_name)

    before = counts()
    got = c_gpu(**args)
    assert counts() - before == Counter(c_gpu.report["grid_kernels"])
    want = c_cpu(**args)
    for k in want:
        assert got[k].is_cuda
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                   atol=1e-3)
        assert torch.equal(c_gpu(**args)[k], got[k])    # deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 1), (300, 200, 150),
                                   (64, 1000, 32), (577, 25, 6),
                                   (1000, 84, 10), (130, 256, 120),
                                   (20000, 72, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transposed", [False, True])
def test_on_gpu_matmul_matches_plain(cuda_device, shape, dtype, transposed):
    """The matmul kernel against its plain version at odd shapes, B as a
    contiguous matrix and as a transposed weight view (as Linear and
    Conv2d pass it), every activation; the reference's tolerances."""
    M, K, N = shape
    g = torch.Generator(device=cuda_device).manual_seed(M * K + N)
    a = torch.randn(M, K, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(N, K, generator=g, device=cuda_device).to(dtype)
    b = b.T if transposed else b.reshape(K, N)
    bias = torch.randn(N, generator=g, device=cuda_device)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
    which = t_gemm.kernel.route(a, b)
    # every fp32 product, and the bf16 layouts TMA cannot take (K = 25,
    # 1 x 1 x 1, rows of 150 or 84 elements), stay on the fma route
    tma = dtype == torch.bfloat16 and (shape, transposed) in {
        ((64, 1000, 32), False), ((64, 1000, 32), True),
        ((130, 256, 120), False), ((130, 256, 120), True),
        ((300, 200, 150), True), ((20000, 72, 40), False),
        ((20000, 72, 40), True)}
    assert which == ("wgmma" if tma else "fma")
    for act in (None, "relu", "silu", "gelu"):
        before = t_gemm.matmul.launches, t_gemm.matmul.routes[which]
        got = t_gemm.matmul(a, b, bias, activation=act)
        assert (t_gemm.matmul.launches, t_gemm.matmul.routes[which]) == (
            before[0] + 1, before[1] + 1)
        want = t_gemm.matmul_ref(a, b, bias, activation=act)
        assert got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


#: ragged bf16 products whose layouts TMA takes: no dimension a whole number
#: of 128 x 128 x 64 tiles, one a single tile, one wider than 32 tiles
WGMMA_SHAPES = [(1000, 520, 4104), (64, 64, 64), (4104, 256, 136)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_on_gpu_matmul_wgmma_route_matches_plain(cuda_device, shape,
                                                 transposed):
    """bf16 products that TMA can read take the wgmma route, with B
    N-major (a contiguous (K, N) matrix) and K-major (the ``W.T`` view of
    Linear and Conv2d), a bias and every activation; against the plain
    version at the bf16 tolerance of the test above."""
    M, K, N = shape
    g = torch.Generator(device=cuda_device).manual_seed(M + K * N)
    a = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
    b = torch.randn(N, K, generator=g, device=cuda_device).bfloat16()
    b = b.T if transposed else b.reshape(K, N)
    bias = torch.randn(N, generator=g, device=cuda_device)
    assert t_gemm.kernel.route(a, b) == "wgmma"
    for act in (None, "relu", "silu", "gelu"):
        before = t_gemm.matmul.routes["wgmma"]
        got = t_gemm.matmul(a, b, bias, activation=act)
        assert t_gemm.matmul.routes["wgmma"] == before + 1
        want = t_gemm.matmul_ref(a, b, bias, activation=act)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(1, 1), (31, 130), (1009, 777), (97, 4099)])
@pytest.mark.parametrize("stages", [
    (((0, 0), (-2, 1), (1, 2), (2, -1), (0, -2), (-1, -1)),),
    (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),) * 2,
    (((0, 0), (-2, 0), (2, 0)), ((0, 0), (0, 1)), ((1, 1), (-1, -1)))])
def test_on_gpu_stencils_match_plain(cuda_device, hw, stages):
    """stencil2d (one stage) and stencil2d_chain (2 and 3 stages of mixed
    radii) against their plain versions, prime and tiny fields."""
    g = torch.Generator(device=cuda_device).manual_seed(hw[0] * hw[1])
    a = torch.randn(*hw, generator=g, device=cuda_device)
    coeffs = [0.3 * torch.randn(len(o), generator=g, device=cuda_device)
              for o in stages]
    if len(stages) == 1:
        before = t_stencil.stencil2d.launches
        got = t_stencil.stencil2d(a, coeffs[0], stages[0])
        assert t_stencil.stencil2d.launches == before + 1
        want = t_stencil.stencil2d_ref(a, coeffs[0], stages[0])
    else:
        before = t_stencil.stencil2d_chain.launches
        got = t_stencil.stencil2d_chain(a, coeffs, stages)
        assert t_stencil.stencil2d_chain.launches == before + 1
        want = t_stencil.stencil2d_chain_ref(a, coeffs, stages)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


_DIFF = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
_SKEW = ((0, 0), (-2, 1), (1, 2), (2, -1), (0, -2), (-1, -1))
_FAR = ((0, 0), (-10, 0), (10, 0), (3, -7))


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(1009, 515), (1009, 777), (1013, 1024),
                                (131, 4096)])
@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 5, 6])
def test_on_gpu_stencil_routes_and_stage_counts(cuda_device, hw, n_stages):
    """The redesigned stencil kernel on both load routes (W = 515 and 777
    take cp.async, W a multiple of 4 TMA), a prime H, 1 to 6 stages of
    alternating radius 1 and 2 (dense windows), against the plain version
    (rtol 1e-5, atol 1e-5: taps summed in another order), byte-identical
    on a repeat, each launch counted on its route."""
    from repro_torch.kernels.stencil.kernel import route
    stages = ((_DIFF, _SKEW) * 3)[:n_stages]
    g = torch.Generator(device=cuda_device).manual_seed(hw[1] + n_stages)
    a = torch.randn(*hw, generator=g, device=cuda_device)
    coeffs = [0.3 * torch.randn(len(o), generator=g, device=cuda_device)
              for o in stages]
    fn = t_stencil.stencil2d_chain
    want = t_stencil.stencil2d_chain_ref(a, coeffs, stages)
    how = route(a)
    assert how == ("tma" if hw[1] % 4 == 0 else "cp.async")
    before = fn.launches, fn.routes[how]
    got = fn(a, coeffs, stages)
    assert (fn.launches, fn.routes[how]) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(fn(a, coeffs, stages), got)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(331, 300), (97, 515), (5, 3)])
def test_on_gpu_stencil_smallest_tile_and_tap_loop(cuda_device, hw):
    """Six radius-10 stages (a halo of 60: the smallest tile, several strip
    rounds a stage, the tap loop) and a stage with a duplicated offset,
    against the plain version; byte-identical repeats."""
    from repro_torch.kernels.stencil.kernel import MIN_TILE, plan
    g = torch.Generator(device=cuda_device).manual_seed(sum(hw))
    a = torch.randn(*hw, generator=g, device=cuda_device)
    for stages in ((_FAR,) * 6, (((0, 0), (0, 0), (1, -1)), _DIFF)):
        if stages[0] is _FAR:
            assert plan(stages)[:2] == MIN_TILE
        coeffs = [0.3 * torch.randn(len(o), generator=g, device=cuda_device)
                  for o in stages]
        got = t_stencil.stencil2d_chain(a, coeffs, stages)
        want = t_stencil.stencil2d_chain_ref(a, coeffs, stages)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(t_stencil.stencil2d_chain(a, coeffs, stages), got)


_ONE_SLAB = ((((0, 0), (-110, 3), (110, -5)),),
             (((0, 0), (-37, 2), (37, 0)), ((1, 0), (0, 38), (-3, -38))))


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(211, 300), (97, 515)])
def test_on_gpu_stencil_one_slab_halos(cuda_device, hw):
    """The halos that take one slab (no load in flight): one stage of
    radius 110 and a chain of summed radius 75, on both load routes,
    against the plain version; byte-identical repeats."""
    from repro_torch.kernels.stencil.kernel import layout
    g = torch.Generator(device=cuda_device).manual_seed(sum(hw))
    a = torch.randn(*hw, generator=g, device=cuda_device)
    for stages in _ONE_SLAB:
        assert layout(stages)["n_slabs"] == 1
        coeffs = [0.3 * torch.randn(len(o), generator=g, device=cuda_device)
                  for o in stages]
        got = t_stencil.stencil2d_chain(a, coeffs, stages)
        want = t_stencil.stencil2d_chain_ref(a, coeffs, stages)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(t_stencil.stencil2d_chain(a, coeffs, stages), got)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(64, 256), (61, 515)])
def test_on_gpu_stencil_non_finite_field(cuda_device, hw):
    """An inf or a NaN in the field reaches exactly the outputs whose taps
    name it, as in the plain version: a dense window skips the positions
    no tap names (the diffusion star's corners), so a diagonal neighbour
    of an inf stays finite."""
    g = torch.Generator(device=cuda_device).manual_seed(hw[1])
    a = torch.randn(*hw, generator=g, device=cuda_device)
    a[10, 10], a[20, 30], a[40, 7] = float("inf"), -float("inf"), \
        float("nan")
    for stages in ((_DIFF,), (_SKEW,), (_DIFF, _SKEW)):
        coeffs = [0.3 * torch.randn(len(o), generator=g, device=cuda_device)
                  for o in stages]
        got = t_stencil.stencil2d_chain(a, coeffs, stages)
        want = t_stencil.stencil2d_chain_ref(a, coeffs, stages)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.isinf(), want.isinf())
        assert torch.equal(got[want.isinf()], want[want.isinf()])
        fin = want.isfinite()
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-5)
        if stages == (_DIFF,):
            assert got[11, 11].isfinite() and got[9, 9].isfinite()
            assert got[10, 11].isinf() and got[41, 7].isnan()


@pytest.mark.gpu
def test_on_gpu_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros(64, 64, device=cuda_device)
    before = t_gemm.matmul.launches, t_stencil.stencil2d.launches
    with pytest.raises(ValueError):
        t_stencil.stencil2d(a.double(), [1.0], ((0, 0),))
    with pytest.raises(ValueError):
        t_gemm.matmul(a, a.to(torch.bfloat16))
    assert (t_gemm.matmul.launches, t_stencil.stencil2d.launches) == before


@pytest.mark.gpu
def test_on_gpu_matmul_launch_failure_raises_without_a_fallback(
        cuda_device, monkeypatch):
    """A launch whose C entry point returns an error raises: the wgmma
    route is not retried on the fma route or the plain version, and no
    launch is counted."""
    a = torch.randn(64, 64, device=cuda_device).bfloat16()
    assert t_gemm.kernel.route(a, a) == "wgmma"
    calls = []

    class Failing:
        def matmul_wgmma_launch(self, *args):
            calls.append("wgmma")
            return 700      # cudaErrorIllegalAddress

        def matmul_launch(self, *args):
            calls.append("fma")
            return 0

    monkeypatch.setattr(t_gemm.kernel, "_library", lambda: Failing())
    before = t_gemm.matmul.launches, dict(t_gemm.matmul.routes)
    with pytest.raises(RuntimeError, match="matmul"):
        t_gemm.matmul(a, a)
    assert calls == ["wgmma"]
    assert (t_gemm.matmul.launches, dict(t_gemm.matmul.routes)) == before


#: the Fig.-19 stars at shapes that are no whole tile: tiny, prime, wider
#: than a tile row, D a chunk and one plane
STAR2D_SHAPES = [(1, 1), (67, 129), (65, 33), (1009, 777), (97, 4099)]
STAR3D_SHAPES = [(1, 1, 1), (17, 13, 11), (5, 33, 7), (16, 12, 10),
                 (97, 130, 67), (65, 9, 4099)]


@pytest.mark.gpu
@pytest.mark.parametrize("hw", STAR2D_SHAPES)
def test_on_gpu_diffusion2d_matches_plain(cuda_device, hw):
    """diffusion2d against its plain version at test_kernels.py's rtol 1e-5
    / atol 1e-6; one launch a call; byte-identical repeats."""
    g = torch.Generator(device=cuda_device).manual_seed(hw[0] + hw[1])
    a = torch.randn(*hw, generator=g, device=cuda_device)
    co = (0.3 * torch.randn(5, generator=g, device=cuda_device)).tolist()
    before = t_stencil.diffusion2d.launches
    got = t_stencil.diffusion2d(a, co)
    assert t_stencil.diffusion2d.launches == before + 1
    want = t_stencil.diffusion2d_ref(a, co)
    assert got.is_cuda and got.shape == hw
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(t_stencil.diffusion2d(a, co), got)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", STAR3D_SHAPES)
@pytest.mark.parametrize("kind", ["jacobi3d", "diffusion3d"])
def test_on_gpu_3d_stars_match_plain(cuda_device, kind, shape):
    """jacobi3d (rtol 1e-5 / atol 1e-6) and diffusion3d (1e-5 / 1e-5, alpha
    0.1 and 0.37) against their plain versions; one launch a call;
    byte-identical repeats."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    a = torch.randn(*shape, generator=g, device=cuda_device)
    fn, ref = getattr(t_stencil, kind), getattr(t_stencil, f"{kind}_ref")
    for args in ([()] if kind == "jacobi3d" else [(0.1,), (0.37,)]):
        before = fn.launches
        got = fn(a, *args)
        assert fn.launches == before + 1
        atol = 1e-6 if kind == "jacobi3d" else 1e-5
        torch.testing.assert_close(got, ref(a, *args), rtol=1e-5, atol=atol)
        assert torch.equal(fn(a, *args), got)


@pytest.mark.gpu
def test_on_gpu_stars_refuse_what_the_kernels_do_not_take(cuda_device):
    """The CPU's StencilLimitError holds on the card: float64, bfloat16,
    the wrong rank, a non-contiguous field; nothing launches."""
    a2 = torch.zeros(64, 64, device=cuda_device)
    a3 = torch.zeros(8, 16, 32, device=cuda_device)
    co = [0.2, 0.1, 0.15, 0.25, 0.3]
    fns = (t_stencil.diffusion2d, t_stencil.jacobi3d, t_stencil.diffusion3d)
    before = [f.launches for f in fns]
    for bad in (a2.double(), a2.to(torch.bfloat16), a3, a2.T):
        with pytest.raises(t_stencil.StencilLimitError):
            t_stencil.diffusion2d(bad, co)
    for bad in (a3.double(), a3.to(torch.bfloat16), a2,
                a3.transpose(1, 2)):
        for fn in fns[1:]:
            with pytest.raises(t_stencil.StencilLimitError):
                fn(bad)
    assert [f.launches for f in fns] == before


#: (B, C, H, Dh, window): odd shapes, the serving shapes, a long context,
#: a sliding window
ATTN_SHAPES = [(3, 40, 5, 64, None), (64, 48, 24, 128, None),
               (8, 4096, 24, 128, None), (2, 2048, 8, 256, 1024)]


def _attn_inputs(device, B, C, H, Dh, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(*s, generator=g, device=device).to(dtype)
               for s in ((B, H, Dh), (B, C, H, Dh), (B, C, H, Dh)))
    # half the rows see a few positions (most of the bucket masked)
    pos = torch.randint(0, C, (B,), generator=g, device=device)
    pos[::2] = torch.randint(0, 4, (len(pos[::2]),), generator=g,
                             device=device)
    return q, k, v, pos.to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_decode_attention_matches_plain(cuda_device, shape, dtype):
    """decode_attention against its plain version: fp32 to rtol/atol
    1e-5 (the order of the softmax's sums), bf16 to one bf16 ulp of the
    output; deterministic repeats."""
    B, C, H, Dh, window = shape
    q, k, v, pos = _attn_inputs(cuda_device, B, C, H, Dh, dtype, C + H)
    before = t_attn.decode_attention.launches
    got = t_attn.decode_attention(q, k, v, pos, window=window)
    assert t_attn.decode_attention.launches == before + 1
    want = t_attn.decode_attention_ref(q, k, v, pos, window)
    assert got.dtype == dtype and got.shape == (B, H, Dh)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(t_attn.decode_attention(q, k, v, pos, window=window),
                       got)


@pytest.mark.gpu
def test_on_gpu_decode_attention_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 1, 128, device=cuda_device)
    k = torch.zeros(1, 60_000, 1, 128, device=cuda_device)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = t_attn.decode_attention.launches
    with pytest.raises(t_attn.DecodeAttentionLimitError):
        t_attn.decode_attention(q, k, k, pos)
    with pytest.raises(ValueError):
        t_attn.decode_attention(q, k[:, :8].double(), k[:, :8].double(), pos)
    assert t_attn.decode_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 40, 5, 64, None, "float32"),
                                   (16, 64, 4, 32, 7, "bfloat16"),
                                   (64, 48, 24, 128, None, "bfloat16")])
def test_on_gpu_attention_grid_kernel_matches_plain(cuda_device, shape):
    """The PagedAttnDecode ``cuda`` level's generated row kernel on the
    card against its plain block program on the CPU."""
    B, C, H, Dh, window, dt = shape
    sdfg = programs.decode_attention_program(B, C, H, Dh, window, dt)
    c_gpu = lower(sdfg).compile("cuda", cache=None)
    c_cpu = lower(sdfg).compile("cuda", cache=None, device="cpu")
    assert c_gpu.report["grid_kernels"] == ["attn0_grid_tiled"]
    q, k, v, pos = _attn_inputs(cuda_device, B, C, H, Dh,
                                getattr(torch, dt), B * C)
    before = cuda_backend.run_grid_kernel.launches_by_name.get(
        "attn0_grid_tiled", 0)
    got = c_gpu(q=q, k=k, v=v, pos=pos)["out"]
    assert cuda_backend.run_grid_kernel.launches_by_name[
        "attn0_grid_tiled"] == before + 1
    want = c_cpu(q=q.cpu(), k=k.cpu(), v=v.cpu(), pos=pos.cpu())["out"]
    tol = 2.0 ** -7 if dt == "bfloat16" else 1e-5
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(18, 100, 4, 128, 9, "float32"),
                                   (9, 100, 3, 128, None, "bfloat16"),
                                   (64, 64, 24, 128, None, "bfloat16"),
                                   (6, 32, 2, 128, 5, "float32")])
def test_on_gpu_attn_grid_kernel_at_mask_edges(cuda_device, shape):
    """The fused attention row kernel on the card against its plain block
    program on the CPU at every edge of the loop range (an all-masked row,
    past the context, at and one past a chunk edge, a window past 0 and
    one that admits nothing; several 32-row chunks at Dh = 128, and a
    context of one chunk),
    byte-identical on a repeat, and the kernel with its range one row short
    (ending at pos - 1) failing the comparison."""
    import re
    B, C, H, Dh, window, dt = shape
    sdfg = programs.decode_attention_program(B, C, H, Dh, window, dt)
    c_gpu = lower(sdfg).compile("cuda", cache=None)
    c_cpu = lower(sdfg).compile("cuda", cache=None, device="cpu")
    q, k, v, _ = _attn_inputs(cuda_device, B, C, H, Dh, getattr(torch, dt),
                              B + C)
    edges = [-1, 20, 31, 32, 63, 64, 0, 9, C - 1, C, C + 3, C + 20, 33]
    pos = torch.tensor((edges * B)[:B], dtype=torch.int32,
                       device=cuda_device)
    got = c_gpu(q=q, k=k, v=v, pos=pos)["out"]
    want = c_cpu(q=q.cpu(), k=k.cpu(), v=v.cpu(), pos=pos.cpu())["out"]
    tol = 2.0 ** -7 if dt == "bfloat16" else 1e-5
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(c_gpu(q=q, k=k, v=v, pos=pos)["out"], got)
    (kernel,) = {id(n.map): n.map.annotations["grid_kernel"]
                 for st in c_gpu.sdfg.states for n in st.nodes
                 if "grid_kernel" in getattr(getattr(n, "map", None),
                                             "annotations", {})}.values()
    bad, n = re.subn(r"(ri\d+) = tl\.minimum\(\1, (\d+)\)",
                     r"\1 = tl.minimum(\1, \2) - 1", kernel.source)
    assert n == 1
    outs = {"out": torch.zeros_like(got)}
    cuda_backend.launch_kernel(kernel.desc, bad, {"q": q, "k": k, "v": v,
                                                  "pos": pos}, outs)
    assert not torch.allclose(outs["out"].cpu().float(), want.float(),
                              rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("level", [None, "flash"])
def test_on_gpu_serving_streams_match_cpu(cuda_device, level):
    """Reduced starcoder2-3b in fp32 served on the card (generated attention
    kernels, or the hand kernel at the ``flash`` level) and on the CPU
    (their plain versions): the same greedy streams."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    from repro_torch.pipeline.cache import CompilationCache
    from repro_torch.serving import Scheduler
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (16, 6), generator=g).tolist()

    def serve(device, p):
        s = Scheduler(model, p, max_slots=16, page_size=8, n_pages=64,
                      max_model_len=64, prefill_chunk=8, device=device,
                      cache_dtype="float32", compile_cache=CompilationCache(),
                      expansion_level=level)
        for pr in prompts:
            s.submit(pr, 5)
        out = [r.tokens_out for r in s.run()]
        s.check_invariants()
        assert not s.compiler.events and s.n_fallback_steps == 0
        return out, s

    to_dev = lambda t: {k: (to_dev(v) if isinstance(v, dict) else
                            [to_dev(x) for x in v] if isinstance(v, list)
                            else v.to(cuda_device)) for k, v in t.items()}
    gpu, sched = serve(cuda_device, to_dev(params))
    cpu, _ = serve("cpu", params)
    assert gpu == cpu
    assert all(st.rung == "grid" for st in sched.compiler._steps.values())


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["no_kernel", "stale_labels"])
def test_on_gpu_attention_kernel_that_cannot_launch_raises(cuda_device,
                                                           monkeypatch,
                                                           fault):
    """On the card the serving ladder does not serve a step whose attention
    kernel is missing or stale from the interpreter: the GridLaunchError
    raises out of ``Scheduler.run``."""
    import dataclasses
    from repro_torch.codegen import cuda_backend
    from repro_torch.configs import get_config
    from repro_torch.core.sdfg import MapEntry, Tasklet
    from repro_torch.models import TransformerLM
    from repro_torch.pipeline.cache import CompilationCache
    from repro_torch.serving import Scheduler
    from repro_torch.serving import compile as serving_compile
    grid = serving_compile.DecodeStepCompiler._compile_grid

    def broken(self, B, ctx):
        step = grid(self, B, ctx)
        st, entry = next(
            (st, nd) for st in step.compiled.sdfg.states for nd in st.nodes
            if isinstance(nd, MapEntry)
            and cuda_backend.KERNEL_ANNOTATION in nd.map.annotations)
        if fault == "no_kernel":
            del entry.map.annotations[cuda_backend.KERNEL_ANNOTATION]
        else:
            next(n for n in st.scope_children()[entry]
                 if isinstance(n, Tasklet)).label += "_edited"
        return step

    monkeypatch.setattr(serving_compile.DecodeStepCompiler, "_compile_grid",
                        broken)
    cfg = get_config("starcoder2-3b").reduced()
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    s = Scheduler(model, params, max_slots=4, page_size=8, n_pages=16,
                  max_model_len=32, device=cuda_device, donate=False,
                  compile_cache=CompilationCache())
    for p in ([1, 2, 3], [4, 5]):
        s.submit(p, 3)
    with pytest.raises(cuda_backend.GridLaunchError):
        s.run()
    assert s.n_fallback_steps == 0 and not s.compiler.events


#: (B, S, H, hd): odd shapes, a narrower head, heads whose last block of
#: 64 value channels is short (40: one block with its last warp idle and
#: one half-filled; 202: rows not 16-byte aligned, plain loads), the
#: serving admission shape (one 16-token chunk of rwkv6-7b) and the
#: forward shape of chip_smoke.py
WKV_SHAPES = [(3, 48, 5, 64), (3, 48, 5, 32), (3, 48, 5, 40),
              (2, 32, 3, 202), (1, 16, 64, 64), (4, 1024, 64, 64)]


def _wkv_inputs(device, B, S, H, hd, seed):
    """Drawn as the reference's tests draw them: decays in the range the
    model produces, exp(-0.5 - 3 sigmoid)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (0.5 * torch.randn(B, S, H, hd, generator=g, device=device)
               for _ in range(3))
    w = torch.exp(-0.5 - 3.0 * torch.rand(B, S, H, hd, generator=g,
                                          device=device))
    u = 0.3 * torch.randn(H, hd, generator=g, device=device)
    s0 = 0.1 * torch.randn(B, H, hd, hd, generator=g, device=device)
    return r, k, v, w, u, s0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_on_gpu_wkv_chunked_matches_plain(cuda_device, shape, dtype,
                                          with_state):
    """wkv_chunked against its plain version on the same inputs, at the
    reference test's rtol/atol 3e-4 (plus one bf16 ulp of a bf16 output);
    the fp32 state at 3e-4; byte-identical repeats; one launch a call."""
    B, S, H, hd = shape
    r, k, v, w, u, s0 = _wkv_inputs(cuda_device, B, S, H, hd, S + hd)
    r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
    s0 = s0 if with_state else None
    before = t_rwkv.wkv_chunked.launches
    got, st = t_rwkv.wkv_chunked(r, k, v, w, u, s0)
    assert t_rwkv.wkv_chunked.launches == before + 1
    want, want_st = t_rwkv.wkv_chunked_ref(r, k, v, w, u, s0)
    assert got.dtype == dtype and st.dtype == torch.float32
    tol = 3e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, want_st, rtol=3e-4, atol=3e-4)
    again, st2 = t_rwkv.wkv_chunked(r, k, v, w, u, s0)
    assert torch.equal(again, got) and torch.equal(st2, st)


@pytest.mark.gpu
def test_on_gpu_wkv_chunked_refuses_what_it_does_not_take(cuda_device):
    """The refusals of the CPU (WKVLimitError for a head over the
    kernel's 256, ValueError for S % 16) hold on the card, and a dtype
    the kernel does not take raises; nothing launches."""
    z = torch.zeros(1, 16, 1, 257, device=cuda_device)
    before = t_rwkv.wkv_chunked.launches
    with pytest.raises(t_rwkv.WKVLimitError):
        t_rwkv.wkv_chunked(z, z, z, z, torch.zeros(1, 257,
                                                  device=cuda_device))
    r, k, v, w, u, s0 = _wkv_inputs(cuda_device, 1, 24, 2, 8, 0)
    with pytest.raises(ValueError, match="multiple"):
        t_rwkv.wkv_chunked(r, k, v, w, u)
    r, k, v, w = (x[:, :16] for x in (r, k, v, w))
    with pytest.raises(ValueError):
        t_rwkv.wkv_chunked(r.double(), k.double(), v.double(), w.double(), u)
    with pytest.raises(ValueError):
        t_rwkv.wkv_chunked(r, k, v, w, u, s0.double())
    with pytest.raises(ValueError):
        t_rwkv.wkv_chunked(r, k, v, w.cpu(), u)
    assert t_rwkv.wkv_chunked.launches == before


@pytest.mark.gpu
def test_on_gpu_rwkv_serving_whose_wkv_cannot_launch_raises(cuda_device,
                                                            monkeypatch):
    """A WKV kernel whose launch fails raises out of ``Scheduler.run`` (the
    chunked prefill of admission) instead of being served by its plain
    version; before that, the same run on the card serves the CPU's
    greedy streams (reduced rwkv6-7b, fp32, 16-token prefill chunks)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    from repro_torch.pipeline.cache import CompilationCache
    from repro_torch.serving import Scheduler
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (4, 36),
                            generator=torch.Generator().manual_seed(1))

    def serve(device, p):
        s = Scheduler(model, p, max_slots=4, page_size=8, n_pages=32,
                      max_model_len=64, prefill_chunk=16, device=device,
                      cache_dtype="float32", compile_cache=CompilationCache())
        for pr in prompts.tolist():
            s.submit(pr, 5)
        return s, [r.tokens_out for r in s.run()]

    on_card = {"layers": [{"rwkv": {k: v.to(cuda_device)
                                    for k, v in layer["rwkv"].items()}}
                          for layer in params["layers"]]}
    on_card.update({k: v.to(cuda_device) for k, v in params.items()
                    if k != "layers"})
    before = t_rwkv.wkv_chunked.launches
    s, gpu = serve(cuda_device, on_card)
    assert gpu == serve("cpu", params)[1]
    assert t_rwkv.wkv_chunked.launches - before == \
        4 * 2 * cfg.n_layers   # two 16-token chunks a prompt of 36
    assert not s.compiler.events and s.n_fallback_steps == 0

    class Refused:
        @staticmethod
        def wkv_chunked_launch(*args):
            return 1    # cudaErrorInvalidValue: the launch never ran

    monkeypatch.setattr(t_rwkv.kernel, "_entry",
                        lambda: Refused.wkv_chunked_launch)
    s = Scheduler(model, on_card, max_slots=4, page_size=8, n_pages=32,
                  max_model_len=64, prefill_chunk=16, device=cuda_device,
                  compile_cache=CompilationCache())
    s.submit(prompts[0].tolist(), 3)
    with pytest.raises(RuntimeError, match="wkv_chunked: CUDA error"):
        s.run()
    assert s.n_fallback_steps == 0 and not s.compiler.events


#: (B, Sq, Sk, Hq, Hkv, Dh, causal, window, q_offset): tiny, ragged (MHA),
#: Sq != Sk (MQA, GQA 4:1), q_offset != 0, each head width the configs
#: have, rows that admit no key, gemma3-4b's two prefill shapes and
#: starcoder2-3b's; a head not a multiple of the MMA's k = 8 (60), Dh = 256
#: ragged at every tile edge (Sq = 4,097, Sk = 1,000, q_offset 3,000) and a
#: window of one key a row
FLASH_CASES = [(1, 5, 5, 2, 1, 64, True, None, 0),
               (2, 97, 97, 4, 4, 64, True, None, 0),
               (1, 70, 200, 4, 1, 96, False, None, 0),
               (2, 200, 70, 8, 2, 112, True, 32, 0),
               (2, 100, 300, 4, 2, 128, True, 64, 200),
               (1, 600, 600, 4, 2, 256, True, 100, 0),
               (1, 96, 32, 4, 2, 64, False, 16, 0),
               (2, 4096, 4096, 8, 4, 256, True, 1024, 0),
               (2, 4096, 4096, 8, 4, 256, True, None, 0),
               (1, 4096, 4096, 24, 2, 128, True, None, 0),
               (2, 130, 150, 4, 2, 60, True, None, 0),
               (1, 4097, 1000, 2, 1, 256, True, None, 3000),
               (1, 300, 300, 4, 2, 256, True, 1, 0)]


def _flash_inputs(device, case, dtype):
    B, Sq, Sk, Hq, Hkv, Dh = case[:6]
    g = torch.Generator(device=device).manual_seed(Sq * Sk + Dh)
    return [torch.randn(B, S, H, Dh, generator=g, device=device).to(dtype)
            for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_flash_attention_matches_plain(cuda_device, case, dtype):
    """flash_attention against its plain version on the same inputs, at
    the reference kernel test's rtol/atol 2e-4 (plus one bf16 ulp of a
    bf16 output); byte-identical repeats; one launch a call."""
    q, k, v = _flash_inputs(cuda_device, case, dtype)
    kw = dict(causal=case[6], window=case[7], q_offset=case[8])
    before = t_attn.flash_attention.launches
    got = t_attn.flash_attention(q, k, v, **kw)
    assert t_attn.flash_attention.launches == before + 1
    want = t_attn.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(t_attn.flash_attention(q, k, v, **kw), got)


@pytest.mark.gpu
def test_on_gpu_flash_attention_keeps_fp32_parity(cuda_device):
    """At gemma3-4b's windowed prefill shape in fp32 the kernel (three tf32
    products a product) passes ``chip_smoke.py``'s attention limit and its
    fp32 parity: its largest error against float64 at most PARITY times
    the plain version's (run in true fp32)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke_mod)
    smoke = smoke_mod.Smoke()
    assert not torch.backends.cuda.matmul.allow_tf32
    case = (2, 4096, 4096, 8, 4, 256, True, 1024, 0)
    q, k, v = _flash_inputs(cuda_device, case, torch.float32)
    kw = dict(causal=True, window=1024, q_offset=0)
    got = t_attn.flash_attention(q, k, v, **kw)
    plain = t_attn.flash_attention_ref(q, k, v, **kw)
    want, tmax, a, count = smoke.flash_terms(q, k, v, **kw)
    assert smoke.flash_within(got, want, tmax, a, count, 0.0)[0]
    ok, ratio = smoke_mod.parity(got, plain, want)
    assert ok, f"fp32 parity {ratio:.3g} x"


@pytest.mark.gpu
def test_on_gpu_flash_attention_copies_a_misaligned_view(cuda_device):
    """Operands that start off a 4-element boundary (a contiguous view one
    element into its storage) give what aligned copies of them give."""
    q, k, v = _flash_inputs(cuda_device, (1, 40, 40, 2, 1, 64),
                            torch.float32)
    flat = torch.cat([torch.zeros(1, device=cuda_device), q.reshape(-1)])
    off = flat[1:].view(q.shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    got = t_attn.flash_attention(off, k, v)
    assert torch.equal(got, t_attn.flash_attention(q, k, v))


@pytest.mark.gpu
def test_on_gpu_flash_attention_refuses_what_it_does_not_take(cuda_device):
    """The CPU's refusals hold on the card (FlashAttentionLimitError for a
    head wider than 256 or not a multiple of 4, ValueError for Hq not a
    multiple of Hkv), and a
    dtype the kernel does not take or operands on two devices raise;
    nothing launches."""
    before = t_attn.flash_attention.launches
    for dh in (288, 62):
        z = torch.zeros(1, 8, 2, dh, device=cuda_device)
        with pytest.raises(t_attn.FlashAttentionLimitError):
            t_attn.flash_attention(z, z, z)
    q, k, v = _flash_inputs(cuda_device, (1, 8, 8, 2, 1, 64), torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        t_attn.flash_attention(q[:, :, :1].expand(1, 8, 3, 64).contiguous(),
                               torch.cat([k, k], 2), torch.cat([v, v], 2))
    with pytest.raises(ValueError):
        t_attn.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        t_attn.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        t_attn.flash_attention(q, k.cpu(), v)
    assert t_attn.flash_attention.launches == before


@pytest.mark.gpu
def test_on_gpu_chunked_forward_launches_flash_once_a_layer(cuda_device):
    """A reduced gemma3-4b forward with attention_impl="chunked" on the card
    launches flash_attention once a layer and gives the naive forward's
    logits (fp32, rtol/atol 1e-4)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    cfg = dataclasses.replace(get_config("gemma3-4b").reduced(),
                              activation_dtype="float32",
                              attention_impl="chunked")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 100), device=cuda_device)
    before = t_attn.flash_attention.launches
    got, _ = model.forward(params, {"tokens": toks})
    assert t_attn.flash_attention.launches == before + cfg.n_layers
    want, _ = TransformerLM(dataclasses.replace(
        cfg, attention_impl="naive")).forward(params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_on_gpu_flash_attention_that_cannot_launch_raises(cuda_device,
                                                          monkeypatch):
    """A flash kernel whose launch fails raises out of attention_chunked and
    attention(impl="cuda") instead of being served by its plain version."""
    from repro_torch.kernels import build
    from repro_torch.models import layers

    class Refused:
        @staticmethod
        def flash_attention_launch(*args):
            return 1    # cudaErrorInvalidValue: the launch never ran

    load = build.load
    monkeypatch.setattr(build, "load", lambda name: Refused
                        if name == "flash_attention" else load(name))
    q, k, v = _flash_inputs(cuda_device, (1, 16, 16, 2, 1, 64),
                            torch.float32)
    before = t_attn.flash_attention.launches
    with pytest.raises(RuntimeError, match="flash_attention: CUDA error 1"):
        layers.attention_chunked(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention: CUDA error 1"):
        layers.attention(q, k, v, impl="cuda")
    assert t_attn.flash_attention.launches == before
