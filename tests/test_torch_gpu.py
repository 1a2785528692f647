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


#: decode_attention at the mask's edges, on both sides of the split
#: (``kernel.plan``) and on every vector route (``kernel.route``): name ->
#: (B, C, H, Dh, window, pos, storage offset of k and v in elements); a C
#: or a window "least" is the longest range a few (b, h) rows leave
#: unsplit (one least chunk of the dtype), "least+1" the shortest they
#: split; Dh 16 takes four lanes a row, Dh 60 and 61 narrower vectors, Dh
#: 520 row slices, an offset narrower vectors too
DECODE_EDGES = {
    "pos_negative": (4, 300, 4, 128, None, [-1, -5, -1, -100], 0),
    "pos_past_context": (4, 300, 4, 128, None, [300, 299, 10 ** 6, 350], 0),
    "window_past_context": (4, 300, 4, 128, 200, [520, 600, 499, 10 ** 6],
                            0),
    "below_split": (2, "least", 4, 128, None, [-1, 40], 0),
    "above_split": (2, "least+1", 4, 128, None, [10 ** 6, 40], 0),
    "below_split_window": (3, 700, 4, 128, "least", [699, 60, -3], 0),
    "above_split_window": (2, 700, 4, 128, "least+1", [699, 60], 0),
    "long_split": (3, 5000, 4, 128, None, [4999, 2500, 7], 0),
    "dh256_window_split": (2, 2048, 8, 256, 1024, [2047, 1500], 0),
    "dh60_split": (2, 700, 3, 60, None, [699, 300], 0),
    "dh16": (2, 300, 3, 16, None, [299, 37], 0),
    "dh61": (2, 300, 3, 61, 20, [299, 37], 0),
    "dh520_slices": (2, 300, 3, 520, None, [299, 37], 0),
    "offset_1": (2, 300, 3, 128, None, [299, 37], 1),
    "offset_2": (2, 300, 3, 128, None, [299, 37], 2),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DECODE_EDGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_decode_attention_edges_and_split(cuda_device, name, dtype):
    """pos < 0 and past the context (the mean of V; every row), a window
    wholly past it, contexts and windows just below and above the split
    threshold, split long contexts, every vector width and the row
    slices, against the plain version as above; repeats byte-identical."""
    from repro_torch.kernels.attention import kernel as kern
    B, C, H, Dh, window, pos, offset = DECODE_EDGES[name]
    least = kern.MIN_CHUNK_BYTES // (2 * Dh * dtype.itemsize)
    C, window = (least + (x == "least+1") if isinstance(x, str) else x
                 for x in (C, window))
    if "split" in name:
        chunks = kern.plan(B, C, H, Dh, dtype, window).chunks
        assert (chunks == 1) == name.startswith("below_split")
    g = torch.Generator(device=cuda_device).manual_seed(C + Dh + offset)
    q = torch.randn(B, H, Dh, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(B * C * H * Dh + offset, generator=g,
                        device=cuda_device).to(dtype)[offset:]
            .view(B, C, H, Dh) for _ in range(2))
    vec = kern.route(q, k, v)[0]
    assert (vec < 16) == bool(offset or Dh * dtype.itemsize % 16)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    before = t_attn.decode_attention.launches
    got = t_attn.decode_attention(q, k, v, pos, window=window)
    assert t_attn.decode_attention.launches == before + 1
    want = t_attn.decode_attention_ref(q, k, v, pos, window)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for _ in range(2):
        assert torch.equal(t_attn.decode_attention(q, k, v, pos,
                                                   window=window), got)


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


#: gemma3-4b's served decode attention, 8 query heads over K/V gathered
#: from 4, Dh 256: bucket -> (B, C, positions) of serve_bench's bucket (its
#: last step) and of a run whose prompts of 1,040 tokens pass the
#: 1,024-token window (pos past the window, and the context's end)
GEMMA3_SERVED = {"serve_bucket": (64, 64, [38]),
                 "window_bucket": (8, 2048, [1062, 2047, 1500, 1040])}


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1024, None], ids=["windowed", "global"])
@pytest.mark.parametrize("bucket", sorted(GEMMA3_SERVED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_attention_kernels_at_gemma3_served_shapes(cuda_device,
                                                          bucket, window,
                                                          dtype):
    """decode_attention and the generated attention row kernel at
    gemma3-4b's two served shapes, a windowed and a global layer, against
    their plain versions (decode_attention_ref on the card; the row
    kernel's plain block program on the CPU): fp32 to 1e-5, bf16 to one
    bf16 ulp; repeats byte-identical."""
    B, C, pos = GEMMA3_SERVED[bucket]
    H, Hkv, Dh = 8, 4, 256
    g = torch.Generator(device=cuda_device).manual_seed(C + (window or 0))
    q = torch.randn(B, H, Dh, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(B, C, Hkv, Dh, generator=g, device=cuda_device)
            .repeat_interleave(H // Hkv, dim=2).to(dtype) for _ in range(2))
    pos = torch.tensor((pos * B)[:B], dtype=torch.int32, device=cuda_device)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    before = t_attn.decode_attention.launches
    got = t_attn.decode_attention(q, k, v, pos, window=window)
    assert t_attn.decode_attention.launches == before + 1
    want = t_attn.decode_attention_ref(q, k, v, pos, window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(t_attn.decode_attention(q, k, v, pos, window=window),
                       got)
    dt = str(dtype).removeprefix("torch.")
    sdfg = programs.decode_attention_program(B, C, H, Dh, window, dt)
    c_gpu = lower(sdfg).compile("cuda", cache=None)
    c_cpu = lower(sdfg).compile("cuda", cache=None, device="cpu")
    assert c_gpu.report["grid_kernels"] == ["attn0_grid_tiled"]
    before = cuda_backend.run_grid_kernel.launches_by_name.get(
        "attn0_grid_tiled", 0)
    got = c_gpu(q=q, k=k, v=v, pos=pos)["out"]
    assert cuda_backend.run_grid_kernel.launches_by_name[
        "attn0_grid_tiled"] == before + 1
    want = c_cpu(q=q.cpu(), k=k.cpu(), v=v.cpu(), pos=pos.cpu())["out"]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(c_gpu(q=q, k=k, v=v, pos=pos)["out"], got)


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
#: ragged at every tile edge (Sq = 4,097, Sk = 1,000, q_offset 3,000), a
#: window of one key a row, and seamless-m4t-medium's encoder (non-causal,
#: 1,024 frames) and cross-attention (512 text x 1,024 frames) at Dh 64
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
               (1, 300, 300, 4, 2, 256, True, 1, 0),
               (2, 1024, 1024, 16, 16, 64, False, None, 0),
               (2, 512, 1024, 16, 16, 64, False, None, 0)]


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


# ---------------------------------------------------------------------------
# The served decode step captured as CUDA graphs (serving/graphs.py)
# ---------------------------------------------------------------------------
#: (arch, prompt length, new tokens): gemma3-4b's reduced window is 16, so
#: its streams run past it
CAPTURE_ARCHS = [("starcoder2-3b", 6, 6), ("gemma3-4b", 14, 8),
                 ("rwkv6-7b", 6, 6)]


def _served(arch, dtype="float32", device=None, seed=0):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              activation_dtype=dtype)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device).manual_seed(seed))
    return model, params


def _serve(model, params, prompts, new, device, **kw):
    from repro_torch.pipeline.cache import CompilationCache
    from repro_torch.serving import Scheduler
    kw = {**dict(max_slots=8, page_size=8, n_pages=64, max_model_len=64,
                 prefill_chunk=8, cache_dtype="float32",
                 compile_cache=CompilationCache()), **kw}
    s = Scheduler(model, params, device=device, **kw)
    for p in prompts:
        s.submit(p, new)
    reqs = s.run()
    s.check_invariants()
    return [r.tokens_out for r in reqs], s


def _dense(model, params, prompts, new, device):
    """The dense decode_step loop, one prompt at a time (prompts differ in
    length), greedy."""
    out = []
    for p in prompts:
        cache = model.init_cache(1, len(p) + new, dtype=torch.float32,
                                 device=device)
        toks = torch.tensor([p], dtype=torch.int32, device=device)
        s = []
        for _ in range(new):
            logits, cache = model.decode_step(params, cache, toks)
            s.append(int(logits[0, -1].argmax()))
            toks = torch.tensor([[s[-1]]], dtype=torch.int32, device=device)
        out.append(s)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch,plen,new", CAPTURE_ARCHS)
def test_on_gpu_captured_step_streams_equal_eager_and_dense(cuda_device,
                                                            arch, plen, new,
                                                            monkeypatch):
    """fp32: every bucket is captured and replayed; each replay's logits
    equal the eager grid step's (``CompiledDecodeStep.eager``) on copies of
    the same inputs, and the replay counts the launches the eager step
    counts; the greedy streams equal the dense decode_step loop's."""
    from repro_torch.serving import graphs
    from repro_torch.serving.compile import CompiledDecodeStep
    model, params = _served(arch, device=cuda_device)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, model.cfg.vocab, (plen + i % 3,),
                             generator=g).tolist() for i in range(6)]
    key = lambda moved: sorted((getattr(w, "__name__", str(w)), a, str(n))
                               for w, a, n in moved)
    call = CompiledDecodeStep.__call__
    replays, launched = [], []

    def checked(step, kwargs):
        if step.captured is None:
            return call(step, kwargs)
        wrappers = graphs.counted_wrappers()
        before = graphs._snapshot(wrappers)
        want = step.eager({n: (kwargs[n].clone() if n in step.donate_names
                               else kwargs[n])
                           for n in step.arg_names})["logits"]
        eager = graphs._moved(before)
        before = graphs._snapshot(wrappers)
        out = call(step, kwargs)
        moved = graphs._moved(before)
        assert key(moved) == key(eager)
        assert torch.equal(out["logits"], want)
        replays.append(step)
        launched.append(bool(moved))
        return out
    monkeypatch.setattr(CompiledDecodeStep, "__call__", checked)
    got, s = _serve(model, params, prompts, new, cuda_device)
    assert not s.compiler.events and s.n_fallback_steps == 0
    steps = s.compiler._steps.values()
    assert all(st.rung == "grid" and st.captured is not None
               for st in steps)
    assert replays and s.stats()["logit_copies"] == 0
    # the attention archs' steps launch generated attention kernels;
    # rwkv6-7b's decode step converts no scope, so it counts none
    assert all(launched) == (arch != "rwkv6-7b")
    assert got == _dense(model, params, prompts, new, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-4b", "rwkv6-7b"])
def test_on_gpu_captured_bf16_step_within_limit_across_bucket_switch(
        cuda_device, arch):
    """bf16: replays of two buckets in turns (a, b, a, b) give the eager
    step's logits on the same inputs within 4 bf16 ulps of the row's
    largest logit, and a replay after a bucket switch repeats the first
    replay's logits and tokens exactly."""
    model, params = _served(arch, dtype="bfloat16", device=cuda_device)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, model.cfg.vocab, (5 + i,),
                             generator=g).tolist() for i in range(3)]
    _, s = _serve(model, params, prompts, 3, cuda_device,
                  cache_dtype="bfloat16")
    comp = s.compiler
    keep = {}
    for B in (4, 8):
        # the finished run's pages and states stand in for a live step's
        kw = s._step_kwargs(B, 16)
        kw["tokens"] = torch.randint(0, model.cfg.vocab, (B, 1),
                                     generator=g).to(cuda_device,
                                                     torch.int32)
        kw["positions"] = torch.full((B,), 9, dtype=torch.int32,
                                     device=cuda_device)
        kw["block_table"] = torch.arange(1, 1 + 2 * B, dtype=torch.int32,
                                         device=cuda_device).reshape(B, 2)
        keep[B] = {k: (v.clone() if k in comp._donate else v)
                   for k, v in kw.items()}

    def fresh(B):
        return {k: (v.clone() if k in comp._donate else v)
                for k, v in keep[B].items()}

    first = {}
    for rnd in range(2):
        for B in (4, 8):
            step = comp.step_for(B, 16)
            if step.captured is None:
                step(fresh(B))      # the bucket's first step, then capture
            lg = step(fresh(B))["logits"]
            want = step.eager(fresh(B))["logits"]
            lim = 4 * 2.0 ** -8 * want.float().abs().amax(-1, keepdim=True)
            assert bool(((lg.float() - want.float()).abs() <= lim).all())
            if rnd == 0:
                first[B] = lg
            else:
                assert torch.equal(lg, first[B])


#: the fault plans of tests/test_torch_serving_faults.py, by name
FAULT_PLANS = {
    "step_exception": dict(step_exception_at=1),
    "nan_logits": dict(nan_logits_at=2),
    "page_pressure": dict(page_pressure_at=1, page_pressure_release_at=8),
    "combined": dict(step_exception_at=1, page_pressure_at=2,
                     page_pressure_release_at=8, nan_logits_at=5),
    "compile_failure": dict(compile_fail_buckets="all",
                            compile_fail_times=2),
    "persistent_nan_lane": dict(nan_logits_at=1, nan_slots=(0,),
                                nan_persistent=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("plan", sorted(FAULT_PLANS))
def test_on_gpu_planted_faults_caught_with_capture(cuda_device, plan):
    """Every planted fault of the CPU fault tests, on the card with the
    captured step: the ladder catches it (fallback re-run from the live
    inputs, preemption, the compile ladder), and the streams of the
    requests it does not fail equal a fault-free captured run's."""
    from repro_torch.serving import FaultInjector, ServeFaultPlan
    model, params = _served("starcoder2-3b", device=cuda_device)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2]]
    geo = dict(max_slots=4, page_size=4, n_pages=32, max_model_len=32,
               prefill_chunk=4)
    base, _ = _serve(model, params, prompts, 8, cuda_device, **geo)
    inj = FaultInjector(ServeFaultPlan(**FAULT_PLANS[plan]))
    extra = {"max_failures": 2} if plan == "persistent_nan_lane" else {}
    out, s = _serve(model, params, prompts, 8, cuda_device, injector=inj,
                    **geo, **extra)
    st = s.stats()
    assert any(step.captured is not None
               for step in s.compiler._steps.values())
    if plan == "persistent_nan_lane":
        reasons = {r.rid: r.finish_reason for r in s.finished}
        assert reasons[0] == "failed"
        assert out[1:] == base[1:]
        return
    assert out == base
    if plan in ("step_exception", "combined"):
        assert st["fallback_steps"] >= 1
        assert s.watchdog.faults_of("step_exception")
    if plan in ("nan_logits", "combined"):
        assert s.watchdog.faults_of("nan_logits")
    if plan in ("page_pressure", "combined"):
        assert st["preemptions"] >= 1
    if plan == "compile_failure":
        kinds = [e["kind"] for e in s.compiler.events]
        assert {"compile_fallback", "compile_retry_failed",
                "compile_recovered"} <= set(kinds)


@pytest.mark.gpu
def test_on_gpu_recompute_under_donation_with_capture(cuda_device):
    """A planted step exception under donation takes the recompute rung
    (the pages are rebuilt, so the captured graphs read replaced arrays,
    copied in before the next replay) and the streams stay exact."""
    from repro_torch.serving import FaultInjector, ServeFaultPlan
    model, params = _served("starcoder2-3b", device=cuda_device)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2]]
    geo = dict(max_slots=4, page_size=4, n_pages=32, max_model_len=32,
               prefill_chunk=4)
    base, _ = _serve(model, params, prompts, 8, cuda_device, **geo)
    out, s = _serve(model, params, prompts, 8, cuda_device, donate=True,
                    injector=FaultInjector(ServeFaultPlan(
                        step_exception_at=3)), **geo)
    assert s.n_recomputes >= 1 and s.n_fallback_steps == 0
    assert out == base


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["capture", "replay"])
def test_on_gpu_failed_capture_raises_and_never_runs_eagerly(
        cuda_device, monkeypatch, where):
    """A capture or a replay that fails on the card raises out of
    ``Scheduler.run``: the ladder does not degrade it, and no later step
    runs op by op in its place."""
    from repro_torch.serving import compile as serving_compile
    from repro_torch.serving import graphs
    if where == "capture":
        def broken(self, body):
            raise RuntimeError("capture failed")
        monkeypatch.setattr(graphs.StepGraphs, "capture", broken)
    else:
        def broken(self, args):
            raise RuntimeError("replay failed")
        monkeypatch.setattr(graphs.CapturedStep, "__call__", broken)
    eager = []
    run = serving_compile.CompiledDecodeStep.eager

    def counted(self, args):
        eager.append(1)
        return run(self, args)
    monkeypatch.setattr(serving_compile.CompiledDecodeStep, "eager",
                        counted)
    model, params = _served("starcoder2-3b", device=cuda_device)
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        _serve(model, params, [[1, 2, 3], [4, 5]], 6, cuda_device,
               donate=False)
    assert len(eager) == 1     # the bucket's first step, before capture


# ---------------------------------------------------------------------------
# The MoE family (llama4-scout-17b-a16e, kimi-k2-1t-a32b)
# ---------------------------------------------------------------------------
def _moe_operands(device, T, D, E, F, top_k, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, T // 2, D, generator=g)
    router = torch.randn(D, E, generator=g) / D ** 0.5
    wg, wu = (torch.randn(E, D, F, generator=g) / D ** 0.5 for _ in range(2))
    wd = torch.randn(E, F, D, generator=g) / F ** 0.5
    shared = {k: torch.randn(*s, generator=g) / s[0] ** 0.5
              for k, s in (("w_gate", (D, F)), ("w_up", (D, F)),
                           ("w_down", (F, D)))}
    return x, router, wg, wu, wd, shared


@pytest.mark.gpu
@pytest.mark.parametrize("drop", [True, False], ids=["drop", "nodrop"])
@pytest.mark.parametrize("top_k", [1, 8])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_on_gpu_moe_block_matches_cpu(cuda_device, dispatch, top_k, drop):
    """moe_block on the card against the CPU at reduced width (T 256,
    D 256, 16 experts of F 512, a shared expert), fp32: the outputs at the
    reference's rtol/atol 2e-4, the aux loss at rtol 1e-5, the same routing
    (the top-k picks break ties toward the lower index on both devices),
    and no host synchronisation inside the block (the served step captures
    it as a CUDA graph)."""
    from repro_torch.models.layers import _top_k, moe_block
    x, router, wg, wu, wd, shared = _moe_operands("cpu", 256, 256, 16, 512,
                                                  top_k, 7 + top_k)
    kw = dict(top_k=top_k, capacity_factor=1.0, dispatch=dispatch,
              drop_tokens=drop)
    want, want_aux = moe_block(x, router, wg, wu, wd, shared=shared, **kw)
    dev = [t.to(cuda_device) for t in (x, router, wg, wu, wd)]
    dshared = {k: v.to(cuda_device) for k, v in shared.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = moe_block(*dev, shared=dshared, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=0)
    probs = torch.softmax(x.reshape(-1, 256) @ router, -1)
    probs[:, 3] = probs[:, 1]                       # ties
    assert torch.equal(_top_k(probs.to(cuda_device), top_k)[1].cpu(),
                       _top_k(probs, top_k)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_on_gpu_moe_step_captured_replay_equals_eager(cuda_device, dtype,
                                                      monkeypatch):
    """Reduced llama4-scout (4 MoE layers, top-1, a shared expert) served on
    the card: every bucket is captured, and each replay's logits are
    byte-identical to the eager step's on copies of the same inputs; fp32
    greedy streams equal the dense decode_step loop's."""
    from repro_torch.serving.compile import CompiledDecodeStep
    model, params = _served("llama4-scout-17b-a16e", dtype=dtype,
                            device=cuda_device)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, model.cfg.vocab, (6 + i % 3,),
                             generator=g).tolist() for i in range(6)]
    call = CompiledDecodeStep.__call__
    replays = []

    def checked(step, kwargs):
        if step.captured is None:
            return call(step, kwargs)
        want = step.eager({n: (kwargs[n].clone() if n in step.donate_names
                               else kwargs[n])
                           for n in step.arg_names})["logits"]
        out = call(step, kwargs)
        assert torch.equal(out["logits"], want)
        replays.append(step)
        return out
    monkeypatch.setattr(CompiledDecodeStep, "__call__", checked)
    got, s = _serve(model, params, prompts, 6, cuda_device,
                    cache_dtype=dtype)
    assert not s.compiler.events and s.n_fallback_steps == 0
    assert replays and all(st.rung == "grid" and st.captured is not None
                           for st in s.compiler._steps.values())
    if dtype == "float32":
        assert got == _dense(model, params, prompts, 6, cuda_device)


#: llama4-scout's attention heads: 40 query heads from 8 KV heads of 128
LLAMA4_HEADS = (40, 8, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(1, 300, 300, True, 0),
                                  (2, 2048, 2048, True, 0),
                                  (1, 97, 400, True, 303)],
                         ids=["odd", "forward", "offset"])
def test_on_gpu_moe_llama4_flash_attention_matches_plain(cuda_device, case,
                                                         dtype):
    """flash_attention at llama4-scout's grouping of 5 (Hq 40, Hkv 8,
    Dh 128) against its plain version, as FLASH_CASES are held."""
    B, Sq, Sk, causal, offset = case
    Hq, Hkv, Dh = LLAMA4_HEADS
    q, k, v = _flash_inputs(cuda_device, (B, Sq, Sk, Hq, Hkv, Dh), dtype)
    kw = dict(causal=causal, window=None, q_offset=offset)
    before = t_attn.flash_attention.launches
    got = t_attn.flash_attention(q, k, v, **kw)
    assert t_attn.flash_attention.launches == before + 1
    want = t_attn.flash_attention_ref(q, k, v, **kw)
    tol = 2e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(t_attn.flash_attention(q, k, v, **kw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C", [(64, 64), (3, 200)])
def test_on_gpu_moe_llama4_decode_attention_matches_plain(cuda_device, B, C,
                                                          dtype):
    """decode_attention and the generated attention row kernel at
    llama4-scout's served heads (H 40, K/V GQA-expanded from 8, Dh 128;
    B H = 2,560 at B 64, so the context is not split) against their plain
    versions: fp32 to 1e-5, bf16 to one bf16 ulp; repeats byte-identical."""
    H, Hkv, Dh = LLAMA4_HEADS
    g = torch.Generator(device=cuda_device).manual_seed(B * C)
    q = torch.randn(B, H, Dh, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(B, C, Hkv, Dh, generator=g, device=cuda_device)
            .repeat_interleave(H // Hkv, dim=2).to(dtype) for _ in range(2))
    pos = torch.randint(0, C, (B,), generator=g, device=cuda_device).to(
        torch.int32)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    before = t_attn.decode_attention.launches
    got = t_attn.decode_attention(q, k, v, pos)
    assert t_attn.decode_attention.launches == before + 1
    want = t_attn.decode_attention_ref(q, k, v, pos, None)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(t_attn.decode_attention(q, k, v, pos), got)
    dt = str(dtype).removeprefix("torch.")
    sdfg = programs.decode_attention_program(B, C, H, Dh, None, dt)
    c_gpu = lower(sdfg).compile("cuda", cache=None)
    c_cpu = lower(sdfg).compile("cuda", cache=None, device="cpu")
    assert c_gpu.report["grid_kernels"] == ["attn0_grid_tiled"]
    got = c_gpu(q=q, k=k, v=v, pos=pos)["out"]
    want = c_cpu(q=q.cpu(), k=k.cpu(), v=v.cpu(), pos=pos.cpu())["out"]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(c_gpu(q=q, k=k, v=v, pos=pos)["out"], got)


# ---------------------------------------------------------------------------
# The hybrid family (jamba-1.5-large-398b) and the VLM family (phi-3-vision)
# ---------------------------------------------------------------------------
def _mamba64(cfg, p, x, cache=None):
    """The Mamba block in float64, step by step over time, as
    ``blocks.mamba_apply`` computes it (no fp32 casts, no chunking)."""
    f64 = torch.float64
    p = {k: v.to(f64) for k, v in p.items()}
    x = x.to(f64)
    b, s, d = x.shape
    d_in, n, K = cfg.expand * d, cfg.d_state, cfg.d_conv
    h = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * \
        (1.0 + p["ln_scale"])
    xz = h @ p["w_in"]
    u, z = xz[..., :d_in], xz[..., d_in:]
    prev = cache["conv"].to(f64) if cache is not None else \
        torch.zeros((b, K - 1, d_in), dtype=f64, device=x.device)
    ue = torch.cat([prev, u], dim=1)
    u = torch.nn.functional.silu(
        sum(ue[:, i:i + s] * p["conv_w"][i] for i in range(K)))
    bcdt = u @ p["w_bcdt"]
    B_, C_ = bcdt[..., :n], bcdt[..., n:2 * n]
    dt = torch.nn.functional.softplus(bcdt[..., 2 * n:] + p["dt_bias"])
    ldA = (dt[..., None] * -torch.exp(p["A_log"])).clamp(-5.0, 0.0)
    dBu = dt[..., None] * B_[:, :, None, :] * u[..., None]
    state = cache["ssm"].to(f64) if cache is not None else \
        torch.zeros((b, d_in, n), dtype=f64, device=x.device)
    ys = []
    for t in range(s):
        state = torch.exp(ldA[:, t]) * state + dBu[:, t]
        ys.append((state * C_[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, 1) + p["D"] * u) * torch.nn.functional.silu(z)
    return x + y @ p["w_out"], {"conv": ue[:, -(K - 1):], "ssm": state}


@pytest.mark.gpu
@pytest.mark.parametrize("cached,s", [(False, 64), (False, 20), (True, 1),
                                      (True, 16)],
                         ids=["none-64", "none-20", "cache-1", "cache-16"])
def test_on_gpu_mamba_layer_matches_float64(cuda_device, cached, s):
    """A Mamba layer at d 1,024 (Din 2,048, N 16) on the card in fp32
    against the block in float64 (``_mamba64``): the output and the new
    cache at the reference's rtol/atol 2e-4 (``tests/test_wkv_ssm.py``);
    the chunked scan (S 64, 16), the step scan (20) and the one-step update
    (1), the last under ``set_sync_debug_mode("error")``: the served step
    captures it, so nothing in it may wait on the host."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              d_model=1024, d_state=16,
                              activation_dtype="float32")
    g = torch.Generator(device=cuda_device).manual_seed(s + cached)
    p = blocks.mamba_init(cfg, g)
    p["ln_scale"] = 0.1 * torch.randn(1024, generator=g, device=cuda_device)
    x = torch.randn(2, s, 1024, generator=g, device=cuda_device)
    cache = None
    if cached:
        cache = {"conv": torch.randn(2, cfg.d_conv - 1, 2048, generator=g,
                                     device=cuda_device),
                 "ssm": 0.1 * torch.randn(2, 2048, 16, generator=g,
                                          device=cuda_device)}
    torch.cuda.synchronize()
    if s == 1:
        torch.cuda.set_sync_debug_mode("error")
    try:
        got, nc = blocks.mamba_apply(cfg, p, x, cache=cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, wc = _mamba64(cfg, p, x, cache)
    torch.testing.assert_close(got.double(), want, rtol=2e-4, atol=2e-4)
    if cached:
        for key in ("conv", "ssm"):
            torch.testing.assert_close(nc[key].double(), wc[key], rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_on_gpu_jamba_step_captured_replay_equals_eager(cuda_device, dtype,
                                                        monkeypatch):
    """Reduced jamba (an attention layer, three Mamba layers, MoE every
    other layer) served on the card: every bucket is captured with its
    Mamba tasklets, each replay's logits are byte-identical to the eager
    step's on copies of the same inputs, and the fp32 greedy streams equal
    the dense decode_step loop's (prompts of 6 to 20 tokens in prefill
    chunks of 16: the chunked and the step scans)."""
    from repro_torch.serving.compile import CompiledDecodeStep
    model, params = _served("jamba-1.5-large-398b", dtype=dtype,
                            device=cuda_device)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, model.cfg.vocab, (6 + 7 * (i % 3),),
                             generator=g).tolist() for i in range(6)]
    call = CompiledDecodeStep.__call__
    replays = []

    def checked(step, kwargs):
        if step.captured is None:
            return call(step, kwargs)
        want = step.eager({n: (kwargs[n].clone() if n in step.donate_names
                               else kwargs[n])
                           for n in step.arg_names})["logits"]
        out = call(step, kwargs)
        assert torch.equal(out["logits"], want)
        replays.append(step)
        return out
    monkeypatch.setattr(CompiledDecodeStep, "__call__", checked)
    got, s = _serve(model, params, prompts, 6, cuda_device,
                    cache_dtype=dtype, prefill_chunk=16)
    assert not s.compiler.events and s.n_fallback_steps == 0
    assert replays and all(st.rung == "grid" and st.captured is not None
                           for st in s.compiler._steps.values())
    assert all(st.report["grid_kernels"] == ["attn0_grid_tiled"]
               for st in s.compiler._steps.values())
    if dtype == "float32":
        assert got == _dense(model, params, prompts, 6, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [96, 112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_attention_kernels_at_odd_head_widths(cuda_device, Dh,
                                                     dtype):
    """decode_attention (192- or 224-byte bf16 rows) and the generated
    attention row kernel (a power-of-two column range masked to Dh) at
    phi-3-vision's head width (96) and kimi-k2's (112), at serve_bench's
    bucket (B 64, C 64, pos 38) with a few rows at the context's edges,
    against their plain versions: fp32 to 1e-5, bf16 to one bf16 ulp;
    repeats byte-identical."""
    B, C, H = 64, 64, 32
    g = torch.Generator(device=cuda_device).manual_seed(Dh)
    q = torch.randn(B, H, Dh, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(B, C, H, Dh, generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    pos = torch.full((B,), 38, dtype=torch.int32, device=cuda_device)
    pos[:4] = torch.tensor([0, 31, 32, 63], dtype=torch.int32)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    before = t_attn.decode_attention.launches
    got = t_attn.decode_attention(q, k, v, pos)
    assert t_attn.decode_attention.launches == before + 1
    want = t_attn.decode_attention_ref(q, k, v, pos, None)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(t_attn.decode_attention(q, k, v, pos), got)
    dt = str(dtype).removeprefix("torch.")
    sdfg = programs.decode_attention_program(B, C, H, Dh, None, dt)
    c_gpu = lower(sdfg).compile("cuda", cache=None)
    c_cpu = lower(sdfg).compile("cuda", cache=None, device="cpu")
    assert c_gpu.report["grid_kernels"] == ["attn0_grid_tiled"]
    got = c_gpu(q=q, k=k, v=v, pos=pos)["out"]
    want = c_cpu(q=q.cpu(), k=k.cpu(), v=v.cpu(), pos=pos.cpu())["out"]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(c_gpu(q=q, k=k, v=v, pos=pos)["out"], got)


@pytest.mark.gpu
def test_on_gpu_phi3_stub_forward_matches_naive(cuda_device):
    """phi-3-vision at full width (d 3,072, 32 heads of Dh 96, vocab
    32,064) and 2 of its 32 layers, fp32, on 2 x (576 stub + 200 text)
    positions: the chunked forward (flash_attention at Dh 96, once a
    layer) returns the 200 text positions' logits, within 2^-12 of the
    row's largest |logit| of the naive forward (chip_smoke.py's forward
    limit)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, example_batch
    cfg = dataclasses.replace(get_config("phi-3-vision-4.2b"), n_layers=2,
                              activation_dtype="float32")
    chunked = TransformerLM(dataclasses.replace(cfg,
                                                attention_impl="chunked"))
    naive = TransformerLM(cfg)
    params = chunked.init(torch.Generator(cuda_device).manual_seed(0))
    batch = {k: torch.as_tensor(v, device=cuda_device)
             for k, v in example_batch(cfg, "train", 2, 200).items()}
    assert batch["stub_embeds"].shape == (2, 576, 3072)
    before = t_attn.flash_attention.launches
    got, _ = chunked.forward(params, batch)
    assert t_attn.flash_attention.launches == before + 2
    want, _ = naive.forward(params, batch)
    assert got.shape == want.shape == (2, 200, chunked.vocab_padded)
    got, want = got[..., :cfg.vocab], want[..., :cfg.vocab]
    lim = 2.0 ** -12 * want.abs().amax(-1, keepdim=True)
    assert bool(((got - want).abs() <= lim).all())


@pytest.mark.gpu
def test_on_gpu_encdec_reduced_chunked_matches_cpu(cuda_device):
    """The reduced seamless-m4t-medium (2 encoder + 4 decoder layers, d 128,
    Dh 32), fp32, attention_impl="chunked", on the card against its CPU
    run over the same weights (flash_attention against its plain
    version), at the flash kernel tests' rtol/atol 2e-4: the forward (one
    launch an encoder layer, two a decoder layer) and prefill_cache, a
    3-token decode_step and two single tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import EncDecLM, example_batch
    cfg = dataclasses.replace(get_config("seamless-m4t-medium").reduced(),
                              attention_impl="chunked",
                              activation_dtype="float32")
    model = EncDecLM(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    gpu = {k: ([{g: {n: t.to(cuda_device) for n, t in d.items()}
                 for g, d in layer.items()} for layer in v]
               if isinstance(v, list) else v.to(cuda_device))
           for k, v in cpu.items()}
    b_cpu = {k: torch.as_tensor(v)
             for k, v in example_batch(cfg, "train", 2, 12, seed=1).items()}
    b_gpu = {k: v.to(cuda_device) for k, v in b_cpu.items()}
    before = t_attn.flash_attention.launches
    got, _ = model.forward(gpu, b_gpu)
    assert t_attn.flash_attention.launches == before + 2 + 2 * 4
    want, _ = model.forward(cpu, b_cpu)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    caches = [model.prefill_cache(p, model.init_cache(
        2, 16, dtype=torch.float32, device=d), b["frames"])
        for p, b, d in ((gpu, b_gpu, cuda_device), (cpu, b_cpu, "cpu"))]
    for lo, hi in ((0, 3), (3, 4), (4, 5)):
        outs = []
        for i, (p, b) in enumerate(((gpu, b_gpu), (cpu, b_cpu))):
            lg, caches[i] = model.decode_step(p, caches[i],
                                              b["tokens"][:, lo:hi])
            outs.append(lg.cpu())
        torch.testing.assert_close(outs[0], outs[1], rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_on_gpu_chip_smoke_seamless_phases_at_a_reduced_size(cuda_device):
    """chip_smoke.py's enc-dec phases on the reduced seamless-m4t-medium
    (2 x (8 frames + 12 tokens), 6 requests): the forward and both decode
    runs within their limits, both planted faults (a causal encoder, a
    cache written one position late) outside them, and flash_attention
    measured at the three attention shapes in fp32 and bf16."""
    import importlib.util
    from pathlib import Path
    from repro_torch.configs import get_config
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke_mod)
    smoke = smoke_mod.Smoke()
    smoke.seamless_config = get_config("seamless-m4t-medium").reduced()
    smoke.seamless_batch, smoke.seamless_text = 2, 12
    smoke.seamless_requests = 6
    fwd = smoke.forward_seamless()
    assert fwd["flash_attention_launches"] == 10
    assert fwd["logits_x_limit"] <= 1 < fwd["causal_encoder_x_limit"]
    dec = smoke.decode_seamless()
    assert dec["fp32"]["logits_x_limit"] <= 1
    assert dec["fp32"]["late_cache_x_limit"] > 1
    assert dec["bf16"]["logits_x_limit"] <= 1
    assert dec["bf16"]["repeat_byte_identical"]
    rows = smoke.measure_seamless_attention()
    assert set(rows) == {f"{k}{s}" for k in ("encoder", "cross", "self")
                         for s in ("", "_bf16")}
    assert len(smoke.faults) == 2


# ---------------------------------------------------------------------------
# The training path: the backward kernels of flash_attention and wkv_chunked
# ---------------------------------------------------------------------------
def _close_to_max(got, want, tol, floor=0.0):
    """|got - want| <= tol (max |want| + |want|) + floor elementwise, in
    float64."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    assert bool(((got - want).abs() <= tol * (scale + want.abs()) + floor
                 ).all()), \
        f"{float((got - want).abs().max()):.3g} against {tol} x {scale:.3g}"


#: the backward's tile edges (64-row and 64-key resident tiles, 32 or 64
#: streamed): Sq and Sk at 63, 64, 65, 127 and 129; rep 12 (starcoder2-3b's
#: heads) and rep 1; Dh 60, 96, 112 (with a window) and 256 (with
#: q_offset); rows that admit no key, past a window and before key 0
BWD_EDGE_CASES = [(1, 63, 63, 2, 1, 64, True, None, 0),
                  (2, 64, 64, 4, 2, 64, True, None, 0),
                  (1, 65, 65, 2, 2, 128, True, None, 0),
                  (1, 127, 129, 4, 1, 96, False, None, 0),
                  (2, 129, 127, 4, 2, 128, True, None, 2),
                  (1, 129, 129, 24, 2, 128, True, None, 0),
                  (1, 129, 63, 24, 2, 128, False, None, 0),
                  (2, 127, 65, 4, 2, 112, True, 48, 0),
                  (1, 65, 129, 2, 1, 256, True, 40, 64),
                  (1, 200, 129, 2, 1, 256, True, None, 100),
                  (1, 64, 127, 4, 4, 60, False, 16, 0),
                  (1, 65, 129, 2, 1, 64, True, 32, 150),
                  (2, 127, 65, 4, 2, 64, True, None, -70)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES + BWD_EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_flash_attention_bwd_matches_plain(cuda_device, case, dtype):
    """The backward kernel against its plain version on the same q, k, v,
    forward output, log-sum-exp and dout: each gradient within 1e-4 of its
    largest magnitude in fp32 (2^-7 more in bf16, one rounding of the
    output), plus, for dq and dk, the rounding of dS = P (dP - D), which
    cancels where a row admits one key (a window of 1: dS is 0 exactly and
    both versions give noise): 4 eps32 sqrt(Sk) max|dO| max|V| max|K| /
    sqrt(Dh); one count a call; byte-identical repeats."""
    from repro_torch.kernels.attention import flash as t_flash
    q, k, v = _flash_inputs(cuda_device, case, dtype)
    kw = dict(causal=case[6], window=case[7], q_offset=case[8])
    out, lse = t_flash._forward(q, k, v, kw["causal"], kw["window"],
                                kw["q_offset"], True)
    want_out, want_lse = t_attn.ref.flash_attention(q, k, v, **kw,
                                                    return_lse=True)
    some = t_attn.ref.admitted_rows(case[1], case[2], kw["causal"],
                                    kw["window"], kw["q_offset"],
                                    cuda_device)
    torch.testing.assert_close(lse[..., some], want_lse[..., some],
                               rtol=1e-4, atol=1e-4)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    dout = torch.randn(q.shape, generator=g, device=cuda_device).to(dtype)
    before = t_attn.flash_attention_bwd.launches
    got = t_attn.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert t_attn.flash_attention_bwd.launches == before + 1
    want = t_attn.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    tol = 1e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    floor = 4 * 2.0 ** -23 * case[2] ** 0.5 * float(
        dout.abs().max() * v.abs().max() * k.abs().max()) / case[5] ** 0.5
    for a, b, f in zip(got, want, (floor, floor, 0.0)):
        assert a.dtype == dtype and a.shape == b.shape
        _close_to_max(a, b, tol, f)
    again = t_attn.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_flash_attention_bwd_launches_every_head_class_in_turn(
        cuda_device, dtype):
    """The backward at heads of 256, 192, 128, 64 and 256 again, in one
    process: each instance asks for its own shared memory (instances of
    one signature share no opt-in), and each result holds its plain
    version at the limits of the test above."""
    for dh in (256, 192, 128, 64, 256):
        case = (1, 70, 70, 4, 2, dh, True, None, 0)
        q, k, v = _flash_inputs(cuda_device, case, dtype)
        out, lse = t_attn.flash._forward(q, k, v, True, None, 0, True)
        dout = torch.randn_like(q.float()).to(dtype)
        got = t_attn.flash_attention_bwd(q, k, v, out, lse, dout)
        want = t_attn.flash_attention_bwd_ref(q, k, v, out, lse, dout)
        tol = 1e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
        floor = 4 * 2.0 ** -23 * 70 ** 0.5 * float(
            dout.abs().max() * v.abs().max() * k.abs().max()) / dh ** 0.5
        for a, b, f in zip(got, want, (floor, floor, 0.0)):
            _close_to_max(a, b, tol, f)


#: the backward's shapes: the forward's odd ones, rwkv6-7b's training layer,
#: and sequences that end mid-span (spans of 32 positions up to hd 128,
#: 16 above: S 16, 48 and 80 at hd 40 and 128) and the widest heads (hd
#: 202 and 256, one chunk a span)
WKV_BWD_SHAPES = WKV_SHAPES[:5] + [(1, 4096, 64, 64), (2, 16, 3, 40),
                                   (2, 80, 3, 40), (1, 48, 2, 128),
                                   (1, 48, 2, 202), (1, 80, 2, 256),
                                   (2, 16, 2, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WKV_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_on_gpu_wkv_chunked_bwd_matches_plain(cuda_device, shape, dtype,
                                              with_state):
    """The WKV backward kernel against its plain version on the same
    operands, dout and final-state gradient: each gradient within 3e-4 of
    its largest magnitude in fp32 (2^-7 more in bf16); dw 0 where w is
    under the 1e-8 clamp; one count a call; byte-identical repeats."""
    B, S, H, hd = shape
    r, k, v, w, u, s0 = _wkv_inputs(cuda_device, B, S, H, hd, S + hd)
    w[0, 3, 0, :2] = 1e-9          # under the forward's clamp
    r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
    s0 = s0 if with_state else None
    g = torch.Generator(device=cuda_device).manual_seed(11)
    dout = torch.randn(r.shape, generator=g, device=cuda_device).to(dtype)
    dstate = torch.randn((B, H, hd, hd), generator=g, device=cuda_device)
    before = t_rwkv.wkv_chunked_bwd.launches
    got = t_rwkv.wkv_chunked_bwd(r, k, v, w, u, s0, dout, dstate)
    assert t_rwkv.wkv_chunked_bwd.launches == before + 1
    want = t_rwkv.wkv_chunked_bwd_ref(r, k, v, w, u, s0, dout, dstate)
    tol = 3e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                          want):
        assert a.shape == b.shape, name
        _close_to_max(a, b.to(a.dtype), tol if name != "du" else 3e-4)
    assert bool((got[3][0, 3, 0, :2] == 0).all())
    again = t_rwkv.wkv_chunked_bwd(r, k, v, w, u, s0, dout, dstate)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_gpu_wkv_chunked_bwd_launches_every_head_class_in_turn(
        cuda_device, dtype):
    """The WKV backward at heads of 256, 128, 64, 32, 202 and 256 again (both
    span lengths, 16 and 32 positions, at their widest and narrowest heads
    in turn) in one process: each
    kernel instance asks for its own shared memory, and each result holds
    its plain version at the limits of the test above."""
    for i, hd in enumerate((256, 128, 64, 32, 202, 256)):
        r, k, v, w, u, s0 = _wkv_inputs(cuda_device, 1, 48, 2, hd, 90 + i)
        r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
        g = torch.Generator(device=cuda_device).manual_seed(i)
        dout = torch.randn(r.shape, generator=g, device=cuda_device).to(dtype)
        dstate = torch.randn((1, 2, hd, hd), generator=g, device=cuda_device)
        got = t_rwkv.wkv_chunked_bwd(r, k, v, w, u, s0, dout, dstate)
        want = t_rwkv.wkv_chunked_bwd_ref(r, k, v, w, u, s0, dout, dstate)
        tol = 3e-4 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
        for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                              want):
            _close_to_max(a, b.to(a.dtype), tol if name != "du" else 3e-4)


@pytest.mark.gpu
def test_on_gpu_chunked_attention_and_wkv_gradients_equal_the_plain(
        cuda_device):
    """A loss through ``layers.attention_chunked`` and through
    ``blocks._wkv_chunked`` on CUDA tensors gets the gradients that autograd
    through the plain versions gives on the same CUDA tensors (rtol/atol
    1e-4 of the largest), and the kernels launched forward and backward
    once each."""
    from repro_torch.models import blocks, layers
    q, k, v = _flash_inputs(cuda_device, (2, 200, 200, 8, 2, 64),
                            torch.float32)
    for t in (q, k, v):
        t.requires_grad_(True)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    weight = torch.randn(q.shape, generator=g, device=cuda_device)
    fwd, bwd = t_attn.flash_attention.launches, \
        t_attn.flash_attention_bwd.launches
    got = torch.autograd.grad((layers.attention_chunked(
        q, k, v, window=50) * weight).sum(), (q, k, v))
    assert t_attn.flash_attention.launches == fwd + 1
    assert t_attn.flash_attention_bwd.launches == bwd + 1
    want = torch.autograd.grad((t_attn.flash_attention_ref(
        q, k, v, window=50) * weight).sum(), (q, k, v))
    for a, b in zip(got, want):
        _close_to_max(a, b, 1e-4)
    xs = list(_wkv_inputs(cuda_device, 2, 64, 4, 64, 5))
    for t in xs:
        t.requires_grad_(True)
    weight = torch.randn(xs[0].shape, generator=g, device=cuda_device)
    fwd, bwd = t_rwkv.wkv_chunked.launches, t_rwkv.wkv_chunked_bwd.launches
    out, st = blocks._wkv_chunked(*xs)
    got = torch.autograd.grad((out * weight).sum() + st.square().sum(), xs)
    assert t_rwkv.wkv_chunked.launches == fwd + 1
    assert t_rwkv.wkv_chunked_bwd.launches == bwd + 1
    out, st = t_rwkv.wkv_chunked_ref(*xs)
    want = torch.autograd.grad((out * weight).sum() + st.square().sum(), xs)
    for a, b in zip(got, want):
        _close_to_max(a, b, 3e-4)


def _directional(fn, xs, grads, seed, eps=1e-2):
    """Central differences of ``fn`` (a float64 scalar of fp32 inputs) along
    a random direction against the gradients' projection on it."""
    g = torch.Generator(device=xs[0].device).manual_seed(seed)
    ds = [torch.randn(x.shape, generator=g, device=x.device) for x in xs]
    with torch.no_grad():
        hi = fn([x + eps * d for x, d in zip(xs, ds)])
        lo = fn([x - eps * d for x, d in zip(xs, ds)])
    fd = (hi - lo) / (2 * eps)
    an = sum(float((gr.double() * d.double()).sum())
             for gr, d in zip(grads, ds))
    return float(fd), an


@pytest.mark.gpu
def test_on_gpu_backward_kernels_pass_finite_differences(cuda_device):
    """At a tiny shape, each fp32 kernel's gradient projected on three
    random directions matches central differences of its forward kernel
    (eps 1e-2, within 1e-2 relative)."""
    q, k, v = _flash_inputs(cuda_device, (1, 20, 24, 2, 1, 8, True, 6, 3),
                            torch.float32)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    weight = torch.randn(q.shape, generator=g, device=cuda_device)

    def attn(ts):
        return (t_attn.flash_attention(*ts, window=6, q_offset=3).double()
                * weight).sum()
    xs = [q, k, v]
    for t in xs:
        t.requires_grad_(True)
    grads = torch.autograd.grad(attn(xs), xs)
    for seed in range(3):
        fd, an = _directional(attn, [x.detach() for x in xs], grads, seed)
        assert abs(fd - an) <= 1e-2 * max(1.0, abs(an)), (fd, an)
    xs = list(_wkv_inputs(cuda_device, 1, 32, 2, 8, 2))
    weight = torch.randn(xs[0].shape, generator=g, device=cuda_device)

    def wkv(ts):
        out, st = t_rwkv.wkv_chunked(*ts)
        return (out.double() * weight).sum() + st.double().sum()
    for t in xs:
        t.requires_grad_(True)
    grads = torch.autograd.grad(wkv(xs), xs)
    for seed in range(3):
        fd, an = _directional(wkv, [x.detach() for x in xs], grads, seed)
        assert abs(fd - an) <= 1e-2 * max(1.0, abs(an)), (fd, an)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-7b",
                                  "seamless-m4t-medium"])
def test_on_gpu_train_step_matches_cpu(cuda_device, arch):
    """Three steps of ``make_train_step`` (remat on, chunked attention) on
    the card against the same steps on the CPU from the same weights and
    batches: losses and grad norms within 1e-4 relative, and every
    parameter leaf updated."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    from repro_torch.models import example_batch
    from repro_torch.optim import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              activation_dtype="float32",
                              attention_impl="chunked")
    step, model, opt = make_train_step(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.detach().clone().to(dev), params)
        state = {"params": p, "opt": opt.init(p),
                 "step": torch.zeros((), dtype=torch.int32)}
        log = []
        for i in range(3):
            batch = {kk: torch.as_tensor(vv, device=dev) for kk, vv in
                     example_batch(cfg, "train", 2, 32, seed=i).items()}
            state, m = step(state, batch)
            log.append((float(m["loss"]), float(m["grad_norm"])))
        runs[str(dev)] = (log, state)
    (cpu_log, _), (gpu_log, gpu_state) = runs.values()
    for (a, b), (c, d) in zip(gpu_log, cpu_log):
        assert abs(a - c) <= 1e-4 * abs(c) and abs(b - d) <= 1e-4 * abs(d)
    moved = [bool((a.detach().cpu() != b).any()) for a, b in zip(
        tree_leaves(gpu_state["params"]), tree_leaves(params))]
    assert all(moved)


@pytest.mark.gpu
def test_on_gpu_backward_kernel_that_cannot_launch_raises(cuda_device,
                                                          monkeypatch):
    """A backward kernel whose launch fails raises out of the loss's
    backward pass (through attention_chunked and _wkv_chunked) instead of
    being served by its plain version, and counts no launch."""
    from repro_torch.kernels.attention import flash as t_flash
    from repro_torch.kernels.rwkv import kernel as wkv
    from repro_torch.models import blocks, layers

    class Refused:
        @staticmethod
        def flash_attention_bwd_launch(*args):
            return 1    # cudaErrorInvalidValue: the launch never ran

        @staticmethod
        def flash_attention_bwd_scratch(*args):
            return 4

        wkv_chunked_bwd_launch = flash_attention_bwd_launch
        wkv_chunked_bwd_scratch = flash_attention_bwd_scratch

    monkeypatch.setattr(t_flash, "_bwd_entry",
                        lambda: t_flash.bwd_entry(Refused))
    monkeypatch.setattr(wkv, "_bwd_entry", lambda: wkv.bwd_entry(Refused))
    q, k, v = _flash_inputs(cuda_device, (1, 16, 16, 2, 1, 64),
                            torch.float32)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = t_attn.flash_attention_bwd.launches
    out = layers.attention_chunked(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention_bwd: CUDA error"):
        out.sum().backward()
    assert t_attn.flash_attention_bwd.launches == before
    xs = list(_wkv_inputs(cuda_device, 1, 16, 2, 8, 0))
    for t in xs:
        t.requires_grad_(True)
    before = t_rwkv.wkv_chunked_bwd.launches
    out, _ = blocks._wkv_chunked(*xs)
    with pytest.raises(RuntimeError, match="wkv_chunked_bwd: CUDA error"):
        out.sum().backward()
    assert t_rwkv.wkv_chunked_bwd.launches == before
