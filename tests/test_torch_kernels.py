"""The port's hand-written kernels (``repro_torch.kernels``) against the
reference package's Pallas kernels in interpret mode, on the same seeded
numpy inputs, at the reference's own tolerances (``test_kernels.py``):
rtol 3e-5 in fp32, 3e-3 in bf16. On the CPU a wrapper runs its plain
version; the CUDA kernels themselves run in ``test_torch_gpu.py`` (marked
``gpu``, skipped without a card) and in ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import axpydot as jax_axpydot, dot as jax_dot
from repro_torch.kernels import axpydot as t_axpydot, dot as t_dot
from repro_torch.kernels import build

RNG_SEED = 42


def _vectors(n, k, dtype):
    rng = np.random.default_rng(RNG_SEED + n)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _bf16(arrs):
    """The same values for both packages: bf16-rounded through torch,
    handed to JAX as bfloat16 arrays."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    js = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ts]
    return ts, js


@pytest.mark.parametrize("n", [1, 1023, 1024, 5000, 9973, 16387])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axpydot_plain_matches_reference_kernel(n, dtype):
    a = np.float32(1.3)
    x, y, w = _vectors(n, 3, dtype)
    if dtype == "float32":
        ts = [torch.from_numpy(v) for v in (x, y, w)]
        js = [x, y, w]
    else:
        ts, js = _bf16([x, y, w])
    before = t_axpydot.axpydot.launches
    out = t_axpydot.axpydot(a, *ts)
    assert t_axpydot.axpydot.launches == before   # CPU: plain, no launch
    ref = jax_axpydot.axpydot(a, *js, interpret=True)
    assert out.shape == (1,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=3e-3 if dtype == "bfloat16" else 3e-5)


@pytest.mark.parametrize("n", [1, 1023, 2048, 9973])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_plain_matches_reference_kernel(n, dtype):
    x, w = _vectors(n, 2, dtype)
    if dtype == "float32":
        ts, js = [torch.from_numpy(x), torch.from_numpy(w)], [x, w]
    else:
        ts, js = _bf16([x, w])
    before = t_dot.dot.launches
    out = t_dot.dot(*ts)
    assert t_dot.dot.launches == before
    ref = jax_dot.dot(*js, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=3e-3 if dtype == "bfloat16" else 3e-5)


def test_axpydot_scalar_forms_agree():
    """``a`` as a Python number or a one-element tensor gives one result."""
    x, y, w = (torch.from_numpy(v) for v in _vectors(777, 3, "float32"))
    r1 = t_axpydot.axpydot(0.5, x, y, w)
    r2 = t_axpydot.axpydot(torch.tensor(0.5), x, y, w)
    assert torch.equal(r1, r2)


def test_wrappers_refuse_bad_cuda_operands_without_launching():
    """The operand checks run before any launch: a mismatch raises."""
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        build.vector_operands("dot", x, torch.zeros(8))   # CPU tensors


def test_library_paths_and_build_dir(tmp_path, monkeypatch):
    """Libraries are named by a hash of their sources and land in the
    build directory, which ``REPRO_TORCH_BUILD_DIR`` overrides."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    p1, p2 = build.library_path("dot"), build.library_path("axpydot")
    assert p1.parent == tmp_path / "b" and p1 != p2
    assert p1.name.startswith("libdot_") and p1.suffix == ".so"
    assert p1 == build.library_path("dot")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_sources_name_the_kernels_they_replace():
    for name, tpu in (("dot", "repro/kernels/dot/kernel.py::dot"),
                      ("axpydot", "repro/kernels/axpydot/kernel.py::axpydot")):
        src = (build.CSRC / f"{name}.cu").read_text()
        assert tpu in src and "3.35 TB/s" in src
        assert "atomic" not in src.lower().replace("no atomics", "")


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, as a module."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n", [100_003, 1_000_003])
def test_smoke_tolerance_accepts_sums_and_rejects_a_dropped_chunk(n):
    """``chip_smoke.py``'s tolerance passes an fp32 dot and its fused
    AXPYDOT against float64, and fails the same sum with one of the dot
    kernel's 528 first-stage chunks left out."""
    chip_smoke = _chip_smoke()
    smoke = chip_smoke.Smoke()
    g = torch.Generator().manual_seed(n)
    x, y, w = (torch.randn(n, generator=g) for _ in range(3))
    x64, w64 = x.double(), w.double()
    want, norm2 = (x64 * w64).sum(), (x64 * x64 * w64 * w64).sum().sqrt()
    assert smoke.within(t_dot.dot(x, w), want, norm2, n)[0]
    assert smoke.within(t_axpydot.axpydot(0.7, x, y, w),
                        *smoke.axpydot_terms(0.7, x, y, w), n)[0]
    chunk = -(-n // 528)
    assert not smoke.within(t_dot.dot(x[:-chunk], w[:-chunk]), want, norm2,
                            n)[0]


# ---------------------------------------------------------------------------
# matmul (the tiled GEMM of the LeNet slice)
# ---------------------------------------------------------------------------
from repro.kernels import gemm as jax_gemm  # noqa: E402
from repro_torch.kernels import gemm as t_gemm  # noqa: E402


def _gemm_operands(shape, seed=7):
    M, K, N = shape
    rng = np.random.default_rng(seed + M * K * N)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32),
            rng.standard_normal(N).astype(np.float32))


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 512, 128),
                                   (300, 200, 150), (64, 1000, 32)])
@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
def test_matmul_plain_matches_reference_kernel(shape, act):
    """The reference's ``test_gemm_sweep`` shapes, at its rtol = atol =
    2e-4, with every activation the kernel takes."""
    A, B, bias = _gemm_operands(shape)
    before = t_gemm.matmul.launches
    out = t_gemm.matmul(torch.from_numpy(A), torch.from_numpy(B),
                        torch.from_numpy(bias), activation=act)
    assert t_gemm.matmul.launches == before   # CPU: plain, no launch
    ref = jax_gemm.matmul(A, B, bias, activation=act, bm=128, bk=128,
                          bn=128, interpret=True)
    assert out.shape == shape[::2] and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_matmul_bf16_plain_matches_reference_kernel():
    """bf16 operands, fp32 accumulation, bf16 output (the reference's
    ``test_gemm_bf16`` tolerance)."""
    A, B, _ = _gemm_operands((128, 256, 128))
    (ta, tb), (ja, jb) = _bf16([A, B])
    out = t_gemm.matmul(ta, tb)
    assert out.dtype == torch.bfloat16
    ref = jax_gemm.matmul(ja, jb, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_matmul_tile_shape_follows_n():
    """Narrow outputs take tall tiles on the fma route: no LeNet product
    leaves most of a square tile's columns masked. The wrapper's constants
    are the source's: the fma tiles and K slice, the wgmma route's 64-deep
    K stage and 128 x 128 tile."""
    assert t_gemm.kernel.tile_shape(6)[1:] == (256, 16)
    assert t_gemm.kernel.tile_shape(16)[1:] == (256, 16)
    assert t_gemm.kernel.tile_shape(84)[1:] == (128, 128)
    assert t_gemm.kernel.tile_shape(64)[1:] == (128, 64)
    assert t_gemm.kernel.tile_shape(4096)[1:] == (128, 128)
    # on a card of 132 SMs: LeNet's fc1 and fc2 at M = 1,000 would give
    # 8 blocks of 128 x 128, so they take 64 x 64; fc3 (N = 10) and a
    # 4096^3 product keep theirs
    small = t_gemm.kernel.SMALL_TILE
    assert t_gemm.kernel.tile_shape(120, 1000, 132) == small
    assert t_gemm.kernel.tile_shape(84, 1000, 132) == small
    assert t_gemm.kernel.tile_shape(40, 20000, 132)[1:] == (128, 64)
    assert t_gemm.kernel.tile_shape(10, 1000, 132)[1:] == (256, 16)
    assert t_gemm.kernel.tile_shape(4096, 4096, 132)[1:] == (128, 128)
    src = (build.CSRC / "gemm.cu").read_text()
    for rows, cols in [t[2:] for t in t_gemm.kernel.TILES] + [small[1:]]:
        assert f"fma_launch<T, {rows}, {cols}," in src
    assert f"constexpr int BK = {t_gemm.kernel.K_TILE};" in src
    assert "constexpr int kWgBM = 128, kWgBN = 128, kWgBK = " \
        f"{t_gemm.kernel.WGMMA_K_TILE};" in src


def _bf16_like(shape, strides=None, offset=0):
    """A bf16 CPU tensor of ``shape``, contiguous or with ``strides``
    (elements), ``offset`` elements into a 64-byte-aligned buffer."""
    size = offset + (sum((n - 1) * st for n, st in zip(shape, strides)) + 1
                     if strides else int(np.prod(shape)))
    buf = torch.zeros(size + 64, dtype=torch.bfloat16)
    skip = (-buf.data_ptr() % 64) // 2
    base = buf[skip:]
    if strides is None:
        return base[offset:offset + int(np.prod(shape))].view(shape)
    return base.as_strided(shape, strides, offset)


#: (case, A, B, the route): the layouts the port passes and those TMA
#: cannot take
_ROUTE_CASES = {
    "contiguous A, W.T B": (
        lambda: _bf16_like((1000, 256)), lambda: _bf16_like((120, 256)).T,
        "wgmma"),
    "contiguous A, contiguous B": (
        lambda: _bf16_like((4096, 4096)), lambda: _bf16_like((4096, 4096)),
        "wgmma"),
    "ragged shapes, 8-element rows": (
        lambda: _bf16_like((1000, 520)), lambda: _bf16_like((520, 4104)),
        "wgmma"),
    "a 64-column view of a wider A": (
        lambda: _bf16_like((64, 256))[:, :64], lambda: _bf16_like((64, 64)),
        "wgmma"),
    "K = 25 (conv1)": (
        lambda: _bf16_like((577, 25)), lambda: _bf16_like((6, 25)).T,
        "fma"),
    "K = 150 (conv2)": (
        lambda: _bf16_like((640, 150)), lambda: _bf16_like((16, 150)).T,
        "fma"),
    "K = 84 (fc3)": (
        lambda: _bf16_like((1000, 84)), lambda: _bf16_like((10, 84)).T,
        "fma"),
    "N-major B with rows of 150": (
        lambda: _bf16_like((300, 200)), lambda: _bf16_like((200, 150)),
        "fma"),
    "A M-major (a transposed view)": (
        lambda: _bf16_like((256, 64)).T, lambda: _bf16_like((256, 64)),
        "fma"),
    "A with two non-unit strides": (
        lambda: _bf16_like((64, 128))[:, ::2], lambda: _bf16_like((64, 64)),
        "fma"),
    "B with two non-unit strides": (
        lambda: _bf16_like((64, 64)), lambda: _bf16_like((64, 128))[:, ::2],
        "fma"),
    "A's base 2 bytes off 16": (
        lambda: _bf16_like((64, 64), offset=1), lambda: _bf16_like((64, 64)),
        "fma"),
    "B's base 8 bytes off 16": (
        lambda: _bf16_like((64, 64)), lambda: _bf16_like((64, 64), offset=4),
        "fma"),
    "overlapping rows (stride below the row)": (
        lambda: _bf16_like((64, 64), strides=(8, 1)),
        lambda: _bf16_like((64, 64)), "fma"),
    "1 x 1 x 1": (lambda: _bf16_like((1, 1)), lambda: _bf16_like((1, 1)),
                  "fma"),
    "K = 0": (lambda: _bf16_like((64, 0)), lambda: _bf16_like((0, 64)),
              "fma"),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_matmul_route_follows_the_layout(case):
    """``route`` sends bf16 operands TMA can read to wgmma and everything
    else to fma, from dtype, shape, strides and alignment alone; every
    fp32 product at the same layouts takes fma."""
    make_a, make_b, want = _ROUTE_CASES[case]
    a, b = make_a(), make_b()
    assert t_gemm.kernel.route(a, b) == want
    assert t_gemm.kernel.route(a.float(), b.float()) == "fma"
    assert t_gemm.kernel.route(a, b.float()) == "fma"


def test_matmul_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        t_gemm.matmul(a, torch.zeros(3, 2), activation="tanh")


@pytest.mark.parametrize("name,tpu", [
    ("gemm", "repro/kernels/gemm/kernel.py::matmul"),
    ("stencil", "repro/kernels/stencil/kernel.py::stencil2d")])
def test_slice_sources_name_the_kernels_they_replace(name, tpu):
    src = (build.CSRC / f"{name}.cu").read_text()
    assert tpu in src and "3.35 TB/s" in src
    assert "atomic" not in src.lower()
    assert name in build.KERNELS


def test_smoke_tolerance_rejects_a_matmul_without_its_last_k_tile():
    """``chip_smoke.py``'s planted matmul fault — the product without its
    last K tile — fails its tolerance at conv2's K = 150, while the full
    product passes against float64."""
    chip_smoke = _chip_smoke()
    smoke = chip_smoke.Smoke()
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn(640, 150, generator=g), torch.randn(150, 16,
                                                            generator=g)
    bias = torch.randn(16, generator=g)
    want, norm2 = smoke.matmul_terms(a, b, bias)
    got = t_gemm.matmul(a, b, bias)
    assert smoke.within(got, want, norm2, 150, chain=150)[0]
    keep = (150 - 1) // t_gemm.kernel.K_TILE * t_gemm.kernel.K_TILE
    bad = t_gemm.matmul(a[:, :keep], b[:keep], bias)
    assert not smoke.within(bad, want, norm2, 150, chain=150)[0]


@pytest.mark.parametrize("wt", [False, True])
def test_smoke_tolerance_rejects_a_wgmma_matmul_without_its_last_k_tile(wt):
    """The same fault on the wgmma route: a bf16 product (B N-major, or
    the ``W.T`` view) without its last 64 K columns, still a wgmma
    layout, fails ``chip_smoke.py``'s bound with the bf16 ulp added, while
    the full product passes against float64."""
    chip_smoke = _chip_smoke()
    smoke = chip_smoke.Smoke()
    g = torch.Generator().manual_seed(5)
    M, K, N = 640, 256, 136
    a = torch.randn(M, K, generator=g).bfloat16()
    b = torch.randn(N, K, generator=g).bfloat16()
    b = b.T if wt else b.reshape(K, N)
    bias = torch.randn(N, generator=g)
    assert t_gemm.kernel.route(a, b) == "wgmma"
    want, norm2 = smoke.matmul_terms(a, b, bias, "relu")
    ulp = chip_smoke.BF16_ULP
    got = t_gemm.matmul(a, b, bias, activation="relu")
    assert smoke.within(got, want, norm2, K, chain=K, out_rel=ulp)[0]
    tile = t_gemm.kernel.WGMMA_K_TILE
    keep = (K - 1) // tile * tile
    assert K - keep == 64
    a_cut, b_cut = a[:, :keep], b[:keep]
    assert t_gemm.kernel.route(a_cut, b_cut) == "wgmma"
    bad = t_gemm.matmul(a_cut, b_cut, bias, activation="relu")
    assert not smoke.within(bad, want, norm2, K, chain=K, out_rel=ulp)[0]
