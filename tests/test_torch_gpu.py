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
from repro_torch.kernels import axpydot as t_axpydot, dot as t_dot
from repro_torch.kernels import gemm as t_gemm, stencil as t_stencil
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
    s = programs.rowsum_shift(256, 192)
    assert s.apply(MapFusion) == 1
    return s, {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["axpydot_unfused", "axpydot_fused",
                                  "gemver", "gemver_chain", "rowsum",
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 1), (300, 200, 150),
                                   (64, 1000, 32), (577, 25, 6),
                                   (1000, 84, 10), (130, 256, 120)])
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
    for act in (None, "relu", "silu", "gelu"):
        before = t_gemm.matmul.launches
        got = t_gemm.matmul(a, b, bias, activation=act)
        assert t_gemm.matmul.launches == before + 1
        want = t_gemm.matmul_ref(a, b, bias, activation=act)
        assert got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


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


@pytest.mark.gpu
def test_on_gpu_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros(64, 64, device=cuda_device)
    before = t_gemm.matmul.launches, t_stencil.stencil2d.launches
    with pytest.raises(ValueError):
        t_stencil.stencil2d(a.double(), [1.0], ((0, 0),))
    with pytest.raises(ValueError):
        t_gemm.matmul(a, a.to(torch.bfloat16))
    assert (t_gemm.matmul.launches, t_stencil.stencil2d.launches) == before
