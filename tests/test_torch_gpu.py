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
from repro_torch.kernels import axpydot as t_axpydot, dot as t_dot
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
    s = programs.rowsum_shift(256, 192)
    assert s.apply(MapFusion) == 1
    return s, {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["axpydot_unfused", "axpydot_fused",
                                  "gemver", "gemver_chain", "rowsum"])
def test_on_gpu_grid_kernels_match_plain(cuda_device, name):
    """The same compiled program on the card (generated Triton kernels) and
    on the CPU (their plain block programs)."""
    sdfg, kw = _program(name)
    c_gpu = lower(sdfg).compile("cuda", cache=None, **kw)
    c_cpu = lower(sdfg).compile("cuda", cache=None, device="cpu", **kw)
    assert c_gpu.report["grid_kernels"] == c_cpu.report["grid_kernels"]
    g = torch.Generator().manual_seed(7)
    args = {}
    for k, desc in sdfg.arrays.items():
        if desc.transient or k in ("out", "x_out", "w_out", "result"):
            continue
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
