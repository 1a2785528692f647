"""The LeNet-5 case study (paper §5) in the port against the reference
package on the same seeded numpy inputs: the parameters, the naive build,
the InputToConstant + StreamingComposition ladder under the port's
``compile("cuda", device="cpu")`` against the reference's
``compile("pallas")`` (interpret mode), and the off-chip volumes. On the
CPU the matmul wrapper runs its plain version; the kernel itself runs in
``test_torch_gpu.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from repro.frontends import ml as rml
from repro.pipeline import (DeviceOffloadPass as RDeviceOffloadPass,
                            InputToConstantPass as RInputToConstantPass,
                            StreamingCompositionPass as RStreamingPass,
                            lower as rlower)
from repro.transforms import (DeviceOffload as RDeviceOffload,
                              InputToConstant as RInputToConstant,
                              StreamingComposition as RStreamingComposition)
from repro_torch.frontends import ml
from repro_torch.kernels import gemm
from repro_torch.pipeline import (DeviceOffloadPass, InputToConstantPass,
                                  StreamingCompositionPass, lower)
from repro_torch.transforms import (DeviceOffload, InputToConstant,
                                    StreamingComposition)

BATCH = 16


@pytest.fixture(scope="module")
def setup():
    params = rml.init_lenet_params()
    x = np.random.default_rng(0).standard_normal(
        (BATCH, 1, 28, 28)).astype(np.float32)
    return params, x, np.asarray(rml.lenet_reference(params, x))


@pytest.mark.parametrize("seed", [0, 1, 2026])
def test_init_lenet_params_is_byte_identical(seed):
    ours, theirs = ml.init_lenet_params(seed), rml.init_lenet_params(seed)
    assert list(ours) == list(theirs) == list(ml.LENET_SHAPES)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.float32
        assert ours[k].tobytes() == theirs[k].tobytes()


def test_params_from_reference_round_trip(setup):
    params, _, _ = setup
    t = ml.lenet_params_from_reference(params, "cpu")
    assert set(t) == set(params)
    for k, v in t.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        assert v.numpy().tobytes() == params[k].tobytes()


def test_torch_oracle_matches_reference_oracle(setup):
    params, x, exp = setup
    got = ml.lenet_reference(ml.lenet_params_from_reference(params, "cpu"),
                             torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-7)


def test_naive_matches_reference(setup):
    params, x, exp = setup
    weights = ml.lenet_params_from_reference(params, "cpu")
    c = lower(ml.build_lenet(BATCH)).optimize(
        [DeviceOffloadPass()]).compile("torch", device="cpu")
    out = c(x=x, **weights)["probs"]
    assert out.shape == (BATCH, 10)
    np.testing.assert_allclose(out.numpy(), exp, rtol=1e-3, atol=1e-5)


def test_ladder_matches_reference_pallas(setup):
    """The same fused regions and grid kernels as the reference's Pallas
    ladder, the same probabilities, and five matmul calls a forward (the
    two fused conv+pool pairs and the three Linears)."""
    params, x, exp = setup
    rc = rlower(rml.build_lenet(BATCH)).optimize(
        [RInputToConstantPass(parameters=params), RDeviceOffloadPass(),
         RStreamingPass()]).compile("pallas")
    calls = []
    real = gemm.matmul

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gemm, "matmul", spy)
        tc = lower(ml.build_lenet(BATCH)).optimize(
            [InputToConstantPass(parameters=params), DeviceOffloadPass(),
             StreamingCompositionPass()]).compile("cuda", device="cpu",
                                                   cache=None)
        out = tc(x=x)["probs"]
    assert tc.report["fused_regions"] == rc.report["fused_regions"]
    assert tc.report["fused_regions"].count("Conv2d+MaxPool2d") == 2
    assert tc.report["grid_kernels"] == rc.report["grid_kernels"]
    assert calls == [(BATCH * 576, 25), (BATCH * 64, 150), (BATCH, 256),
                     (BATCH, 120), (BATCH, 84)]
    np.testing.assert_allclose(out.numpy(), np.asarray(rc(x=x)["probs"]),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), exp, rtol=1e-3, atol=1e-5)


def _volumes(pkg_ml, offload, to_const, stream, batch, params):
    s = pkg_ml.build_lenet(batch)
    s.apply(offload)
    out = {"naive": s.off_chip_volume()}
    s = pkg_ml.build_lenet(batch)
    assert s.apply(to_const, parameters=params) == len(params)
    s.apply(offload)
    out["const"] = s.off_chip_volume()
    s.apply(stream)
    out["stream"] = s.off_chip_volume()
    return out


@pytest.mark.parametrize("batch", [16, 32, 1000])
def test_volumes_equal_reference(setup, batch):
    params = setup[0]
    ours = _volumes(ml, DeviceOffload, InputToConstant, StreamingComposition,
                    batch, params)
    theirs = _volumes(rml, RDeviceOffload, RInputToConstant,
                      RStreamingComposition, batch, params)
    assert ours == theirs
    assert ours["naive"] > ours["const"] > ours["stream"]
    if batch == 1000:
        import chip_smoke
        assert ours == chip_smoke.REF_LENET_VOLUMES


def test_unfused_cuda_levels_reach_the_matmul_wrapper(setup):
    """Without StreamingComposition the Conv2d and Linear nodes expand at
    their ``cuda`` level: each calls the matmul wrapper, none the torch
    composite."""
    params, x, exp = setup
    weights = ml.lenet_params_from_reference(params, "cpu")
    calls = []
    real = gemm.matmul

    def spy(*args, **kw):
        calls.append(kw.get("activation"))
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gemm, "matmul", spy)
        c = lower(ml.build_lenet(BATCH)).optimize(
            [DeviceOffloadPass()]).compile("cuda", device="cpu", cache=None)
        out = c(x=x, **weights)["probs"]
    assert c.report["fused_regions"] == []
    assert "conv_conv1_W->cuda" in c.report["expansions"]
    assert calls == ["relu", "relu", "relu", "relu", None]
    np.testing.assert_allclose(out.numpy(), exp, rtol=1e-3, atol=1e-5)


def test_gemm_cuda_level_reaches_the_matmul_wrapper():
    """A Gemm program compiled for ``cuda`` expands at the ``cuda`` level
    and calls the matmul wrapper, never the torch composite."""
    from repro_torch import programs
    calls = []
    real = gemm.matmul

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    rng = np.random.default_rng(5)
    A, B = (rng.standard_normal((48, 48)).astype(np.float32)
            for _ in range(2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gemm, "matmul", spy)
        c = programs.gemm.lower(n=48).compile("cuda", device="cpu",
                                              cache=None)
        out = c(A=A, B=B)["C"]
    assert c.report["expansions"] == ["gemm0->cuda"]
    assert calls == [(48, 48)]
    np.testing.assert_allclose(out.numpy(), A @ B, rtol=2e-4, atol=2e-4)
