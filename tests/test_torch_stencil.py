"""The StencilFlow case study (paper §6) in the port against the
reference package on the same seeded numpy inputs: the stencil kernels'
plain versions against the reference's Pallas kernels in interpret mode
(at the tolerances of ``test_kernels.py``), the JSON frontend, and the
two-iteration program on the ``torch`` and ``cuda`` (CPU) backends against
the reference's ``jnp`` and ``pallas`` backends. On the CPU the stencil
wrappers run their plain versions; the CUDA kernels run in
``test_torch_gpu.py`` and ``chip_smoke.py``."""
import copy
import itertools

import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from repro.frontends import stencil as rstencil_fe
from repro.kernels import stencil as rstencil
from repro.transforms import (DeviceOffload as RDeviceOffload,
                              StreamingComposition as RStreamingComposition)
from repro_torch import programs
from repro_torch.frontends import stencil as stencil_fe
from repro_torch.kernels import stencil
from repro_torch.kernels.stencil import kernel as stencil_kernel
from repro_torch.pipeline import (DeviceOffloadPass, StreamingCompositionPass,
                                  lower)
from repro_torch.transforms import DeviceOffload, StreamingComposition

DIFF = programs.DIFFUSION_OFFSETS
SKEW = ((0, 0), (-2, 1), (1, 2), (2, -1), (0, -2), (-1, -1))
WIDE = ((0, 0), (-2, 0), (2, 0), (0, -2), (0, 2))


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the reference's kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("di,dj", [(-2, -2), (-2, 1), (-1, 2), (0, 0),
                                   (1, -2), (2, 2), (2, -1)])
def test_stencil2d_plain_matches_reference_kernel(di, dj):
    """Offsets in [-2, 2]^2 (the reference's property test), H prime."""
    offsets = ((0, 0), (di, dj))
    a = _field((37, 24), 11)
    co = np.array([0.5, 0.25], np.float32)
    before = stencil.stencil2d.launches
    got = stencil.stencil2d(torch.from_numpy(a), torch.from_numpy(co),
                            offsets)
    assert stencil.stencil2d.launches == before    # CPU: plain, no launch
    ref = rstencil.stencil2d(a, co, offsets, bh=37, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("stages", [(DIFF, DIFF), (DIFF, SKEW),
                                    (WIDE, DIFF, SKEW),
                                    (SKEW, DIFF, WIDE, DIFF)])
def test_stencil2d_chain_plain_matches_reference_kernel(stages):
    """2-4 stages of mixed radii against the reference's fused chain."""
    a = _field((48, 40), 12)
    rng = np.random.default_rng(len(stages))
    coeffs = [(0.3 * rng.standard_normal(len(o))).astype(np.float32)
              for o in stages]
    before = stencil.stencil2d_chain.launches
    got = stencil.stencil2d_chain(torch.from_numpy(a),
                                  [torch.from_numpy(c) for c in coeffs],
                                  stages)
    assert stencil.stencil2d_chain.launches == before
    ref = rstencil.stencil2d_chain(a, coeffs, stages, bh=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_other_plain_stencils_match_reference_oracles():
    """diffusion2d, jacobi3d and diffusion3d: the oracles of the kernels
    still to be ported."""
    a2, a3 = _field((65, 33), 13), _field((16, 12, 10), 14)
    co = np.array([0.2, 0.1, 0.15, 0.25, 0.3], np.float32)
    for got, want in (
            (stencil.diffusion2d_ref(torch.from_numpy(a2), co),
             rstencil.diffusion2d_ref(a2, co)),
            (stencil.jacobi3d_ref(torch.from_numpy(a3)),
             rstencil.jacobi3d_ref(a3)),
            (stencil.diffusion3d_ref(torch.from_numpy(a3), 0.1),
             rstencil.diffusion3d_ref(a3, 0.1))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# what the kernel takes
# ---------------------------------------------------------------------------
def test_six_radius_two_stages_fit_shared_memory():
    """Six stages of radius 2 (a halo of 12) keep the full tile within
    the 227 KB a block may use."""
    th, tw, smem = stencil_kernel.plan([WIDE] * 6)
    assert (th, tw) == stencil_kernel.TILE
    assert smem <= stencil_kernel.SMEM_LIMIT == 232_448


def test_large_halo_shrinks_the_tile_then_refuses():
    far = ((0, 0), (-10, 0), (10, 0))          # radius 10, halo 60
    th, tw, smem = stencil_kernel.plan([far] * 6)
    assert (th, tw) < stencil_kernel.TILE and smem <= \
        stencil_kernel.SMEM_LIMIT
    farther = ((0, 0), (-20, 0), (20, 0))      # halo 120: no tile fits
    with pytest.raises(stencil_kernel.StencilLimitError):
        stencil_kernel.plan([farther] * 6)
    a = torch.zeros(64, 64)
    with pytest.raises(stencil_kernel.StencilLimitError):   # every device
        stencil.stencil2d_chain(a, [[1.0, 0.5, 0.5]] * 6, [farther] * 6)


def test_tap_table_limits_are_the_sources():
    src = (stencil_kernel.build.CSRC / "stencil.cu").read_text()
    assert f"kMaxTaps = {stencil_kernel.MAX_TAPS};" in src
    assert f"kMaxStages = {stencil_kernel.MAX_STAGES};" in src
    with pytest.raises(stencil_kernel.StencilLimitError):
        stencil_kernel.plan([DIFF] * 7)
    many = tuple(itertools.product(range(-1, 2), repeat=2)) * 15   # 135
    with pytest.raises(stencil_kernel.StencilLimitError):
        stencil_kernel.plan([many])


# ---------------------------------------------------------------------------
# the JSON frontend and the two-iteration program
# ---------------------------------------------------------------------------
SPEC = programs.diffusion_spec((48, 40))


@pytest.mark.parametrize("expr", [
    SPEC["program"]["b"]["computation"],
    "out = 0.5*src[j+2,k-1] + w*src[j, k] + -1.5*src[j-2,k+2]",
    "b = c0 * a[j,k]"])
def test_parse_computation_matches_reference(expr):
    assert stencil_fe.parse_computation(expr) == \
        rstencil_fe.parse_computation(expr)


def test_parse_rejects_two_arrays_like_reference():
    expr = "b = c0*a[j,k] + c1*e[j,k]"
    for fe in (stencil_fe, rstencil_fe):
        with pytest.raises(ValueError):
            fe.parse_computation(expr)


def _labels(sdfg):
    return [n.label for st in sdfg.states for n in st.nodes
            if type(n).__name__ == "Stencil"]


def test_dependency_order_detected():
    spec = copy.deepcopy(SPEC)
    spec["program"] = {"d": SPEC["program"]["d"], "b": SPEC["program"]["b"]}
    ours = stencil_fe.build_stencil_program(spec)
    theirs = rstencil_fe.build_stencil_program(spec)
    ours.validate()
    assert _labels(ours) == _labels(theirs) == ["stencil_b", "stencil_d"]


def test_cyclic_program_rejected():
    spec = copy.deepcopy(SPEC)
    spec["program"] = {"b": {"computation": "b = c0*d[j,k]"},
                       "d": {"computation": "d = c0*b[j,k]"}}
    with pytest.raises(ValueError, match="cyclic"):
        stencil_fe.build_stencil_program(spec)


@pytest.mark.parametrize("backend,ref_backend", [("torch", "jnp"),
                                                 ("cuda", "pallas")])
def test_two_iteration_program_matches_reference(backend, ref_backend):
    a = _field((48, 40), 0)
    co = np.array([0.2, 0.1, 0.15, 0.25, 0.3], np.float32)
    rs = rstencil_fe.build_stencil_program(SPEC)
    rs.apply(RDeviceOffload)
    rs.apply(RStreamingComposition)
    rc = rs.compile(ref_backend)
    staged = lower(stencil_fe.build_stencil_program(SPEC)).optimize(
        [DeviceOffloadPass(), StreamingCompositionPass()])
    tc = staged.compile(backend, device="cpu", cache=None)
    assert tc.report["fused_regions"] == rc.report["fused_regions"]
    if backend == "cuda":
        assert tc.report["fused_regions"] == ["Stencil+Stencil"]
    out = tc(a=a, b_coeffs=co, d_coeffs=co)["d"]
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(rc(a=a, b_coeffs=co,
                                             d_coeffs=co)["d"]),
                               rtol=1e-4, atol=1e-5)


def test_fused_and_unfused_cuda_levels_reach_the_wrappers():
    """Streamed, the chain fusion calls stencil2d_chain once; offloaded
    only, each Stencil node's ``cuda`` level calls stencil2d."""
    a = _field((48, 40), 1)
    co = np.array([0.2, 0.1, 0.15, 0.25, 0.3], np.float32)
    calls = []

    def spying(name):
        real = getattr(stencil, name)

        def spy(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return spy

    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("stencil2d", "stencil2d_chain"):
            mp.setattr(stencil, name, spying(name))
        for streamed in (False, True):
            passes = [DeviceOffloadPass()] + (
                [StreamingCompositionPass()] if streamed else [])
            c = lower(stencil_fe.build_stencil_program(SPEC)).optimize(
                passes).compile("cuda", device="cpu", cache=None)
            outs[streamed] = c(a=a, b_coeffs=co, d_coeffs=co)["d"]
    assert calls == ["stencil2d", "stencil2d", "stencil2d_chain"]
    want = stencil.stencil2d_ref(stencil.stencil2d_ref(
        torch.from_numpy(a), co, DIFF), co, DIFF)
    for out in outs.values():
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("dims", [(256, 512), (1024, 512), (131_072, 4_096)])
def test_streaming_volume_drop_equals_reference(dims):
    """The volume StreamingComposition removes: one field written and
    read (3,145,808 -> 2,097,232 B at 256 x 512), as the reference counts
    it; at the paper's domain the numbers chip_smoke.py holds the card's
    run to."""
    spec = programs.diffusion_spec(dims)
    vols = []
    for fe, offload, stream in (
            (stencil_fe, DeviceOffload, StreamingComposition),
            (rstencil_fe, RDeviceOffload, RStreamingComposition)):
        s = fe.build_stencil_program(spec)
        s.apply(offload)
        v0 = s.off_chip_volume()
        assert s.apply(stream) == 1
        vols.append((v0, s.off_chip_volume()))
    assert vols[0] == vols[1]
    if dims == (256, 512):
        assert vols[0] == (3_145_808, 2_097_232)
    elif dims == (1024, 512):
        assert vols[0] == (12_582_992, 8_388_688)
    else:
        import chip_smoke
        assert vols[0] == tuple(chip_smoke.REF_STENCIL_VOLUMES.values())
