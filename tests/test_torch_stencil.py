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
    """diffusion2d, jacobi3d and diffusion3d: the plain versions the CPU
    wrappers run and the card's kernels are held to (the wrappers against
    the reference's Pallas kernels are in ``test_torch_fig19.py``)."""
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
    """Six stages of radius 2 (a halo of 12) keep the tile their halo
    leaves within the 227 KB a block may use: the block's strip grid less
    the halo of 10 the first stage computes (10 and 12 columns, 104 in
    all; rows no fewer than half the grid's, for two blocks an SM), not a
    tile shrunk for shared memory."""
    th, tw, smem = stencil_kernel.plan([WIDE] * 6)
    assert tw == 104 and stencil_kernel.TILE[0] // 2 <= th <= \
        stencil_kernel.TILE[0] - 20
    assert smem <= stencil_kernel.TWO_BLOCKS < \
        stencil_kernel.SMEM_LIMIT == 232_448


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


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 5, 6])
def test_plan_takes_every_halo_the_kernel_took_before(n_stages):
    """Every summed halo R that the kernel took before its redesign is
    still taken, on every device: that kernel held one slab of (8 + 2R) x
    (32 + 2R) floats (two for a chain) beside 2 KB of tap tables within
    227 KB, so one stage up to R = 110 and a chain up to 75. The largest
    halos now take one slab (no load in flight); one stage takes up to
    112 and a chain up to 76, and the next halo is refused on the CPU as
    on the card."""
    k = stencil_kernel
    chain = n_stages > 1

    def stages(R):
        rs = [R // n_stages + (i < R % n_stages) for i in range(n_stages)]
        return [((0, 0), (r, 0), (0, -r)) for r in rs]

    took = [R for R in range(130)
            if 4 * (2 * k.MAX_TAPS + (1 + chain) * (8 + 2 * R) * (32 + 2 * R))
            <= k.SMEM_LIMIT]
    assert took[-1] == (75 if chain else 110)
    for R in took + [took[-1] + 1]:
        g = k.layout(stages(R))
        assert g["smem"] <= k.SMEM_LIMIT
        assert g["n_slabs"] == (2 if R <= (61 if chain else 76) else 1)
    top = 76 if chain else 112
    assert k.plan(stages(top))[:2] == k.MIN_TILE
    with pytest.raises(k.StencilLimitError):
        k.plan(stages(top + 1))
    a = torch.zeros(16, 16)
    coeffs = [[1.0, 0.5, 0.5]] * n_stages
    with pytest.raises(k.StencilLimitError):
        if chain:
            stencil.stencil2d_chain(a, coeffs, stages(top + 1))
        else:
            stencil.stencil2d(a, coeffs[0], stages(top + 1)[0])
    want = stencil.stencil2d_chain_ref(a, coeffs, stages(took[-1]))
    got = stencil.stencil2d_chain(a, coeffs, stages(took[-1])) if chain \
        else stencil.stencil2d(a, coeffs[0], stages(took[-1])[0])
    assert torch.equal(got, want)


def _emulated_kernel(a, coeffs_per_stage, stages):
    """``csrc/stencil.cu``'s arithmetic on the CPU, tile by tile at the
    plan's geometry: the block's shared memory as one flat array (header,
    a guard before each buffer) filled with NaN where the kernel leaves it
    unwritten, the slab loaded with a zero fill outside the field, each
    stage computed over the strips it covers (8 x 4 outputs a thread,
    reading the dense window's three 16-byte columns or the taps), masked
    to the field between stages, the buffers alternating, the last stage
    stored with its ragged edges masked. Every index must stay inside the
    block's memory, an intermediate store inside its row, and every output
    must be written; a NaN read into a kept output shows a read of memory
    the kernel never wrote."""
    k = stencil_kernel
    g = k.layout(stages)
    th, tw, smem = g["th"], g["tw"], g["smem"]
    t = k.tap_table(stages)
    co = np.concatenate([np.asarray(c, np.float64).reshape(-1)
                         for c in coeffs_per_stage])
    H, W = a.shape
    R, P = g["y0"], g["pitch"]
    stride = k.GUARD + g["buf_floats"]
    mem = np.full(32 + g["n_bufs"] * stride, np.nan)
    assert 4 * (32 + 32 + g["n_bufs"] * stride) <= smem
    bufs = [32 + k.GUARD + b * stride for b in range(g["n_bufs"])]
    # 16-byte slab rows and buffers (float4 loads and stores)
    assert P % 4 == 0 and g["x0"] % 4 == 0 and all(b % 32 == 0 for b in bufs)
    out = np.full((H, W), np.nan)
    a64, n_tiles = a.astype(np.float64), 0

    def at(base, U, C):
        idx = base + U[:, None] * P + C[None, :]
        assert idx.min() >= 0 and idx.max() < len(mem)
        return mem[idx]

    for ti in range(-(-H // th)):
        for tj in range(-(-W // tw)):
            i0, j0 = ti * th, tj * tw
            rows = np.arange(g["rows"])[:, None] + i0 - R
            cols = np.arange(P)[None, :] + j0 - g["x0"]
            inside = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
            slab = np.where(inside, a64[np.clip(rows, 0, H - 1),
                                        np.clip(cols, 0, W - 1)], 0.0)
            n_tiles += 1
            src, dst = bufs[n_tiles % g["n_slabs"]], bufs[-1]
            for u in range(g["rows"]):
                mem[src + u * P:src + (u + 1) * P] = slab[u]
            h, k0 = R, 0
            for s in range(t.n_stages):
                r = t.radius[s]
                h -= r
                h4 = -(-h // 4) * 4
                nsy = -(-(th + 2 * h) // k.STRIP_ROWS)
                nsx = -(-(tw + h + h4) // 4)
                U = R - h + np.arange(nsy * k.STRIP_ROWS)
                C = g["x0"] - h4 + np.arange(nsx * 4)
                acc = np.zeros((len(U), len(C)))
                if t.kind[s]:
                    # the window skips the positions no tap names
                    q = t.kind[s] - 1
                    n = 2 * q + 1
                    at(src, U - q, C - 4 if q else C)
                    at(src, U + q, C + 4 if q else C)
                    for di in range(n):
                        for dj in range(n):
                            tap = t.dense[s][di * n + dj]
                            if tap >= 0:
                                acc += co[tap] * at(src, U - q + di,
                                                    C - q + dj)
                else:
                    for kk in range(k0, t.stage_end[s]):
                        acc += co[kk] * at(src, U + t.di[kk], C + t.dj[kk])
                gi, gj = U - R + i0, C - g["x0"] + j0
                if s == t.n_stages - 1:
                    keep_r = (U - R < th) & (gi < H)
                    keep_c = (C - g["x0"] < tw) & (gj < W)
                    out[np.ix_(gi[keep_r], gj[keep_c])] = \
                        acc[np.ix_(keep_r, keep_c)]
                else:
                    assert C.max() < P       # no store wraps into a row
                    in_f = ((gi >= 0) & (gi < H))[:, None] & \
                        ((gj >= 0) & (gj < W))[None, :]
                    idx = dst + U[:, None] * P + C[None, :]
                    assert idx.min() >= 0 and idx.max() < len(mem)
                    mem[idx] = np.where(in_f, acc, 0.0)
                src, dst = dst, src
                k0 = t.stage_end[s]
    assert not np.isnan(out).any()
    return out


FAR = ((0, 0), (-10, 0), (10, 0))
BOX = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))


@pytest.mark.parametrize("shape,stages", [
    ((70, 260), (DIFF,)),
    ((37, 131), (DIFF, SKEW)),
    ((45, 200), (WIDE, DIFF, SKEW)),
    ((100, 130), (DIFF,) * 6),
    ((50, 70), (((0, 0), (0, 0), (1, 1)), ((0, 0), (3, -2), (-1, 1)))),
    ((23, 41), (((0, 0),), DIFF)),
    ((9, 40), (FAR,) * 6),
    ((31, 37), (BOX, DIFF)),
    ((9, 45), (((0, 0), (-110, 3), (110, -5)),)),
    ((7, 40), (((0, 0), (-37, 2), (37, 0)), ((1, 0), (0, 38), (-3, -38))))])
def test_kernel_tiling_computes_the_plain_chain(shape, stages):
    """The kernel's tiles, slabs, strips, dense windows and tap loops
    (``_emulated_kernel``) against the plain version: one stage, chains of
    mixed radii, six stages, duplicated offsets and a radius of 3 (the tap
    loop), a radius-0 first stage, a full 3 x 3 window, a halo that forces
    the smallest tile (several strip rounds a stage), and halos of 110 (one
    stage) and 75 (a chain) that take one slab."""
    a = _field(shape, sum(shape))
    rng = np.random.default_rng(len(stages))
    coeffs = [(0.3 * rng.standard_normal(len(o))).astype(np.float32)
              for o in stages]
    got = _emulated_kernel(a, coeffs, stages)
    want = stencil.stencil2d_chain_ref(torch.from_numpy(a),
                                       [torch.from_numpy(c) for c in coeffs],
                                       stages)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


def test_tap_table_dense_windows_and_routes():
    """Radius <= 2 stages with distinct offsets take a dense window (kind
    1 + r, the tap index at (di + r)(2r + 1) + dj + r, -1 where none); a
    duplicated offset or a radius of 3 takes the tap loop (kind 0). A field whose rows are
    16-byte aligned takes the TMA route, any other cp.async. The layout
    constants are the source's."""
    t = stencil_kernel.tap_table([DIFF, SKEW, ((0, 0), (0, 0)),
                                  ((0, 0), (3, 0)), BOX, ((0, 0),)])
    assert list(t.kind)[:6] == [2, 3, 0, 0, 2, 1]
    assert list(t.stage_end)[:6] == [5, 11, 13, 15, 24, 25]
    for k, (di, dj) in enumerate(DIFF):
        assert t.dense[0][(di + 1) * 3 + dj + 1] == k
    assert sorted(t.dense[0][:9]) == [-1] * 4 + list(range(5))
    for k, (di, dj) in enumerate(SKEW):
        assert t.dense[1][(di + 2) * 5 + dj + 2] == 5 + k
    src = (stencil_kernel.build.CSRC / "stencil.cu").read_text()
    for name, value in (("kRS", stencil_kernel.STRIP_ROWS),
                        ("kGuard", stencil_kernel.GUARD),
                        ("kDense", stencil_kernel.DENSE)):
        assert f"{name} = {value};" in src
    route = stencil_kernel.route
    assert route(torch.zeros(8, 512)) == "tma"
    assert route(torch.zeros(8, 515)) == route(torch.zeros(8, 777)) == \
        "cp.async"
    assert route(torch.zeros(8 * 512 + 1)[1:].view(8, 512)) == "cp.async"


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
