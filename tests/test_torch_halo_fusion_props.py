"""The port's halo-aware MapFusion against the reference's, as property
tests (optional hypothesis dependency), mirroring
``test_halo_fusion_props.py`` with its strategies: random stencil-chain
depths x offset sets x tile shapes fuse into ONE scope holding as many
tasklets as the reference's fused scope, and the port's backends match the
numpy reference and the reference package's output. Where the scope
converts, its generated Triton kernel, run by the CPU emulator of
``test_torch_grid.py``, computes the same."""
import numpy as np
import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the optional 'hypothesis' "
                         "dependency (pip install -e .[test])")
from hypothesis import given, settings, strategies as hst  # noqa: E402

import repro_torch.kernels  # noqa: F401,E402
from repro.core.sdfg import (MapEntry as RMapEntry,  # noqa: E402
                             Tasklet as RTasklet)
from repro.pipeline import lower as rlower  # noqa: E402
from repro.transforms import MapFusion as RMapFusion  # noqa: E402
from repro_torch.codegen import cuda_backend  # noqa: E402
from repro_torch.core.memlet import Memlet, Subset  # noqa: E402
from repro_torch.core.sdfg import SDFG, MapEntry, Tasklet  # noqa: E402
from repro_torch.core.symbolic import sym  # noqa: E402
from repro_torch.pipeline import (GridConversionPass,  # noqa: E402
                                  MapTilingPass, PassManager, lower)
from repro_torch.transforms import MapFusion  # noqa: E402

import test_halo_fusion_props as ref_props  # noqa: E402
from test_torch_grid import _emulated_launch  # noqa: E402

MARGIN = ref_props.MARGIN  # stage k computes [MARGIN*(k+1), n - MARGIN*(k+1))


def _chain_sdfg(n, stage_offsets):
    """The reference test's chain, built with the port's IR: connector
    ``v{o+1}`` reads the predecessor at ``i + o`` with coefficient
    0.25 (o + 2)."""
    s = SDFG("halo_prop")
    s.add_array("x", (n,), "float32")
    s.add_array("out", (n,), "float32")
    st = s.add_state("main", is_start=True)
    i = sym("i")
    prev_name, prev_node = "x", None
    for k, offs in enumerate(stage_offsets):
        last = k == len(stage_offsets) - 1
        dst = "out" if last else f"t{k}"
        if not last:
            s.add_transient(dst, (n,), "float32")
        lo, hi = MARGIN * (k + 1), n - MARGIN * (k + 1)
        kw = {} if prev_node is None else {"input_nodes":
                                           {prev_name: prev_node}}
        _, _, ex = st.add_mapped_tasklet(
            f"stage{k}", {"i": (lo, hi)},
            inputs={f"v{o + 1}": Memlet.simple(
                        prev_name, Subset.indices([i + o])) for o in offs},
            outputs={"o": Memlet.simple(dst, Subset.indices([i]))},
            fn=ref_props._stage_fn(offs), **kw)
        prev_name = dst
        prev_node = next(e.dst for e in st.out_edges(ex)
                         if e.memlet.data == dst)
    return s


def _count(sdfg, entry_t, tasklet_t):
    nodes = [nd for st in sdfg.states for nd in st.nodes]
    return (sum(isinstance(nd, entry_t) for nd in nodes),
            sum(isinstance(nd, tasklet_t) for nd in nodes))


@settings(max_examples=20, deadline=None)
@given(n=hst.sampled_from([48, 96, 160]),
       stage_offsets=hst.lists(
           hst.lists(hst.sampled_from([-1, 0, 1]),
                     min_size=1, max_size=3, unique=True),
           min_size=2, max_size=3),
       tile=hst.sampled_from([None, 8, 32]),
       seed=hst.integers(min_value=0, max_value=2 ** 31 - 1))
def test_random_stencil_chains_fuse_and_match(n, stage_offsets, tile, seed):
    """Any chain of 2-3 radius-1 stages fuses to a single scope with the
    reference's tasklet count. The torch backend and the cuda backend (its
    plain block programs, then its generated kernel in the emulator) match
    the numpy reference and the reference's jnp output. A converted chain
    is one grid kernel; a refused one is a typed skip or fallback (with the
    default tiles the Hopper table leaves the n = 160 chains a partial tile,
    a typed fallback where the reference converts)."""
    ours, theirs = _chain_sdfg(n, stage_offsets), \
        ref_props._chain_sdfg(n, stage_offsets)
    assert ours.apply(MapFusion) == theirs.apply(RMapFusion) == \
        len(stage_offsets) - 1
    scopes, tasklets = _count(ours, MapEntry, Tasklet)
    assert scopes == 1
    assert tasklets == _count(theirs, RMapEntry, RTasklet)[1]

    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    want = ref_props._reference(x, stage_offsets)
    theirs_out = np.asarray(rlower(theirs).compile("jnp", cache=None)(x=x)
                            ["out"])
    np.testing.assert_allclose(theirs_out, want, rtol=1e-4, atol=1e-5)

    ot = lower(ours).compile("torch", device="cpu", cache=None)(x=x)["out"]
    np.testing.assert_allclose(ot.numpy(), want, rtol=1e-4, atol=1e-5)

    if tile is None:
        pm = None
    else:
        pm = PassManager([MapTilingPass(tile_sizes={"i": tile}),
                          GridConversionPass()], name=f"halo_tile{tile}")
    cp = lower(ours).compile("cuda", device="cpu", cache=None, pipeline=pm)
    kernels = cp.report["grid_kernels"]
    assert len(kernels) <= 1, f"chain split into {kernels}"
    extent = n - 2 * MARGIN * len(stage_offsets)
    if tile is not None and extent % tile == 0 and extent // tile >= 2:
        assert len(kernels) == 1, f"expected one grid kernel: {cp.report}"
    if not kernels:
        # a refused conversion is loud: a typed skip or fallback
        assert cp.report.get("grid_skipped") or \
            cp.report.get("grid_fallbacks"), cp.report
    og = cp(x=x)["out"]
    np.testing.assert_allclose(og.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(og.numpy(), theirs_out, rtol=1e-4, atol=1e-5)
    if kernels:
        before = cuda_backend.run_grid_kernel.launches
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cuda_backend, "_on_cpu", lambda tensors: False)
            mp.setattr(cuda_backend, "launch_kernel", _emulated_launch)
            oe = cp(x=x)["out"]
        assert cuda_backend.run_grid_kernel.launches == before + 1
        np.testing.assert_allclose(oe.numpy(), want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(oe.numpy(), theirs_out, rtol=1e-4,
                                   atol=1e-5)
