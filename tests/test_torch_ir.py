"""The port's IR, transforms and metric against the reference package:
memlet volumes at the paper's sizes (bit-exact), the streamed PE count,
and the MapFusion / MapTiling decisions on the programs of
``test_map_fusion.py`` — built by the very same builder code, rebound to
the port's IR classes."""
import ast
import re
import types
from pathlib import Path

import pytest

import test_map_fusion as ref_programs
from benchmarks import axpydot as ref_axpydot, gemver as ref_gemver
from repro.core.sdfg import MapEntry as RMapEntry
from repro.transforms import (DeviceOffload as RDeviceOffload,
                              MapFusion as RMapFusion,
                              MapTiling as RMapTiling,
                              StreamingComposition as RStreamingComposition,
                              StreamingMemory as RStreamingMemory)
from repro_torch import programs
from repro_torch.core.dtypes import StorageType
from repro_torch.core.memlet import Memlet, Range, Subset
from repro_torch.core.sdfg import SDFG, MapEntry
from repro_torch.core.symbolic import sym
from repro_torch.transforms import (DeviceOffload, MapFusion, MapTiling,
                                    StreamingComposition, StreamingMemory)

ROOT = Path(__file__).resolve().parents[1]


def _port_builder(name):
    """A builder of ``test_map_fusion.py`` with its globals swapped for the
    port's IR classes (helpers that call other helpers get the port's
    versions too)."""
    g = dict(vars(ref_programs))
    g.update(SDFG=SDFG, Memlet=Memlet, Subset=Subset, Range=Range, sym=sym,
             StorageType=StorageType)
    for nm, fn in vars(ref_programs).items():
        if nm.startswith("_") and isinstance(fn, types.FunctionType):
            g[nm] = types.FunctionType(fn.__code__, g, nm, fn.__defaults__,
                                       fn.__closure__)
    return g[name]


def _scopes(sdfg, entry_type):
    """Per map scope: label, params, tiling annotation keys and the
    storage of every transient — everything a fusion/tiling decision
    leaves behind."""
    out = []
    for st in sdfg.states:
        for nd in st.nodes:
            if isinstance(nd, entry_type):
                tiling = nd.map.annotations.get("tiling", {})
                out.append((nd.map.label, tuple(nd.map.params),
                            tuple(sorted(tiling))))
    storage = sorted((k, d.storage.name) for k, d in sdfg.arrays.items()
                     if d.transient)
    return sorted(out), storage


FUSION_CASES = [
    ("_pair_sdfg", {}),
    ("_pair_sdfg", {"cons_params": {"j": (0, 32)}}),
    ("_pair_sdfg", {"cons_params": {"j": (1, 64)}}),
    ("_pair_sdfg", {"cons_params": {"j": (0, 64)}}),
    ("_pair_sdfg", {"extra_reader": True}),
    ("_pair_sdfg", {"wcr": "add"}),
    ("_pair_sdfg", {"n": 8, "offset": 1}),
    ("_pair_sdfg", {"n": 64, "cons_params": {"j": (0, 63)}, "offset": 1}),
    ("_two_producer_sdfg", {"n": 128}),
    ("_two_intermediate_sdfg", {"n": 64}),
    ("_two_intermediate_sdfg", {"n": 64, "wcr_on_X": "add"}),
    ("_scalar_pair_sdfg", {"trips": 1}),
    ("_scalar_pair_sdfg", {"trips": 4}),
    ("_three_scope_sdfg", {"n": 32, "s_transient": False}),
    ("_three_scope_sdfg", {"n": 32, "s_transient": True}),
    ("_wcr_chain_sdfg", {"n": 48, "m": 32}),
    ("_wcr_chain_sdfg", {"n": 128, "m": 96}),
]


@pytest.mark.parametrize("builder,kw", FUSION_CASES,
                         ids=[f"{b}-{i}" for i, (b, _) in
                              enumerate(FUSION_CASES)])
def test_map_fusion_then_tiling_decisions_match_reference(builder, kw):
    ref = getattr(ref_programs, builder)(**kw)
    port = _port_builder(builder)(**kw)
    assert port.apply(MapFusion) == ref.apply(RMapFusion)
    assert _scopes(port, MapEntry) == _scopes(ref, RMapEntry)
    assert dict(MapFusion().explain(port)) == dict(RMapFusion().explain(ref))
    # MapTiling's decisions (which params tile) match; tile sizes follow
    # each package's own tile table
    assert port.apply(MapTiling) == ref.apply(RMapTiling)
    assert _scopes(port, MapEntry) == _scopes(ref, RMapEntry)


@pytest.mark.parametrize("tile_prod,tile_cons", [
    (None, None), ({"i": 64}, None), (None, {"j": 64}),
    ({"i": 64}, {"j": 64}), ({"i": 64}, {"j": 128})])
def test_fusion_across_tiling_matches_reference(tile_prod, tile_cons):
    ref = ref_programs._tileable_pair(512)
    port = _port_builder("_tileable_pair")(512)
    for s, tiling in ((ref, RMapTiling), (port, MapTiling)):
        if tile_prod:
            s.apply(tiling, map_label="prod", tile_sizes=tile_prod)
        if tile_cons:
            s.apply(tiling, map_label="cons", tile_sizes=tile_cons)
    assert port.apply(MapFusion) == ref.apply(RMapFusion)
    assert _scopes(port, MapEntry) == _scopes(ref, RMapEntry)


# ---------------------------------------------------------------------------
# the paper metric, bit-exact at the paper's sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("passes", [(), ("offload",),
                                    ("offload", "compose"),
                                    ("offload", "compose", "memory")])
def test_axpydot_volume_and_pes_at_paper_n(passes):
    n = programs.AXPYDOT_N
    ref, port = ref_axpydot.build(n), programs.axpydot(n)
    steps = {"offload": (RDeviceOffload, DeviceOffload),
             "compose": (RStreamingComposition, StreamingComposition),
             "memory": (RStreamingMemory, StreamingMemory)}
    for p in passes:
        ref.apply(steps[p][0])
        port.apply(steps[p][1])
    assert port.off_chip_volume() == ref.off_chip_volume()

    def pes(s):
        return len([st for st in s.states if st.label == "main"][0]
                   .processing_elements())
    assert pes(port) == pes(ref)
    if passes == ("offload", "compose", "memory"):
        assert pes(port) > 1                      # the streamed pipeline


@pytest.mark.parametrize("variant", ["naive", "streaming", "manual",
                                     "both_streamed"])
def test_gemver_volumes_at_paper_n(variant):
    ref = ref_gemver._variants(ref_gemver.PAPER_N)[variant]
    port = programs.gemver_variants(programs.GEMVER_N)[variant]
    assert ref_gemver._kernel_volume(port) == ref_gemver._kernel_volume(ref)
    assert port.off_chip_volume() == ref.off_chip_volume()


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, and chip_smoke.py, imports torch-side
    code only: no ``jax`` and nothing of the reference package."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for nm in names:
                root = nm.split(".")[0]
                if root in ("jax", "jaxlib", "repro", "ml_dtypes"):
                    bad.append(f"{path.relative_to(ROOT)}: {nm}")
        if re.search(r"^\s*(import|from)\s+(jax|repro)\b", path.read_text(),
                     re.M):
            bad.append(f"{path.relative_to(ROOT)}: textual import")
    assert not bad, bad
    assert len(_port_files()) > 30
