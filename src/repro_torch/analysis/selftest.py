"""Seeded-mutation self-test for the verifier.

Each case builds a known-good SDFG, runs a (possibly empty) pass
pipeline with the verification harness armed, then applies one
deliberate miscompilation as a final ``Mutate[...]`` pass. The harness
must (a) report a clean baseline and clean legitimate passes, (b) catch
the mutation with the *expected* diagnostic code, and (c) attribute it
to the mutation pass — exactly the guarantee that lets a report reader
trust the "introduced by" field on a real pipeline bug.

Run directly (``python -m repro_torch.analysis.selftest``) for a table, or
through ``tests/test_torch_analysis.py``.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, List, Optional

from ..core.memlet import Memlet, Range, Subset
from ..core.sdfg import SDFG, MapEntry, Tasklet
from ..core.symbolic import Expr, sym
from ..pipeline.passes import (GridConversionPass, MapTilingPass, Pass,
                               PassManager, ShardMapPass)


class _MutationPass(Pass):
    """Wraps one injected miscompilation as a pipeline pass so the
    harness's per-pass attribution has a name to pin it on."""

    def __init__(self, fn: Callable[[SDFG], object], label: str):
        self.fn = fn
        self.name = f"Mutate[{label}]"

    def apply(self, sdfg: SDFG, report: dict):
        return self.fn(sdfg)

    def options(self):
        return {"label": self.name}


# ---------------------------------------------------------------------------
# Known-good base programs (self-contained; no benchmark imports)
# ---------------------------------------------------------------------------


def vec_sdfg(n: int = 64, inplace: bool = False) -> SDFG:
    """y[i] = 2 x[i] over [0, n-1) (or x in place)."""
    s = SDFG("vec")
    s.add_array("x", (n,), "float32")
    if not inplace:
        s.add_array("y", (n,), "float32")
    st = s.add_state("main", is_start=True)
    out = "x" if inplace else "y"
    st.add_mapped_tasklet(
        "scale", {"i": (0, n - 1)},
        inputs={"xv": Memlet.simple("x", Subset([Range.index(sym("i"))]))},
        outputs={"yv": Memlet.simple(out,
                                     Subset([Range.index(sym("i"))]))},
        fn=lambda xv: {"yv": xv * 2.0})
    return s


def reduce_sdfg(n: int = 64) -> SDFG:
    """acc[0] += x[i] (wcr-protected whole-container accumulation)."""
    s = SDFG("reduce")
    s.add_array("x", (n,), "float32")
    s.add_array("acc", (1,), "float32")
    st = s.add_state("main", is_start=True)
    st.add_mapped_tasklet(
        "accum", {"i": (0, n)},
        inputs={"xv": Memlet.simple("x", Subset([Range.index(sym("i"))]))},
        outputs={"a": Memlet.simple("acc", wcr="add")},
        fn=lambda xv: {"a": xv.reshape(1)})
    return s


def chain_sdfg(n: int = 64) -> SDFG:
    """x -> t (transient) -> y, two maps over [0, n-1)."""
    s = SDFG("chain")
    s.add_array("x", (n,), "float32")
    s.add_transient("t", (n,), "float32")
    s.add_array("y", (n,), "float32")
    st = s.add_state("main", is_start=True)
    idx = lambda: Subset([Range.index(sym("i"))])
    st.add_mapped_tasklet(
        "produce", {"i": (0, n - 1)},
        inputs={"xv": Memlet.simple("x", idx())},
        outputs={"tv": Memlet.simple("t", idx())},
        fn=lambda xv: {"tv": xv * 2.0})
    st.add_mapped_tasklet(
        "consume", {"i": (0, n - 1)},
        inputs={"tv": Memlet.simple("t", idx())},
        outputs={"yv": Memlet.simple("y", idx())},
        fn=lambda tv: {"yv": tv + 1.0})
    return s


def mat_sdfg(n: int = 256, m: int = 256) -> SDFG:
    """2-D elementwise map, large enough to tile and grid-convert."""
    s = SDFG("mat")
    s.add_array("a", (n, m), "float32")
    s.add_array("b", (n, m), "float32")
    st = s.add_state("main", is_start=True)
    sub = lambda: Subset([Range.index(sym("i")), Range.index(sym("j"))])
    st.add_mapped_tasklet(
        "ew", {"i": (0, n), "j": (0, m)},
        inputs={"av": Memlet.simple("a", sub())},
        outputs={"bv": Memlet.simple("b", sub())},
        fn=lambda av: {"bv": av * 3.0})
    return s


def rows_sdfg(n: int = 8, m: int = 4) -> SDFG:
    """Shardable row map with a psum accumulator (mirrors the shard-map
    test fixture): y[i, :] = 2 x[i, :], acc += sum(x[i, :])."""
    s = SDFG("rows")
    s.add_array("x", (n, m), "float32")
    s.add_array("y", (n, m), "float32")
    s.add_array("acc", (1,), "float32")
    st = s.add_state("main", is_start=True)
    row = lambda: Subset([Range.index(sym("i")), Range.make(0, m)])
    st.add_mapped_tasklet(
        "rows", {"i": (0, n)},
        inputs={"xr": Memlet.simple("x", row())},
        outputs={"yr": Memlet.simple("y", row()),
                 "a": Memlet.simple("acc", wcr="add")},
        fn=lambda xr: {"yr": xr * 2.0, "a": xr.sum().reshape(1)})
    return s


# ---------------------------------------------------------------------------
# Edge finders
# ---------------------------------------------------------------------------


def _find_edge(sdfg: SDFG, pred):
    for st in sdfg.states:
        for e in st.edges:
            if pred(e):
                return e
    raise AssertionError("selftest: no edge matches the mutation target")


def _write_edge(sdfg: SDFG, data: str):
    return _find_edge(sdfg, lambda e: e.memlet is not None
                      and e.memlet.data == data
                      and isinstance(e.src, Tasklet))


def _read_edge(sdfg: SDFG, data: str):
    return _find_edge(sdfg, lambda e: e.memlet is not None
                      and e.memlet.data == data
                      and isinstance(e.dst, Tasklet))


def _shard_meta(sdfg: SDFG) -> dict:
    from ..transforms.shard_map import SHARD_ANNOTATION
    meta = sdfg.metadata.get(SHARD_ANNOTATION)
    assert meta, "selftest: base program did not shard"
    return meta


# ---------------------------------------------------------------------------
# The mutations
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Case:
    name: str
    expected_code: str
    build: Callable[[], SDFG]
    mutate: Callable[[SDFG], object]
    passes: Callable[[], List[Pass]] = lambda: []


def _drop_wcr(sdfg):
    # the aggregated exit->access edge restates the wcr: drop every copy,
    # as a buggy transform rebuilding the scope would
    hit = 0
    for st in sdfg.states:
        for e in st.edges:
            if e.memlet is not None and e.memlet.wcr is not None:
                e.memlet.wcr = None
                hit += 1
    assert hit, "selftest: no wcr edge to drop"
    return f"dropped wcr on {hit} edge(s)"


def _shift_producer(sdfg):
    e = _write_edge(sdfg, "t")
    e.memlet.subset = Subset([Range.index(sym("i") + 1)])
    return "t[i] -> t[i+1]"


def _oob_read(sdfg):
    e = _read_edge(sdfg, "x")
    e.memlet.subset = Subset([Range.index(sym("i") + 2)])
    return "x[i] -> x[i+2] (reaches n past the extent)"


def _shrink_volume(sdfg):
    e = _write_edge(sdfg, "y")
    e.memlet.volume = Expr.const(0)
    return "volume 0 under a 1-element subset"


def _shift_inplace_read(sdfg):
    e = _read_edge(sdfg, "x")
    e.memlet.subset = Subset([Range.index(sym("i") + 1)])
    return "in-place read x[i] -> x[i+1]"


def _rogue_state(sdfg):
    st2 = sdfg.add_state("rogue")       # no interstate edge: unordered
    t = st2.add_tasklet("clobber", [], ["o"],
                        fn=lambda: {"o": 0.0})
    acc = st2.add_access("y")
    st2.add_edge(t, "o", acc, None,
                 Memlet.simple("y", Subset([Range.make(0, 1)])))
    return "unordered state writes y"


def _desync_tiling(sdfg):
    for st in sdfg.states:
        for node in st.nodes:
            if isinstance(node, MapEntry) \
                    and node.map.annotations.get("tiling"):
                for info in node.map.annotations["tiling"].values():
                    if isinstance(info, dict):
                        info["tile"] = int(info["tile"]) + 1
                        return f"tile+1 on {node.map.label}"
    raise AssertionError("selftest: no tiled map to desync")


def _desync_grid(sdfg):
    from ..codegen.cuda_backend import GRID_ANNOTATION
    for st in sdfg.states:
        for node in st.nodes:
            if isinstance(node, MapEntry):
                spec = node.map.annotations.get(GRID_ANNOTATION)
                if spec is not None and spec.grid:
                    p, size = spec.grid[0]
                    doctored = dataclasses.replace(
                        spec, grid=((p, size + 1),) + spec.grid[1:])
                    node.map.annotations[GRID_ANNOTATION] = doctored
                    return f"grid dim {p}: {size} -> {size + 1}"
    raise AssertionError("selftest: no grid-converted map to desync")


def _misclassify_replicated(sdfg):
    _shard_meta(sdfg)["specs"]["y"] = None
    return "y: sharded -> replicated"


def _misclassify_dim(sdfg):
    _shard_meta(sdfg)["specs"]["x"] = 7
    return "x: dim 0 -> dim 7"


def _orphan_psum(sdfg):
    meta = _shard_meta(sdfg)
    assert "acc" in meta["psum"]
    hit = 0
    for st in sdfg.states:
        for e in st.edges:
            if e.memlet is not None and e.memlet.data == "acc" \
                    and e.memlet.wcr is not None:
                e.memlet.wcr = None
                hit += 1
    assert hit, "selftest: no acc wcr edge"
    return "acc psum without wcr"


def _donate_readonly(sdfg):
    sdfg.metadata["donated"] = ["x"]
    return "donated read-only x"


def _donate_ghost(sdfg):
    sdfg.metadata["donated"] = ["ghost"]
    return "donated unknown name"


CASES: List[Case] = [
    Case("wcr_drop", "RACE001", reduce_sdfg, _drop_wcr),
    Case("memlet_shift", "BND002", chain_sdfg, _shift_producer),
    Case("oob_subset", "BND001", vec_sdfg, _oob_read),
    Case("volume_mismatch", "BND003", vec_sdfg, _shrink_volume),
    Case("read_write_race", "RACE002",
         lambda: vec_sdfg(inplace=True), _shift_inplace_read),
    Case("interstate_race", "RACE003", vec_sdfg, _rogue_state),
    Case("tiling_desync", "ANN001", mat_sdfg, _desync_tiling,
         lambda: [MapTilingPass()]),
    Case("grid_desync", "ANN002", mat_sdfg, _desync_grid,
         lambda: [MapTilingPass(), GridConversionPass()]),
    Case("shard_misclassify", "SHD003", rows_sdfg, _misclassify_replicated,
         lambda: [ShardMapPass(n_shards=2)]),
    Case("shard_bad_dim", "SHD001", rows_sdfg, _misclassify_dim,
         lambda: [ShardMapPass(n_shards=2)]),
    Case("psum_no_wcr", "SHD002", rows_sdfg, _orphan_psum,
         lambda: [ShardMapPass(n_shards=2)]),
    Case("donation_alias", "DON001", vec_sdfg, _donate_readonly),
    Case("donation_unknown", "DON002", vec_sdfg, _donate_ghost),
]


def run_case(case: Case) -> dict:
    """Run one case; the returned record is what the tests assert on."""
    sdfg = case.build()
    pm = PassManager(case.passes(), name=f"selftest_{case.name}")
    pm.append(_MutationPass(case.mutate, case.name))
    report: dict = {}
    pm.run(sdfg, report=report, verify="full")
    vrec = report["verify"]
    mut_entry = vrec["passes"][-1]
    codes = sorted({v["code"] for v in mut_entry["violations"]})
    return {
        "name": case.name,
        "expected": case.expected_code,
        "caught": case.expected_code in codes,
        "codes": codes,
        "attributed_to": mut_entry["name"],
        "attribution_ok": mut_entry["name"].startswith("Mutate["),
        "baseline_clean": not vrec["baseline"],
        "prior_passes_clean": all(p["clean"] for p in vrec["passes"][:-1]),
    }


def run_all() -> List[dict]:
    return [run_case(c) for c in CASES]


def main() -> int:
    ok = True
    for r in run_all():
        good = (r["caught"] and r["baseline_clean"]
                and r["prior_passes_clean"])
        ok &= good
        print(f"{'PASS' if good else 'FAIL'}  {r['name']:<20} "
              f"expected {r['expected']:<8} got {','.join(r['codes']) or '-'}"
              f"  (attributed to {r['attributed_to']})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
