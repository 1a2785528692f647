"""The port's ShardMap partition analysis (``repro_torch.transforms.
shard_map``) and the mesh-keyed pipelines, mirroring
``test_shard_map.py``'s ``TestClassification`` and ``TestCacheKeys`` on
the CPU, then holding ``partition_sdfg``'s record to the reference's on
the same SDFGs.

Running a partitioned program (``codegen/shard.py``, the sharded train
and serve steps) is ROADMAP step 10: the backends refuse it
(``tests/test_torch_backend.py``)."""
import pytest

from repro.analysis.diagnostics import refusal_code as rrefusal_code
from repro.core import memlet as rmemlet, sdfg as rsdfg
from repro.core.symbolic import sym as rsym
from repro.transforms.shard_map import partition_sdfg as rpartition
from repro_torch.analysis.diagnostics import refusal_code
from repro_torch.core import memlet, sdfg
from repro_torch.core.symbolic import sym
from repro_torch.pipeline.passes import default_pipeline
from repro_torch.transforms.shard_map import partition_sdfg

PORT = (sdfg, memlet, sym)
REF = (rsdfg, rmemlet, rsym)


def rows_sdfg(n=8, m=4, halo=False, pkg=PORT):
    """Row map: y[i] = 2 x[i] (+ optionally x[i+1]: a halo read) with a
    whole-container wcr("add") loss accumulator."""
    core, mem, sy = pkg
    Memlet, Range, Subset = mem.Memlet, mem.Range, mem.Subset
    s = core.SDFG("rows")
    s.add_array("x", (n, m), "float32")
    s.add_array("y", (n, m), "float32")
    s.add_array("acc", (1,), "float32")
    st = s.add_state("main", is_start=True)
    idx = Range.index(sy("i") + 1) if halo else Range.index(sy("i"))
    st.add_mapped_tasklet(
        "rows", {"i": (0, n)},
        inputs={"xr": Memlet.simple(
            "x", Subset([idx, Range.make(0, m)]))},
        outputs={"yr": Memlet.simple(
            "y", Subset([Range.index(sy("i")), Range.make(0, m)])),
            "a": Memlet.simple("acc", wcr="add")},
        fn=lambda xr: {"yr": xr * 2.0, "a": xr.sum().reshape(1)})
    return s


def _shape0(s, name):
    return int(s.arrays[name].shape[0].evaluate({}))


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------
class TestClassification:
    def test_shard_local_replicated_psum(self):
        s = rows_sdfg(n=8)
        res = partition_sdfg(s, 2)
        assert res["sharded"]
        assert res["specs"]["x"] == 0 and res["specs"]["y"] == 0
        assert res["specs"]["acc"] is None
        assert "acc" in res["psum"]
        # container shapes and the map range divided in place
        assert _shape0(s, "x") == 4 and _shape0(s, "y") == 4
        assert s.metadata["shard_map"]["n_shards"] == 2
        hows = {d["container"]: d for d in res["decisions"]
                if d.get("decision") == "shard"}
        assert "indexed" in hows["x"]["how"]

    def test_weights_stay_replicated(self):
        s = rows_sdfg(n=8)
        s.add_array("w", (4, 4), "float32")  # never indexed by the map
        res = partition_sdfg(s, 2)
        assert res["sharded"]
        assert res["specs"].get("w") is None  # absent/None = replicated
        reps = [d for d in res["decisions"]
                if d.get("container") == "w"]
        assert reps and reps[0]["decision"] == "replicated"

    def test_n_shards_one_is_identity(self):
        s = rows_sdfg()
        res = partition_sdfg(s, 1)
        assert not res["sharded"] and res["decisions"] == []
        assert _shape0(s, "x") == 8

    def test_halo_read_is_typed_refusal_sdfg_untouched(self):
        s = rows_sdfg(n=8, halo=True)
        # pin y so the halo read on x is the hot parameter's violation
        s.metadata["shard_declared"] = {"y": 0}
        res = partition_sdfg(s, 2)
        assert not res["sharded"]
        refusals = [d for d in res["decisions"]
                    if d["decision"] == "shard_refused"]
        assert refusals, res["decisions"]
        assert "crosses the shard boundary" in refusals[0]["reason"]
        # validate-before-mutate: nothing divided, nothing stamped
        assert _shape0(s, "x") == 8 and _shape0(s, "y") == 8
        assert "shard_map" not in s.metadata

    def test_non_divisible_extent_refuses(self):
        s = rows_sdfg(n=6)
        res = partition_sdfg(s, 4)
        assert not res["sharded"]
        reasons = " ".join(str(d.get("reason")) for d in res["decisions"])
        assert "not divisible" in reasons
        assert _shape0(s, "x") == 6

    def test_declared_replicated_conflict_refuses(self):
        s = rows_sdfg(n=8)
        s.metadata["shard_declared"] = {"x": None, "y": 0}
        res = partition_sdfg(s, 2)
        assert not res["sharded"]
        refusals = [d for d in res["decisions"]
                    if d["decision"] == "shard_refused"]
        assert "must stay replicated" in refusals[0]["reason"]
        assert _shape0(s, "x") == 8


# ---------------------------------------------------------------------------
# Mesh-keyed compilation
# ---------------------------------------------------------------------------
class TestCacheKeys:
    def test_pipeline_signature_distinct_per_mesh(self):
        """A mesh shrink must be a cache miss: n_shards and the mesh
        signature are pipeline-signature relevant, per backend."""
        for backend in ("torch", "cuda"):
            p0 = default_pipeline(backend)
            p2a = default_pipeline(backend, n_shards=2, mesh_sig="meshA")
            p2b = default_pipeline(backend, n_shards=2, mesh_sig="meshB")
            p4a = default_pipeline(backend, n_shards=4, mesh_sig="meshA")
            sigs = {p0.signature(), p2a.signature(), p2b.signature(),
                    p4a.signature()}
            assert len(sigs) == 4, f"{backend}: colliding signatures"

    def test_sharded_pipeline_is_named(self):
        assert default_pipeline("torch").name == "torch_default"
        assert default_pipeline(
            "torch", n_shards=2, mesh_sig="m").name == "torch_sharded"
        assert default_pipeline(
            "cuda", n_shards=2, mesh_sig="m").name == "cuda_sharded"


def test_sharded_pipelines_keep_the_reference_pass_order():
    from repro.pipeline import default_pipeline as rdefault
    for backend, ref_backend in (("torch", "jnp"), ("cuda", "pallas")):
        ours = default_pipeline(backend, n_shards=2, mesh_sig="m")
        theirs = rdefault(ref_backend, n_shards=2, mesh_sig="m")
        assert [p.name for p in ours] == [p.name for p in theirs]
        shard = [p for p in ours if p.name == "ShardMap"][0]
        assert shard.options() == {"n_shards": 2, "axis": "shard",
                                   "mesh_sig": "m"}


# ---------------------------------------------------------------------------
# The record against the reference's
# ---------------------------------------------------------------------------
def _weights(s):
    s.add_array("w", (4, 4), "float32")
    return s


def _declare(meta):
    def f(s):
        s.metadata["shard_declared"] = dict(meta)
        return s
    return f


#: name -> (builder kwargs, edit of the built SDFG, n_shards)
RECORDS = {
    "rows": ({}, None, 2),
    "rows_4": ({"n": 16}, None, 4),
    "weights": ({}, _weights, 2),
    "n_shards_one": ({}, None, 1),
    "halo": ({"halo": True}, _declare({"y": 0}), 2),
    "halo_undeclared": ({"halo": True}, None, 2),
    "non_divisible": ({"n": 6}, None, 4),
    "declared_conflict": ({}, _declare({"x": None, "y": 0}), 2),
    "declared_all": ({}, _declare({"x": 0, "y": 0, "acc": None}), 2),
}


def _record(pkg, partition, code_of, name):
    kw, edit, k = RECORDS[name]
    s = rows_sdfg(pkg=pkg, **kw)
    if edit is not None:
        s = edit(s)
    res = partition(s, k)
    meta = s.metadata.get("shard_map") or {}
    codes = [code_of("shard", d.get("reason")) for d in res["decisions"]
             if d["decision"] in ("unsharded", "shard_refused")]
    return {"sharded": res["sharded"], "specs": res["specs"],
            "psum": res.get("psum"), "divided": meta.get("divided"),
            "decisions": res["decisions"], "codes": codes,
            "shapes": {n: tuple(repr(x) for x in d.shape)
                       for n, d in s.arrays.items()}}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_partition_record_equals_reference(name):
    """Same SDFG, same shard count: the same specs, psum set, divided
    scopes, decisions, refusal codes and resulting container shapes."""
    ours = _record(PORT, partition_sdfg, refusal_code, name)
    theirs = _record(REF, rpartition, rrefusal_code, name)
    assert ours == theirs
