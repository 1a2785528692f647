"""The port's static verifier (``repro_torch.analysis``) against the
reference's (``test_analysis.py``), on the CPU.

Mirrors every case of ``test_analysis.py``: the seeded-mutation self-test
(every injected miscompilation caught with its expected code and
attributed to the mutating pass), the verifier clean on the lint's
programs through both backend pipelines, the structural checks of
``core.validation`` (STRUCT001, STRUCT002), the typed refusal codes,
strict mode, verify-aware cache keys and the served step's donation
metadata. Then it holds the port against the reference: each self-test
case's record, each lint target's verify record and executed passes, and
the (code, state, scope, container) of every diagnostic on the same
mutated SDFGs and on every program of ``test_torch_grid.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from benchmarks import axpydot as ref_axpydot, gemver as ref_gemver
from benchmarks import jacobi_chain as ref_jacobi, lenet as ref_lenet
from benchmarks import stencil_bench as ref_stencil
from repro.analysis import selftest as rselftest
from repro.pipeline import lower as rlower
from repro.pipeline.passes import PassManager as RPassManager
from repro_torch.analysis import (CODES, Diagnostic, VerificationError,
                                  refusal_code, verify_sdfg)
from repro_torch.analysis import lint
from repro_torch.analysis.selftest import CASES, run_case, vec_sdfg
from repro_torch.core.validation import ValidationError, validate_sdfg
from repro_torch.pipeline import lower
from repro_torch.pipeline.cache import CompilationCache
from repro_torch.pipeline.passes import PassManager
from repro_torch.pipeline.stages import _env_verify

import test_torch_grid as grid_cases

CPU = {"device": "cpu"}


# ---------------------------------------------------------------------------
# Seeded-mutation self-test
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_mutation_caught_with_expected_code(case):
    """Each injected miscompilation is caught with the right code,
    attributed to the mutation pass, on a clean baseline."""
    r = run_case(case)
    assert r["baseline_clean"], \
        f"{case.name}: base program not clean: {r}"
    assert r["prior_passes_clean"], \
        f"{case.name}: a legitimate pass was blamed: {r}"
    assert r["caught"], \
        f"{case.name}: expected {case.expected_code}, got {r['codes']}"
    assert r["attribution_ok"] and case.name in r["attributed_to"]


def test_mutation_classes_are_distinct():
    """At least 8 distinct miscompilation classes."""
    assert len({c.expected_code for c in CASES}) >= 8
    assert len(CASES) >= 8


def test_strict_mode_raises_at_offending_pass():
    case = CASES[0]  # wcr_drop
    sdfg = case.build()
    pm = PassManager(case.passes(), name="strict")
    from repro_torch.analysis.selftest import _MutationPass
    pm.append(_MutationPass(case.mutate, case.name))
    with pytest.raises(VerificationError) as exc:
        pm.run(sdfg, report={}, verify="strict")
    assert any(d.code == case.expected_code for d in exc.value.diagnostics)
    assert all(d.pass_name and d.pass_name.startswith("Mutate[")
               for d in exc.value.diagnostics)


# ---------------------------------------------------------------------------
# Verifier is a no-op on every lint program
# ---------------------------------------------------------------------------


_TARGETS = lint.program_targets()


@pytest.mark.parametrize("backend", lint.BACKENDS)
@pytest.mark.parametrize("name", sorted(_TARGETS))
def test_programs_verify_clean(name, backend):
    cp = lower(_TARGETS[name]()).compile(backend=backend, cache=None,
                                         verify="full", **CPU)
    vrec = cp.report["verify"]
    assert vrec["baseline"] == []
    assert vrec["violations"] == 0, vrec
    assert all(p["clean"] for p in vrec["passes"])
    # every executed pass got a verification record
    executed = [p["name"] for p in cp.report["passes"]
                if not p["skipped"]]
    assert [p["name"] for p in vrec["passes"]] == executed


def test_verify_off_by_default(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_VERIFY", raising=False)
    cp = lower(vec_sdfg()).compile(cache=None, **CPU)
    assert "verify" not in cp.report


def test_env_verify_parsing(monkeypatch):
    for raw, want in [("", None), ("0", None), ("off", None),
                      ("1", "full"), ("full", "full"),
                      ("strict", "strict"), ("TRUE", "full")]:
        monkeypatch.setenv("REPRO_TORCH_VERIFY", raw)
        assert _env_verify() == want, raw


def test_verify_keys_cache_separately(monkeypatch):
    """A cached unverified artifact must not satisfy a verifying compile
    (it has no verify record), and vice versa."""
    monkeypatch.delenv("REPRO_TORCH_VERIFY", raising=False)
    cache = CompilationCache(max_entries=8)
    low = lower(vec_sdfg())
    plain = low.compile(cache=cache, **CPU)
    verified = low.compile(cache=cache, verify="full", **CPU)
    assert "verify" not in plain.report
    assert verified.report["verify"]["violations"] == 0
    # both are cached, under distinct keys
    assert low.compile(cache=cache, **CPU) is plain
    assert low.compile(cache=cache, verify="full", **CPU) is verified
    assert verified.cache_key[-1] == "full"


# ---------------------------------------------------------------------------
# core.validation structural checks
# ---------------------------------------------------------------------------


def test_container_symbol_collision_rejected():
    s = vec_sdfg()
    s.specialize(x=3)   # symbol named like the container
    with pytest.raises(ValidationError) as exc:
        validate_sdfg(s)
    assert exc.value.code == "STRUCT001"
    assert "x" in str(exc.value)


def test_connector_shadowing_rejected():
    from repro_torch.core.memlet import Memlet, Range, Subset
    from repro_torch.core.sdfg import SDFG
    s = SDFG("shadow")
    s.add_array("a", (4,), "float32")
    st = s.add_state("main", is_start=True)
    t = st.add_tasklet("t", ["v", "v"], ["o"],
                       fn=lambda v: {"o": v})
    acc_in = st.add_access("a")
    acc_out = st.add_access("a")
    sub = Subset([Range.make(0, 4)])
    st.add_edge(acc_in, None, t, "v", Memlet.simple("a", sub))
    st.add_edge(t, "o", acc_out, None, Memlet.simple("a", sub))
    with pytest.raises(ValidationError) as exc:
        validate_sdfg(s)
    assert exc.value.code == "STRUCT002"


def test_same_name_in_and_out_is_legal():
    """Inputs are fn kwargs, outputs are result keys — one name in both
    is the serving decode step's idiom, not shadowing."""
    from repro_torch.core.memlet import Memlet, Range, Subset
    from repro_torch.core.sdfg import SDFG
    s = SDFG("inout")
    s.add_array("a", (4,), "float32")
    st = s.add_state("main", is_start=True)
    t = st.add_tasklet("t", ["x"], ["x"], fn=lambda x: {"x": x})
    sub = Subset([Range.make(0, 4)])
    st.add_edge(st.add_access("a"), None, t, "x", Memlet.simple("a", sub))
    st.add_edge(t, "x", st.add_access("a"), None, Memlet.simple("a", sub))
    validate_sdfg(s)   # must not raise


def test_validation_error_surfaces_as_struct_diagnostic():
    s = vec_sdfg()
    s.specialize(x=3)
    diags = verify_sdfg(s)
    assert any(d.code == "STRUCT001" for d in diags)


# ---------------------------------------------------------------------------
# Typed refusal taxonomy
# ---------------------------------------------------------------------------


def test_refusal_codes_classify_known_reasons():
    assert refusal_code("fusion",
                        "fusing would reorder accesses to t") == "FUS001"
    assert refusal_code("fusion", "t is pinned to HBM") == "FUS002"
    assert refusal_code("fusion", "something novel") == "FUS000"
    assert refusal_code("grid",
                        "blocks pin 99 B of VMEM > budget 1 B") == "GRD001"
    assert refusal_code("grid",
                        "grid of 1 step(s) below min_grid_steps=2; "
                        "vmap path wins") == "GRD002"
    assert refusal_code("grid_fallback", "anything") == "GRD004"
    assert refusal_code("shard",
                        "read crosses the shard boundary") == "SHR002"
    assert refusal_code("shard", "mystery") == "SHR000"


def test_all_refusal_rules_map_to_registered_codes():
    from repro_torch.analysis.diagnostics import (_REFUSAL_FALLBACK,
                                                  _REFUSAL_RULES)
    for rules in _REFUSAL_RULES.values():
        for _, code in rules:
            assert code in CODES
    for code in _REFUSAL_FALLBACK.values():
        assert code in CODES


def test_grid_decisions_carry_codes():
    """Every refusal-shaped grid decision carries a typed code, and the
    unified refusal stream mirrors them as info-severity diagnostics."""
    from repro_torch import programs
    cp = lower(programs.jacobi_chain(128)).compile(backend="cuda",
                                                   cache=None, **CPU)
    refused = [d for d in cp.report["grid_decisions"]
               if d["decision"] in ("unfused", "vmap", "unsharded",
                                    "shard_refused")]
    assert refused, "expected at least one refusal in the jacobi chain"
    for d in refused:
        assert d["code"] in CODES, d
    assert cp.report["refusals"]
    for r in cp.report["refusals"]:
        assert r["code"] in CODES and r["severity"] == "info"


def test_diagnostic_identity_excludes_attribution():
    a = Diagnostic(code="BND001", message="m", state="s")
    assert a.key() == a.attributed("SomePass").key()
    assert a.attributed("SomePass").to_dict()["pass"] == "SomePass"


# ---------------------------------------------------------------------------
# Donation metadata on the serving path
# ---------------------------------------------------------------------------


def test_serving_decode_step_stamps_donated_metadata():
    low, compiler = lint.model_lowered("granite-3-2b", "cpu")
    donated = low.sdfg.metadata["donated"]
    assert donated == sorted(compiler._donate) and donated
    # every donated buffer is written by the step: the donation lint
    # stays silent
    from repro_torch.analysis.bounds import check_donation
    assert check_donation(low.sdfg) == []


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

_RCASES = {c.name: c for c in rselftest.CASES}


def _keys(violations):
    """The distinct (code, state, scope, container) of a pass's findings.
    A check may report one site twice (ANN001 lists each desynchronized
    field of a tiling) and how many fields disagree follows the tile
    table, which differs by design."""
    return sorted({(v["code"], v.get("state"), v.get("scope"),
                    v.get("container")) for v in violations})


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_case_record_equals_reference(case):
    """The port's self-test record equals the reference's: the codes, the
    catch, the clean baseline and passes, and the pass blamed."""
    ours, theirs = run_case(case), rselftest.run_case(_RCASES[case.name])
    for k in ("codes", "caught", "baseline_clean", "prior_passes_clean",
              "attributed_to", "expected"):
        assert ours[k] == theirs[k], (k, ours, theirs)


def _mutated_records(case, selftest_mod, pm_cls, rcase):
    sdfg = rcase.build()
    pm = pm_cls(rcase.passes(), name=f"same_{rcase.name}")
    pm.append(selftest_mod._MutationPass(rcase.mutate, rcase.name))
    report = {}
    pm.run(sdfg, report=report, verify="full")
    return report["verify"]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_mutated_sdfg_diagnostics_equal_reference(case):
    """On the same mutated SDFG, every pass's diagnostics carry the same
    (code, state, scope, container) in both packages."""
    from repro_torch.analysis import selftest
    ours = _mutated_records(case, selftest, PassManager, case)
    theirs = _mutated_records(case, rselftest, RPassManager,
                              _RCASES[case.name])
    assert _keys(ours["baseline"]) == _keys(theirs["baseline"]) == []
    assert [p["name"] for p in ours["passes"]] == \
        [p["name"] for p in theirs["passes"]]
    for po, pt in zip(ours["passes"], theirs["passes"]):
        assert _keys(po["violations"]) == _keys(pt["violations"]), po["name"]


_REF_TARGETS = {
    "axpydot": lambda: ref_axpydot.build(256),
    "axpydot_two_producer": lambda: ref_axpydot.build_two_producer(256),
    "gemver": lambda: ref_gemver.build(64),
    "gemver_chain": lambda: ref_gemver.build_chain(64),
    "star_stencil": lambda: ref_stencil._star_sdfg(64, 64),
    "jacobi_chain": lambda: ref_jacobi._chain_sdfg(128),
    "lenet_convblock": lambda: ref_lenet._convblock_sdfg(2),
}


def _ref_decode_lowered():
    from repro.configs import get_config
    from repro.models.transformer import TransformerLM
    from repro.serving.compile import DecodeStepCompiler
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    compiler = DecodeStepCompiler(model, params, page_size=8, n_pages=16)
    return compiler._lowered(B=2, ctx=16)


@pytest.fixture(scope="module")
def decode_lowered():
    return (lint.model_lowered("granite-3-2b", "cpu")[0],
            _ref_decode_lowered())


@pytest.mark.parametrize("backend,ref_backend", [("torch", "jnp"),
                                                 ("cuda", "pallas")])
@pytest.mark.parametrize("name", sorted(_TARGETS) + ["decode_step"])
def test_lint_target_records_equal_reference(name, backend, ref_backend,
                                             decode_lowered):
    """Each lint target through each pair of backends: both verify records
    clean, and the same passes executed in the same order."""
    if name == "decode_step":
        from repro.serving.compile import decode_pipeline as rdecode
        from repro_torch.serving.compile import decode_pipeline
        low, rlow = decode_lowered
        pm = decode_pipeline(True) if backend == "cuda" else None
        rpm = rdecode(True, False) if ref_backend == "pallas" else None
    else:
        low, rlow = lower(_TARGETS[name]()), rlower(_REF_TARGETS[name]())
        pm = rpm = None
    ours = low.compile(backend=backend, cache=None, verify="full",
                       pipeline=pm, **CPU).report["verify"]
    theirs = rlow.compile(backend=ref_backend, cache=None, verify="full",
                          pipeline=rpm).report["verify"]
    for vrec in (ours, theirs):
        assert vrec["baseline"] == [] and vrec["violations"] == 0, vrec
    assert [p["name"] for p in ours["passes"]] == \
        [p["name"] for p in theirs["passes"]]


@pytest.mark.parametrize("name", grid_cases.CASES)
def test_grid_programs_diagnostics_equal_reference(name):
    """Every program of ``test_torch_grid.py`` under its pipelines: the
    port's verify record names the same findings as the reference's. The
    fused row sum (``rowsum_*``) is flagged in both packages: its
    consumer writes ``out[i]`` inside the (i, j) scope without wcr
    (RACE001 at MapFusion and MapTiling), which the two-phase kernel
    writes once, on the last reduction step."""
    rs, ts, rkw, tkw, _ = grid_cases._case(name)
    ours = lower(ts).compile("cuda", cache=None, verify="full", **CPU,
                             **tkw).report["verify"]
    theirs = rlower(rs).compile("pallas", cache=None, verify="full",
                                **rkw).report["verify"]
    assert _keys(ours["baseline"]) == _keys(theirs["baseline"])
    assert [p["name"] for p in ours["passes"]] == \
        [p["name"] for p in theirs["passes"]]
    for po, pt in zip(ours["passes"], theirs["passes"]):
        assert _keys(po["violations"]) == _keys(pt["violations"]), po["name"]
    if not name.startswith("rowsum"):
        assert ours["violations"] == 0


def test_served_step_verifies_clean_at_the_scheduler_buckets(monkeypatch):
    """REPRO_TORCH_VERIFY=strict arms every bucket the Scheduler compiles
    (reduced starcoder2-3b, growing batches and contexts): each report
    carries a clean record, the donation and race checks included, and
    the streams equal an unverified run's."""
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    from repro_torch.serving import Scheduler
    import torch
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              activation_dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    # short prompts and fewer new tokens for the higher slots: the
    # contexts grow through several page buckets while the batch bucket
    # shrinks as the top slots finish
    prompts = [list(np.random.RandomState(3 + i).randint(1, 500, 3))
               for i in range(5)]
    new = [18, 14, 9, 5, 2]

    def serve():
        s = Scheduler(model, params, max_slots=8, page_size=4, n_pages=48,
                      max_model_len=32, prefill_chunk=4,
                      cache_dtype="float32", device="cpu",
                      compile_cache=CompilationCache())
        for p, n in zip(prompts, new):
            s.submit(list(map(int, p)), n)
        out = [r.tokens_out for r in s.run()]
        return s, out

    monkeypatch.delenv("REPRO_TORCH_VERIFY", raising=False)
    _, plain = serve()
    monkeypatch.setenv("REPRO_TORCH_VERIFY", "strict")
    s, verified = serve()
    assert verified == plain
    steps = s.compiler._steps
    assert len({B for B, _ in steps}) >= 3
    assert len({ctx for _, ctx in steps}) >= 3
    for (B, ctx), step in steps.items():
        vrec = step.report["verify"]
        assert vrec["mode"] == "strict"
        assert vrec["baseline"] == [] and vrec["violations"] == 0, (B, ctx)


def test_partial_tiles_are_flagged_in_both_packages():
    """A masked partial tile's counter range covers elements past the
    extent, and the bounds checks do not read the tiling annotation's
    extent: BND001 (and BND002 on a transient) at MapTiling. The
    reference's own partial tiles are flagged alike (its star at 39 x 20,
    37 interior rows, no divisor in its 8 to 32 rows); the port's Hopper
    table makes more of them (gemver at 300: 128-lane tiles, where the
    reference tiles by 100). Difference by design, ROADMAP §3."""
    from repro_torch import programs
    ours = lower(programs.gemver(300)).compile(
        "cuda", cache=None, verify="full", expansion_level="generic",
        **CPU).report["verify"]
    theirs = rlower(ref_gemver.build(300)).compile(
        "pallas", cache=None, verify="full",
        expansion_level="generic").report["verify"]
    assert theirs["violations"] == 0
    assert {(v["code"], v["pass"]) for p in ours["passes"]
            for v in p["violations"]} == {("BND001", "MapTiling"),
                                          ("BND002", "MapTiling")}
    star = rlower(ref_stencil._star_sdfg(39, 20)).compile(
        "pallas", cache=None, verify="full").report["verify"]
    assert {(v["code"], v["pass"]) for p in star["passes"]
            for v in p["violations"]} == {("BND001", "MapTiling")}
