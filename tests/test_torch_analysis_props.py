"""Property tests for the port's static verifier, mirroring
``test_analysis_props.py`` (optional hypothesis dependency): randomly
drawn *legal* map scopes verify clean, and a random single edit of a legal
program (subset shift, wcr drop, range resize) is detected. Each drawn
program is built in both packages and the port's findings — (code,
state, scope, container) — equal the reference's.

The draws are derandomized: the same examples every run, as the grid
tests seed from ``zlib.crc32`` rather than Python's ``hash``.
"""
import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the optional 'hypothesis' "
                         "dependency (pip install -e .[test])")
from hypothesis import given, settings, strategies as hst  # noqa: E402

from repro.analysis import verify_sdfg as rverify  # noqa: E402
from repro.core import memlet as rmemlet, sdfg as rsdfg  # noqa: E402
from repro.core.symbolic import sym as rsym  # noqa: E402
from repro_torch.analysis import verify_sdfg  # noqa: E402
from repro_torch.core import memlet, sdfg  # noqa: E402
from repro_torch.core.symbolic import sym  # noqa: E402

PORT = (sdfg, memlet, sym)
REF = (rsdfg, rmemlet, rsym)


def _legal_sdfg(pkg, n, m, wcr, two_d):
    """An always-legal program: per-iteration disjoint writes (or a
    wcr-protected accumulation) over static unit-step ranges."""
    core, mem, sy = pkg
    Memlet, Range, Subset = mem.Memlet, mem.Range, mem.Subset
    s = core.SDFG("prop")
    shape = (n, m) if two_d else (n,)
    s.add_array("x", shape, "float32")
    s.add_array("y", shape, "float32")
    st = s.add_state("main", is_start=True)
    if two_d:
        params = {"i": (0, n), "j": (0, m)}
        sub = lambda: Subset([Range.index(sy("i")),
                              Range.index(sy("j"))])
    else:
        params = {"i": (0, n)}
        sub = lambda: Subset([Range.index(sy("i"))])
    outputs = {"yv": Memlet.simple("y", sub())}
    if wcr:
        s.add_array("acc", (1,), "float32")
        outputs["a"] = Memlet.simple("acc", wcr="add")
        fn = lambda xv: {"yv": xv * 2.0, "a": xv.reshape(-1)[:1]}
    else:
        fn = lambda xv: {"yv": xv * 2.0}
    st.add_mapped_tasklet(
        "body", params,
        inputs={"xv": Memlet.simple("x", sub())},
        outputs=outputs, fn=fn)
    return s


def _both(edit, *args):
    """(port findings, reference findings) of one program, edited alike."""
    out = []
    for pkg, verify in ((PORT, verify_sdfg), (REF, rverify)):
        s = _legal_sdfg(pkg, *args)
        edit(pkg, s)
        out.append(sorted((d.code, d.state, d.scope, d.container)
                          for d in verify(s)))
    return out


@settings(max_examples=40, deadline=None, derandomize=True)
@given(n=hst.integers(min_value=1, max_value=128),
       m=hst.integers(min_value=1, max_value=16),
       wcr=hst.booleans(), two_d=hst.booleans())
def test_random_legal_scopes_verify_clean(n, m, wcr, two_d):
    ours, theirs = _both(lambda pkg, s: None, n, m, wcr, two_d)
    assert ours == theirs == []


def _edges_of(s, data, reads):
    out = []
    for st in s.states:
        for e in st.edges:
            if e.memlet is None or e.memlet.data != data:
                continue
            if reads == (type(e.dst).__name__ == "Tasklet"):
                out.append(e)
    return out


def _shift_read(k):
    """x[i] -> x[i+k]: k >= 2 provably escapes the container on an (0, n)
    map."""
    def edit(pkg, s):
        _, mem, sy = pkg
        for e in _edges_of(s, "x", reads=True):
            e.memlet.subset = mem.Subset([mem.Range.index(sy("i") + k)])
    return edit


def _drop_wcr(pkg, s):
    for st in s.states:
        for e in st.edges:
            if e.memlet is not None and e.memlet.wcr is not None:
                e.memlet.wcr = None


def _widen_write(k):
    """A one-element write per iteration becomes a k-element slab at i:
    iterations overlap (RACE001) and it escapes near the end (BND001)."""
    def edit(pkg, s):
        _, mem, sy = pkg
        for e in _edges_of(s, "y", reads=False):
            e.memlet.subset = mem.Subset(
                [mem.Range.make(sy("i"), sy("i") + k)])
    return edit


@settings(max_examples=40, deadline=None, derandomize=True)
@given(n=hst.integers(min_value=4, max_value=128),
       kind=hst.sampled_from(["shift_read", "drop_wcr", "widen_write"]),
       k=hst.integers(min_value=2, max_value=5))
def test_random_single_edit_mutations_detected(n, kind, k):
    wcr = kind == "drop_wcr"
    assert _both(lambda pkg, s: None, n, 1, wcr, False) == [[], []]
    if kind == "shift_read":
        edit, expected = _shift_read(k), {"BND001"}
    elif kind == "drop_wcr":
        edit, expected = _drop_wcr, {"RACE001"}
    else:
        edit, expected = _widen_write(k), {"RACE001", "BND001"}
    ours, theirs = _both(edit, n, 1, wcr, False)
    assert ours == theirs
    assert {c for c, *_ in ours} & expected, (kind, n, k, ours)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(n=hst.integers(min_value=2, max_value=64),
       k=hst.integers(min_value=1, max_value=4))
def test_range_resize_past_extent_detected(n, k):
    """Resizing the map range past the container extent makes the
    (previously in-bounds) per-iteration access provably escape."""
    def resize(pkg, s):
        core, mem, _ = pkg
        for st in s.states:
            for node in st.nodes:
                if isinstance(node, core.MapEntry):
                    node.map.ranges = [mem.Range.make(0, n + k)]
    ours, theirs = _both(resize, n, 1, False, False)
    assert ours == theirs
    assert "BND001" in {c for c, *_ in ours}, (n, k, ours)
