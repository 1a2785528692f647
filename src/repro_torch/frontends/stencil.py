"""StencilFlow-like JSON frontend (paper §6.1, Fig. 17).

Parses the paper's JSON program description — dimensions, inputs, outputs,
and per-operator ``computation`` strings like

    "b = c0*a[j,k] + c1*a[j-1,k] + c2*a[j+1,k] + c3*a[j,k-1] + c4*a[j,k+1]"

— maps the dependencies between operators, and emits an SDFG of Stencil
Library Nodes chained through (initially off-chip) transient arrays. The
mid-level transformations then stream the chain; the cuda backend fuses
it into one multi-stage kernel (the deadlock-free fully-pipelined
architecture; delay buffers become shared-memory halos).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

from ..core.memlet import Memlet
from ..core.sdfg import SDFG
from ..core.dtypes import StorageType
from ..library.stencil import Stencil
from .api import Program

_TERM = re.compile(
    r"(?P<coeff>[A-Za-z_]\w*|[-+]?\d*\.?\d+)\s*\*\s*"
    r"(?P<arr>[A-Za-z_]\w*)\s*\[\s*j\s*(?P<dj>[-+]\s*\d+)?\s*,"
    r"\s*k\s*(?P<dk>[-+]\s*\d+)?\s*\]")


def parse_computation(expr: str) -> Tuple[str, str, List[Tuple[int, int]],
                                          List[str]]:
    """'b = c0*a[j,k] + c1*a[j-1,k] ...' -> (out, in_array, offsets, coeffs)."""
    lhs, rhs = expr.split("=", 1)
    out = lhs.strip()
    offsets, coeffs, arrays = [], [], set()
    for m in _TERM.finditer(rhs):
        dj = int((m.group("dj") or "0").replace(" ", ""))
        dk = int((m.group("dk") or "0").replace(" ", ""))
        offsets.append((dj, dk))
        coeffs.append(m.group("coeff"))
        arrays.add(m.group("arr"))
    if len(arrays) != 1:
        raise ValueError(f"stencil must read exactly one array: {expr!r}")
    return out, arrays.pop(), offsets, coeffs


def build_stencil_program(spec: Dict) -> SDFG:
    """Build an SDFG from a (paper Fig.-17 style) program description."""
    H, W = spec["dimensions"]
    dtype = "float32"
    p = Program(spec.get("name", "stencilflow"))

    handles = {}
    coeff_handles = {}
    for name, meta in spec.get("inputs", {}).items():
        if meta.get("input_dims"):
            handles[name] = p.input(name, (H, W), meta.get("data_type",
                                                           dtype))
        else:
            coeff_handles[name] = None  # scalar coefficient

    # operator dependency order: an op is ready when its input exists
    ops = dict(spec["program"])
    order = []
    produced = set(handles)
    while ops:
        progress = False
        for out_name, op in list(ops.items()):
            _, in_arr, _, _ = parse_computation(op["computation"])
            if in_arr in produced:
                order.append((out_name, op))
                produced.add(out_name)
                del ops[out_name]
                progress = True
        if not progress:
            raise ValueError("cyclic or unsatisfiable stencil dependencies")

    outputs = set(spec.get("outputs", []))
    for out_name, op in order:
        target, in_arr, offsets, coeff_names = parse_computation(
            op["computation"])
        # coefficient vector input (one per stencil op)
        from .api import TensorHandle
        cvec = f"{out_name}_coeffs"
        p.sdfg.add_array(cvec, (len(coeff_names),), dtype)
        c_h = TensorHandle(p, cvec, (len(coeff_names),), dtype)
        node = Stencil(f"stencil_{out_name}", offsets, coeff_names)
        res = p.add_op(node, {"a": handles[in_arr], "c": c_h},
                       {"b": (H, W)})
        handles[out_name] = res
        if out_name in outputs:
            p.output(out_name, res)
    return p.finalize()
