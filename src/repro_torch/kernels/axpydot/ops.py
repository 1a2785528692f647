"""Wrapper + fusion registration for the AXPYDOT kernel."""
from __future__ import annotations

from ...codegen.pipeline_fusion import register_fusion
from . import kernel as _kernel
from . import ref as _ref

axpydot = _kernel.axpydot
axpydot_ref = _ref.axpydot


@register_fusion(("Axpy", "Dot"))
def _fuse_axpy_dot(chain, sdfg, state, in_map, out_map):
    """StreamingComposition(axpy -> z -> dot) => one fused CUDA kernel."""
    axpy_n, dot_n = chain
    a_c = in_map[(axpy_n.label, "a")]
    x_c = in_map[(axpy_n.label, "x")]
    y_c = in_map[(axpy_n.label, "y")]
    w_c = in_map[(dot_n.label, "w")]
    r_c = out_map[(dot_n.label, "result")]

    def fn(**kw):
        return {r_c: axpydot(kw[a_c], kw[x_c], kw[y_c], kw[w_c])}

    return fn
