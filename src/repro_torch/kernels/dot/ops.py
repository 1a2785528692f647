"""Wrapper + Dot ``cuda`` expansion body for the DOT kernel."""
from __future__ import annotations

from . import kernel as _kernel
from . import ref as _ref

dot = _kernel.dot
dot_ref = _ref.dot


def dot_tasklet(x, w):
    """Tasklet body of the Dot Library Node's ``cuda`` expansion."""
    return dot(x, w)
