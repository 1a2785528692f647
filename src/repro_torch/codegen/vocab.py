"""The tasklet-body vocabulary shared by the torch interpreter and the
generated grid kernels.

A tasklet body is written with Python arithmetic and the functions below.
On torch tensors every function is the plain PyTorch operation, so the
interpreter (``torch_backend``) and the grid kernels' plain block programs
run bodies directly. On :class:`Traced` values — the proxies the cuda
backend feeds a body at compile time — every operation records one node of
an expression graph, which ``cuda_backend`` prints as Triton code.

A traced value describes ONE map iteration (the reference package's vmap
semantics): it is a scalar, or carries a *window* — the trailing shape of
a slice the iteration reads (a gemv row ``A[i, 0:m]``). Elementwise
operations broadcast a scalar against a window; ``sum`` and ``dot`` reduce
a window to a scalar. A body that leaves this vocabulary (indexing,
numpy/jax calls, data-dependent Python control flow) cannot be traced;
the grid backend then records a typed refusal at compile time and the
scope stays on the interpreter path.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


class TraceError(TypeError):
    """A tasklet body left the traceable vocabulary."""


class Traced:
    """One node of a traced tasklet-body expression graph.

    ``op`` names the operation, ``args`` are Traced nodes or Python
    numbers, ``attr`` carries op-specific static data (operand index for
    ``load``, the dtype name for ``cast``), ``window`` is the per-iteration
    trailing shape (``()`` for a scalar)."""

    __slots__ = ("op", "args", "attr", "window")
    __hash__ = object.__hash__

    def __init__(self, op: str, args=(), attr=None,
                 window: Tuple[int, ...] = ()):
        self.op = op
        self.args = tuple(args)
        self.attr = attr
        self.window = tuple(window)

    # -- arithmetic ------------------------------------------------------
    def _bin(self, op, other, swap=False):
        a, b = (other, self) if swap else (self, other)
        return _elementwise(op, (a, b))

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, True)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, True)

    def __pow__(self, o):
        if isinstance(o, int) and 1 <= o <= 8:
            out = self
            for _ in range(o - 1):
                out = out * self
            return out
        raise TraceError(f"power {o!r} is not in the traceable vocabulary")

    def __neg__(self):
        return _elementwise("neg", (self,))

    def __pos__(self):
        return self

    def __abs__(self):
        return _elementwise("abs", (self,))

    def __lt__(self, o):
        return self._bin("lt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __bool__(self):
        raise TraceError("data-dependent Python control flow on a traced "
                         "value")

    # -- torch-style methods ----------------------------------------------
    def float(self):
        return cast(self, "float32")

    def to(self, dtype):
        return cast(self, dtype)

    def sum(self):
        return sum(self)

    def reshape(self, *shape):
        if shape in ((-1,), ((-1,),)):
            return ravel(self)
        raise TraceError(f"reshape{shape} is not in the traceable "
                         f"vocabulary (only reshape(-1))")

    def __repr__(self):
        return f"Traced({self.op}, window={self.window})"


def _is_traced(*xs) -> bool:
    return any(isinstance(x, Traced) for x in xs)


def _window_of(args) -> Tuple[int, ...]:
    shapes = {a.window for a in args if isinstance(a, Traced) and a.window}
    if len(shapes) > 1:
        raise TraceError(f"elementwise operation over unequal windows "
                         f"{sorted(shapes)}")
    return shapes.pop() if shapes else ()


def _elementwise(op, args):
    for a in args:
        if not isinstance(a, (Traced, int, float, bool)):
            raise TraceError(f"operand {type(a).__name__} of {op!r} is "
                             f"neither traced nor a Python number")
    return Traced(op, args, window=_window_of(args))


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        return dtype
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# The vocabulary
# ---------------------------------------------------------------------------

def where(cond, a, b):
    if _is_traced(cond, a, b):
        return _elementwise("where", (cond, a, b))
    return torch.where(torch.as_tensor(cond), torch.as_tensor(a),
                       torch.as_tensor(b))


def maximum(a, b):
    if _is_traced(a, b):
        return _elementwise("maximum", (a, b))
    return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))


def minimum(a, b):
    if _is_traced(a, b):
        return _elementwise("minimum", (a, b))
    return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))


def exp(a):
    if _is_traced(a):
        return _elementwise("exp", (a,))
    return torch.exp(a) if isinstance(a, torch.Tensor) else math.exp(a)


def tanh(a):
    if _is_traced(a):
        return _elementwise("tanh", (a,))
    return torch.tanh(a) if isinstance(a, torch.Tensor) else math.tanh(a)


def cast(a, dtype):
    """``a`` converted to ``dtype`` (a name like ``"float32"`` or a
    ``torch.dtype``)."""
    name = _dtype_name(dtype)
    if isinstance(a, Traced):
        return Traced("cast", (a,), attr=name, window=a.window)
    if isinstance(a, torch.Tensor):
        return a.to(getattr(torch, name))
    return a


def to_f32(a):
    """``a`` in float32 — the accumulation type of every reduction."""
    return cast(a, "float32")


def ravel(a):
    """The per-iteration value flattened to one window axis."""
    if isinstance(a, Traced):
        return Traced("ravel", (a,),
                      window=(math.prod(a.window),) if a.window else ())
    return a.reshape(-1)


def sum(a):  # noqa: A001  (the vocabulary mirrors the array API name)
    """Sum over the whole per-iteration value (its window)."""
    if isinstance(a, Traced):
        return Traced("sum", (a,)) if a.window else a
    return torch.sum(a)


def dot(a, b):
    """Σ a·b over the per-iteration windows (``jnp.dot`` of two vectors)."""
    if _is_traced(a, b):
        prod = _elementwise("mul", (a, b))
        return Traced("sum", (prod,)) if prod.window else prod
    return torch.sum(a * b)
