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
a slice the iteration reads (a gemv row ``A[i, 0:m]``, an attention row's
``K[b, 0:C, h, 0:Dh]``). Elementwise operations broadcast a scalar against
a window; ``sum`` and ``dot`` reduce a window to a scalar. Windows of up to
two axes also take ``@`` (a (n, m) window times an (m,) one, or an (n,)
window times an (n, m) one), ``iota`` (the positions 0..n-1 of a window
axis) and ``softmax`` over an (n,) window: the vocabulary of an attention
row. A body that leaves this vocabulary (indexing,
numpy/jax calls, data-dependent Python control flow) cannot be traced;
the grid backend then records a typed refusal at compile time and the
scope stays on the interpreter path.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .common import as_tensor


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

    def __and__(self, o):
        return self._bin("and", o)

    def __rand__(self, o):
        return self._bin("and", o, True)

    def __or__(self, o):
        return self._bin("or", o)

    def __ror__(self, o):
        return self._bin("or", o, True)

    def __matmul__(self, o):
        return matmul(self, o)

    def __rmatmul__(self, o):
        return matmul(o, self)

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

def _tensors(*xs):
    """The operands as tensors, a Python number on the device of the first
    tensor operand (``common.as_tensor``: filled there, not copied)."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return [as_tensor(x, dev) for x in xs]


def where(cond, a, b):
    if _is_traced(cond, a, b):
        return _elementwise("where", (cond, a, b))
    return torch.where(*_tensors(cond, a, b))


def maximum(a, b):
    if _is_traced(a, b):
        return _elementwise("maximum", (a, b))
    return torch.maximum(*_tensors(a, b))


def minimum(a, b):
    if _is_traced(a, b):
        return _elementwise("minimum", (a, b))
    return torch.minimum(*_tensors(a, b))


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


def matmul(a, b):
    """``a @ b`` of per-iteration windows: (n, m) @ (m,) -> (n,) (a
    matrix-vector product), (n,) @ (n, m) -> (m,) (a vector-matrix
    product) or (n,) @ (n,) -> a scalar (``dot``)."""
    if not _is_traced(a, b):
        return a @ b
    if not (isinstance(a, Traced) and isinstance(b, Traced)):
        raise TraceError("@ of a traced value and a Python number")
    wa, wb = a.window, b.window
    if len(wa) == 2 and len(wb) == 1 and wa[1] == wb[0]:
        return Traced("matvec", (a, b), window=(wa[0],))
    if len(wa) == 1 and len(wb) == 2 and wa[0] == wb[0]:
        return Traced("vecmat", (a, b), window=(wb[1],))
    if len(wa) == 1 and wa == wb:
        return dot(a, b)
    raise TraceError(f"@ of windows {wa} and {wb} is not in the traceable "
                     f"vocabulary")


def iota(n: int, like=None):
    """The positions 0..n-1 of a window axis of length ``n`` (an (n,)
    window); on tensors, ``torch.arange`` on ``like``'s device."""
    if isinstance(like, Traced):
        return Traced("iota", attr=int(n), window=(int(n),))
    return torch.arange(int(n), device=None if like is None else like.device)


def softmax(a):
    """Softmax over an (n,) window: exp(a - max a) / sum exp(a - max a)."""
    if isinstance(a, Traced):
        if len(a.window) != 1:
            raise TraceError(f"softmax over a window of shape {a.window}; "
                             f"only (n,) windows take it")
        return Traced("softmax", (a,), window=a.window)
    return torch.softmax(a, dim=-1)
