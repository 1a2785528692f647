"""Memlets: data-movement annotations on dataflow edges (paper Fig. 2/7).

A memlet names the data container being moved, the subset being accessed
(symbolic ranges, possibly referencing map parameters), the total data
volume moved over the lifetime of the scope (e.g. ``K*M*N/P`` in Fig. 7),
and an optional write-conflict resolution (``wcr``) for accumulation.

The *access order* of a memlet — its index expressions with map parameters
canonicalized to positional indices — is what StreamingComposition compares
to decide whether a producer and consumer can be fused through a stream.

``factor_subset`` is the grid-codegen analysis (paper: memlets become the
platform kernel's address generators): it factors an affine subset into a
``block_shape`` plus per-dimension block-coordinate expressions over the
map parameters — exactly the ``(block_shape, index_map)`` pair a Pallas
``BlockSpec`` needs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, Mapping, Optional, Sequence, Tuple

from .symbolic import Expr, ExprLike, prod


@dataclass(frozen=True)
class Range:
    """Half-open symbolic range [start, stop) with step."""
    start: Expr
    stop: Expr
    step: Expr

    @staticmethod
    def make(start: ExprLike, stop: ExprLike, step: ExprLike = 1) -> "Range":
        return Range(Expr.wrap(start), Expr.wrap(stop), Expr.wrap(step))

    @staticmethod
    def index(i: ExprLike) -> "Range":
        e = Expr.wrap(i)
        return Range(e, e + 1, Expr.const(1))

    @property
    def size(self) -> Expr:
        return (self.stop - self.start) / self.step

    def is_index(self) -> bool:
        # size == 1 without forming (stop-start)/step: symbolic division
        # by a multi-term step (a per-iteration stride like i+1) raises
        return self.stop - self.start == self.step

    def subs(self, env) -> "Range":
        return Range(self.start.subs(env), self.stop.subs(env), self.step.subs(env))

    def __repr__(self):
        if self.is_index():
            return f"[{self.start}]"
        s = f"[{self.start}:{self.stop}"
        if self.step != Expr.const(1):
            s += f":{self.step}"
        return s + "]"


class Subset(tuple):
    """Tuple of Ranges, one per container dimension."""

    def __new__(cls, ranges: Sequence[Range]):
        return super().__new__(cls, tuple(ranges))

    @staticmethod
    def full(shape: Sequence[ExprLike]) -> "Subset":
        return Subset([Range.make(0, s) for s in shape])

    @staticmethod
    def indices(idx: Sequence[ExprLike]) -> "Subset":
        return Subset([Range.index(i) for i in idx])

    @property
    def num_elements(self) -> Expr:
        return prod(r.size for r in self)

    def subs(self, env) -> "Subset":
        return Subset([r.subs(env) for r in self])

    def __repr__(self):
        return "".join(repr(r) for r in self)


@dataclass
class Memlet:
    """Data movement annotation: container + subset + volume (+ wcr)."""
    data: str
    subset: Optional[Subset] = None       # None = whole container
    volume: Optional[Expr] = None         # None = subset.num_elements (once)
    wcr: Optional[str] = None             # e.g. "add" for accumulation writes
    dynamic: bool = False                 # data-dependent volume

    @staticmethod
    def simple(data: str, subset: Optional[Subset] = None,
               volume: ExprLike = None, wcr: str = None) -> "Memlet":
        v = Expr.wrap(volume) if volume is not None else None
        return Memlet(data=data, subset=subset, volume=v, wcr=wcr)

    def volume_or_subset(self) -> Optional[Expr]:
        if self.volume is not None:
            return self.volume
        if self.subset is not None:
            return self.subset.num_elements
        return None

    def access_order(self, param_names: Sequence[str]) -> Tuple:
        """Canonical access-order key: index expressions with map params
        remapped to positional placeholders (paper §3.2.3). Two memlets with
        equal keys iterate their containers in the same order."""
        if self.subset is None:
            return ("FULL", self.data and None)
        env = {p: Expr.sym(f"__i{k}") for k, p in enumerate(param_names)}
        return tuple(
            (r.start.subs(env), r.stop.subs(env), r.step.subs(env))
            for r in self.subset
        )

    def __repr__(self):
        s = f"Memlet({self.data}{self.subset if self.subset is not None else ''}"
        if self.volume is not None:
            s += f", vol={self.volume}"
        if self.wcr:
            s += f", wcr={self.wcr}"
        return s + ")"


# ---------------------------------------------------------------------------
# Subset -> (block_shape, index_map) factorization for grid codegen
# ---------------------------------------------------------------------------


class BlockFactorError(ValueError):
    """Raised when a subset cannot be factored into blocked form (non-affine
    indices, unaligned offsets, dynamic symbols, ...). Callers fall back to
    the structural-interpreter lowering, mirroring the paper's fallback to
    generic expansions."""


def _int_coeff(c, context) -> int:
    if isinstance(c, Fraction):
        if c.denominator != 1:
            raise BlockFactorError(f"non-integer coefficient {c} in {context}")
        return c.numerator
    return int(c)


def _affine_coeffs(e: Expr, context) -> Tuple[int, Dict[str, int]]:
    """Decompose ``e`` as ``c0 + sum(c_s * s)``; reject higher degrees."""
    c0, coeffs = 0, {}
    for mono, c in e.terms.items():
        if mono == ():
            c0 = _int_coeff(c, context)
        elif len(mono) == 1 and mono[0][1] == 1:
            coeffs[mono[0][0]] = _int_coeff(c, context)
        else:
            raise BlockFactorError(f"non-affine index {e} in {context}")
    return c0, coeffs


def eval_affine(e: Expr, env: Mapping[str, object]):
    """Evaluate an integer-affine Expr where symbols may be bound to traced
    scalars (used by BlockSpec index maps at kernel-trace time)."""
    const, out = 0, None
    for mono, c in e.terms.items():
        ci = _int_coeff(c, e)
        if mono == ():
            const += ci
        else:
            (name, _), = mono
            term = env[name] if ci == 1 else ci * env[name]
            out = term if out is None else out + term
    if out is None:
        return const
    return out + const if const else out


@dataclass(frozen=True)
class SubsetFactorization:
    """A subset factored into per-dimension blocks.

    ``block_shape[d]`` elements are moved per grid step along dim ``d``;
    ``index_exprs[d]`` gives the *block* coordinate as an integer-affine
    expression over 0-based grid parameters; ``squeeze_dims`` are the
    size-1 index dimensions ``read_memlet`` squeezes; ``param_dims`` maps
    each intra-block (tile) parameter to the container dimension it spans.

    ``windows`` handles block-*misaligned* affine accesses (stencil halo
    offsets): a windowed dimension moves the whole container extent per
    grid step (``block_shape[d]`` = container dim, block coordinate 0) and
    the kernel body slices an element-addressed window out of it in-VMEM —
    each entry is ``(dim, element-start Expr over grid params, length)``.
    """
    block_shape: Tuple[int, ...]
    index_exprs: Tuple[Expr, ...]
    squeeze_dims: Tuple[int, ...]
    param_dims: Tuple[Tuple[str, int], ...] = ()
    windows: Tuple[Tuple[int, Expr, int], ...] = ()

    def index_map(self, param_order: Sequence[str]):
        """Build ``f(*grid_ids) -> block coords`` for a Pallas BlockSpec."""
        exprs = self.index_exprs
        names = tuple(param_order)

        def f(*ids):
            env = dict(zip(names, ids))
            return tuple(eval_affine(e, env) for e in exprs)

        return f

    def effective_shape(self) -> Tuple[int, ...]:
        """Shape of the value the kernel body sees: the block shape with
        windowed dimensions narrowed to their window length."""
        shp = list(self.block_shape)
        for d, _, ln in self.windows:
            shp[d] = ln
        return tuple(shp)


def factor_subset(subset: Optional[Subset], shape: Sequence[ExprLike],
                  grid_params: Mapping[str, Tuple[int, int]],
                  block_params: Mapping[str, int],
                  env: Mapping[str, int],
                  allow_windows: bool = False) -> SubsetFactorization:
    """Factor ``subset`` into ``(block_shape, index_map)`` form.

    ``grid_params`` maps each grid parameter to its ``(range_start, size)``
    — index expressions are rebased so parameters are 0-based grid
    coordinates. ``block_params`` map intra-block (tile) parameters to
    their extents; a dimension indexed by a tile parameter widens into a
    block of that extent. ``env`` binds the remaining *static* symbols.
    Raises :class:`BlockFactorError` when the subset is non-affine, refers
    to unknown (dynamic) symbols, or its offsets don't align to the block.

    With ``allow_windows``, a block-misaligned dimension (a stencil halo
    offset, a non-block-multiple grid stride) degrades to a *window*
    instead of raising: the BlockSpec moves the whole container dimension
    and the factorization records an element-addressed window the kernel
    body slices per grid step.
    """
    env = dict(env)
    shape_sizes = []
    for s in shape:
        try:
            shape_sizes.append(Expr.wrap(s).evaluate(env))
        except Exception as exc:
            raise BlockFactorError(f"dynamic container shape {s}") from exc
    if subset is None:
        return SubsetFactorization(
            tuple(shape_sizes),
            tuple(Expr.const(0) for _ in shape_sizes), ())
    if len(subset) != len(shape_sizes):
        raise BlockFactorError(
            f"subset rank {len(subset)} != container rank {len(shape_sizes)}")
    rebase = {p: Expr.sym(p) + st for p, (st, _) in grid_params.items()
              if st != 0}
    block_shape, exprs, squeeze = [], [], []
    param_dims: Dict[str, int] = {}
    windows = []
    for d, r in enumerate(subset):
        ctx = f"dim {d} of {subset}"
        step = r.step.subs(env)
        if not step.is_const() or step.as_int() != 1:
            raise BlockFactorError(f"strided range (step {step}) in {ctx}")
        size = r.size.subs(env)
        if not size.is_const():
            raise BlockFactorError(f"dynamic range size {size} in {ctx}")
        sz = size.as_int()
        start = r.start.subs(env)
        if rebase:
            start = start.subs(rebase)
        c0, coeffs = _affine_coeffs(start, ctx)
        unknown = set(coeffs) - set(grid_params) - set(block_params)
        if unknown:
            raise BlockFactorError(f"unbound symbols {sorted(unknown)} in {ctx}")
        bsyms = sorted(s for s in coeffs if s in block_params)
        q = None
        if bsyms:
            if len(bsyms) > 1:
                raise BlockFactorError(
                    f"multiple tile params {bsyms} in one dimension ({ctx})")
            q = bsyms[0]
            if sz != 1 or coeffs[q] != 1:
                raise BlockFactorError(
                    f"tile param {q} must index with unit stride a size-1 "
                    f"range ({ctx})")
            if q in param_dims:
                raise BlockFactorError(
                    f"tile param {q} indexes two dimensions ({ctx})")
            bs = block_params[q]
            param_dims[q] = d
        else:
            bs = sz
        if bs <= 0:
            raise BlockFactorError(f"empty block in {ctx}")
        misaligned = bool(c0 % bs) or any(
            cg % bs for g, cg in coeffs.items() if g not in block_params)
        if misaligned and allow_windows and bs > 1:
            # whole container dimension per step; element-addressed window
            start_expr = Expr.const(c0)
            for g, cg in coeffs.items():
                if g not in block_params:
                    start_expr = start_expr + Expr.sym(g) * cg
            block_shape.append(shape_sizes[d])
            exprs.append(Expr.const(0))
            windows.append((d, start_expr, bs))
            continue
        if c0 % bs:
            raise BlockFactorError(
                f"offset {c0} not aligned to block {bs} ({ctx})")
        iexpr = Expr.const(c0 // bs)
        for g, cg in coeffs.items():
            if g in block_params:
                continue
            if cg % bs:
                raise BlockFactorError(
                    f"grid coefficient {cg} of {g} not divisible by block "
                    f"{bs} ({ctx})")
            iexpr = iexpr + Expr.sym(g) * (cg // bs)
        block_shape.append(bs)
        exprs.append(iexpr)
        if r.is_index() and bs == 1:
            squeeze.append(d)
    return SubsetFactorization(tuple(block_shape), tuple(exprs),
                               tuple(squeeze),
                               tuple(sorted(param_dims.items())),
                               tuple(windows))
