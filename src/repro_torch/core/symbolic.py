"""Tiny symbolic-expression engine for memlet volumes and shapes.

The paper annotates every dataflow edge with a (possibly symbolic) data
volume, e.g. ``K*M*N/P`` for the systolic-array B reader in Fig. 7.  DaCe
uses sympy; we implement the minimal subset needed: integer-coefficient
sums of products of named symbols, with substitution and exact division.

Expressions are immutable and hashable.  ``simplify`` is canonical enough
for equality testing of the access-order expressions compared by the
StreamingComposition transformation.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Iterable, Mapping, Union

Number = Union[int, Fraction]


def _as_frac(x) -> Fraction:
    if isinstance(x, Fraction):
        return x
    if isinstance(x, int):
        return Fraction(x)
    raise TypeError(f"non-integer coefficient {x!r}")


class Expr:
    """Canonical polynomial: {monomial(tuple of sorted symbol names w/ powers): coeff}."""

    __slots__ = ("terms",)

    def __init__(self, terms: Mapping[tuple, Number] | None = None):
        t = {}
        for mono, c in (terms or {}).items():
            c = _as_frac(c)
            if c != 0:
                t[mono] = t.get(mono, Fraction(0)) + c
        self.terms = {m: c for m, c in t.items() if c != 0}

    # -- constructors -------------------------------------------------
    @staticmethod
    def const(v) -> "Expr":
        return Expr({(): _as_frac(v)})

    @staticmethod
    def sym(name: str) -> "Expr":
        return Expr({((name, 1),): Fraction(1)})

    @staticmethod
    def wrap(v: "ExprLike") -> "Expr":
        if isinstance(v, Expr):
            return v
        if isinstance(v, str):
            return Expr.sym(v)
        return Expr.const(v)

    # -- algebra -------------------------------------------------------
    def __add__(self, other):
        other = Expr.wrap(other)
        t = dict(self.terms)
        for m, c in other.terms.items():
            t[m] = t.get(m, Fraction(0)) + c
        return Expr(t)

    __radd__ = __add__

    def __neg__(self):
        return Expr({m: -c for m, c in self.terms.items()})

    def __sub__(self, other):
        return self + (-Expr.wrap(other))

    def __rsub__(self, other):
        return Expr.wrap(other) - self

    def __mul__(self, other):
        other = Expr.wrap(other)
        t: dict = {}
        for m1, c1 in self.terms.items():
            for m2, c2 in other.terms.items():
                powers: dict = {}
                for n, p in m1 + m2:
                    powers[n] = powers.get(n, 0) + p
                mono = tuple(sorted(powers.items()))
                t[mono] = t.get(mono, Fraction(0)) + c1 * c2
        return Expr(t)

    __rmul__ = __mul__

    def __truediv__(self, other):
        other = Expr.wrap(other)
        if other.is_const():
            c = other.as_const()
            if c == 0:
                raise ZeroDivisionError
            return Expr({m: v / c for m, v in self.terms.items()})
        # symbolic divisor: divide every monomial (negative powers allowed —
        # rational monomials like K*M*N/P, paper Fig. 7)
        if len(other.terms) == 1:
            (dm, dc), = other.terms.items()
            t = {}
            for m, c in self.terms.items():
                powers = dict(m)
                for n, p in dm:
                    powers[n] = powers.get(n, 0) - p
                mono = tuple(sorted((n, p) for n, p in powers.items() if p != 0))
                t[mono] = t.get(mono, Fraction(0)) + c / dc
            return Expr(t)
        raise ValueError(f"cannot divide by {other}")

    def __floordiv__(self, other):
        return self / other

    # -- queries -------------------------------------------------------
    def is_const(self) -> bool:
        return all(m == () for m in self.terms)

    def as_const(self) -> Fraction:
        if not self.terms:
            return Fraction(0)
        if not self.is_const():
            raise ValueError(f"{self} is not constant")
        return self.terms[()]

    def as_int(self) -> int:
        c = self.as_const()
        if c.denominator != 1:
            raise ValueError(f"{self} is not an integer")
        return c.numerator

    @property
    def free_symbols(self) -> set:
        out = set()
        for m in self.terms:
            for n, _ in m:
                out.add(n)
        return out

    def subs(self, env: Mapping[str, "ExprLike"]) -> "Expr":
        out = Expr.const(0)
        for m, c in self.terms.items():
            term = Expr.const(c)
            for n, p in m:
                rep = Expr.wrap(env[n]) if n in env else Expr.sym(n)
                if p >= 0:
                    for _ in range(p):
                        term = term * rep
                else:
                    for _ in range(-p):
                        term = term / rep
            out = out + term
        return out

    def evaluate(self, env: Mapping[str, int]) -> int:
        v = self.subs(env)
        return v.as_int()

    # -- identity ------------------------------------------------------
    def _key(self):
        return tuple(sorted(self.terms.items()))

    def __eq__(self, other):
        if isinstance(other, (int, Fraction)):
            other = Expr.const(other)
        if not isinstance(other, Expr):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        if not self.terms:
            return "0"
        parts = []
        for m, c in sorted(self.terms.items()):
            syms = "*".join(n if p == 1 else f"{n}**{p}" for n, p in m)
            if m == ():
                parts.append(str(c))
            elif c == 1:
                parts.append(syms)
            else:
                parts.append(f"{c}*{syms}")
        return " + ".join(parts)


ExprLike = Union[Expr, int, str, Fraction]


def sym(name: str) -> Expr:
    return Expr.sym(name)


def simplify(e: ExprLike) -> Expr:
    return Expr.wrap(e)


def evaluate(e: ExprLike, env: Mapping[str, int]) -> int:
    return Expr.wrap(e).evaluate(env)


def prod(xs: Iterable[ExprLike]) -> Expr:
    out = Expr.const(1)
    for x in xs:
        out = out * Expr.wrap(x)
    return out
