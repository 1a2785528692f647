"""Shared codegen utilities: symbolic-expression evaluation against
(possibly vmapped) torch values, and memlet-driven container reads/writes.

The paper's code generator translates memlets into array indexing / stream
push-pop; here they become (gathered) slice reads and out-of-place writes.
The IR assumes functional writes, so every write returns a new container
value (``clone`` + slice assignment, ``index_put``/``scatter_reduce``
style accumulation) and never mutates the value it was given.
Write-conflict resolution (``wcr='add'``) lowers to an accumulating
index write, which tolerates duplicate indices.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, Tuple

import torch

from ..core.memlet import Memlet, Subset
from ..core.symbolic import Expr


def eval_expr(expr: Expr, env: Dict[str, object]):
    """Evaluate an Expr where symbols may be bound to python ints or
    (vmapped) integer tensors. Returns int when fully static."""
    if isinstance(expr, (int, float)):
        return expr
    result = None
    for mono, coeff in expr.terms.items():
        term = None
        for name, power in mono:
            if name not in env:
                raise KeyError(f"unbound symbol {name!r} in {expr}")
            v = env[name]
            for _ in range(power):
                term = v if term is None else term * v
        if isinstance(coeff, Fraction) and coeff.denominator == 1:
            coeff = coeff.numerator
        if term is None:
            term = coeff
        elif coeff != 1:
            if isinstance(coeff, Fraction):
                # exact rational scaling of a traced/int value
                term = term * coeff.numerator
                term = term // coeff.denominator
            else:
                term = coeff * term
        result = term if result is None else result + term
    return 0 if result is None else result


class DynamicStrideError(NotImplementedError):
    """A memlet's stride (or a strided start) is only known once map
    parameters are bound, which the vectorized lowering cannot address.
    Map lowerings catch this and degrade to the sequential structural
    interpreter, where parameter bindings are Python ints."""


def _static_int(v) -> bool:
    return isinstance(v, int)


def subset_static_sizes(subset: Subset, env: Dict[str, object]) -> Tuple[int, ...]:
    """Range sizes must be static. Sizes are the *element counts*:
    ceil((stop-start)/step), so strided half-open ranges whose span is not
    a step multiple (x[0:15:2]) size like numpy."""
    static = {k: v for k, v in env.items() if _static_int(v)}
    sizes = []
    for r in subset:
        span = eval_expr(r.stop - r.start, static)
        step = eval_expr(r.step, static)
        if not _static_int(span) or not _static_int(step):
            raise ValueError(
                f"memlet range size must be static, got {r.size}")
        sizes.append(-(-span // step))
    return tuple(sizes)


def as_tensor(v, device, dtype=None) -> torch.Tensor:
    """``v`` as a tensor on ``device``: a tensor as ``torch.as_tensor``
    gives it, a Python number filled on the device rather than copied from
    host memory (a served decode step is captured as a CUDA graph, where
    no host memory may be read)."""
    if isinstance(v, (bool, int, float)):
        return torch.full((), v, device=device,
                          dtype=dtype or torch.as_tensor(v).dtype)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _as_index(v, device):
    return v if isinstance(v, torch.Tensor) else as_tensor(
        v, device, torch.long)


def read_memlet(value, memlet: Memlet, env: Dict[str, object]):
    """Read the memlet's subset out of a container value. Index (size-1)
    dimensions are squeezed, DaCe-style. Strides must be static: static
    starts lower to strided slices, tensor starts (vmapped parameters) to
    per-dimension gathers (needed e.g. for interleaved partial-sum subsets
    like ``x[l::K]``)."""
    if memlet.subset is None:
        return value
    subset = memlet.subset
    sizes = subset_static_sizes(subset, env)
    starts = [eval_expr(r.start, env) for r in subset]
    steps = [eval_expr(r.step, env) for r in subset]
    if any(not _static_int(s) for s in steps):
        raise DynamicStrideError("dynamic memlet strides not supported")
    squeeze = tuple(i for i, r in enumerate(subset) if r.is_index())
    if len(squeeze) == len(subset):
        if all(_static_int(s) for s in starts):
            return value[tuple(starts)]
        return value[tuple(_as_index(s, value.device) for s in starts)]
    if all(_static_int(s) for s in starts):
        out = value[tuple(slice(st, st + sz * sp, sp)
                          for st, sz, sp in zip(starts, sizes, steps))]
    else:
        # tensor start with a static stride: gather along each dimension
        out = value
        for d, (st, sz, sp) in enumerate(zip(starts, sizes, steps)):
            if sz == out.shape[d] and _static_int(st) and st == 0 and sp == 1:
                continue
            idx = st + sp * torch.arange(sz, device=value.device)
            out = torch.index_select(out, d, idx) if _static_int(st) \
                else _take(out, idx, d)
    if squeeze:
        for d in sorted(squeeze, reverse=True):
            out = out.squeeze(d)
    return out


def _take(value, idx, dim):
    """``value`` gathered at ``idx`` along ``dim`` by advanced indexing
    (works on vmapped index tensors, unlike ``index_select``)."""
    key = (slice(None),) * dim + (idx,)
    return value[key]


def write_memlet(container_value, memlet: Memlet, new_value,
                 env: Dict[str, object]):
    """Functionally write ``new_value`` into the container per the memlet.
    Returns the updated container value (never the input object mutated).
    Static starts support static strides (mirroring ``read_memlet``);
    tensor starts require unit steps — a strided dynamic write would need
    a scatter and fails loudly."""
    wcr = memlet.wcr
    new_value = as_tensor(new_value, container_value.device)
    if memlet.subset is None:
        if wcr in WCR_MODES:
            return wcr_combine(wcr, container_value, new_value)
        if tuple(new_value.shape) != tuple(container_value.shape):
            return new_value.to(container_value.dtype).expand(
                container_value.shape).clone()
        return new_value.to(container_value.dtype)
    subset = memlet.subset
    sizes = subset_static_sizes(subset, env)
    starts = [eval_expr(r.start, env) for r in subset]
    steps = [eval_expr(r.step, env) for r in subset]
    if any(not _static_int(s) for s in steps):
        raise DynamicStrideError("dynamic memlet strides not supported")
    if all(r.is_index() for r in subset):
        if new_value.dim():
            new_value = new_value.reshape(())
        key = tuple(s if _static_int(s) else _as_index(s, new_value.device)
                    for s in starts)
        return apply_wcr_at(container_value, key, wcr, new_value)
    new_value = new_value.reshape(sizes)
    if all(_static_int(s) for s in starts):
        key = tuple(slice(st, st + sz * sp, sp)
                    for st, sz, sp in zip(starts, sizes, steps))
        return apply_wcr_at(container_value, key, wcr, new_value)
    if any(sp != 1 for sp in steps):
        # a tensor start with a stride would need a scatter; landing the
        # values on contiguous positions would be silently wrong
        raise DynamicStrideError(
            "strided memlet writes with traced starts not supported")
    idx = [_as_index(st, new_value.device) + torch.arange(
        sz, device=new_value.device) for st, sz in zip(starts, sizes)]
    key = torch.meshgrid(*idx, indexing="ij")
    return apply_wcr_at(container_value, key, wcr, new_value)


def apply_wcr_at(container_value, key, wcr, value):
    """Out-of-place ``container[key] = wcr(container[key], value)`` — the
    counterpart of JAX's ``.at[key].set/add/max/min``. Advanced-index
    keys with repeated positions accumulate under ``add``/``max``/``min``
    (``index_put(accumulate=True)`` / ``scatter_reduce``)."""
    out = container_value.clone()
    value = as_tensor(value, out.device).to(out.dtype)
    advanced = any(isinstance(k, torch.Tensor) for k in key)
    if not advanced:
        if wcr in WCR_MODES:
            out[key] = wcr_combine(wcr, out[key], value)
        else:
            out[key] = value
        return out
    idx = torch.broadcast_tensors(*[
        k if isinstance(k, torch.Tensor) else as_tensor(k, out.device)
        for k in key])
    value = value.expand(idx[0].shape) if value.dim() == 0 else \
        torch.broadcast_to(value, idx[0].shape)
    if wcr is None:
        return out.index_put_(tuple(idx), value)
    if wcr == "add":
        return out.index_put_(tuple(idx), value, accumulate=True)
    flat = _flat_index(idx, out.shape)
    reduce = "amax" if wcr == "max" else "amin"
    return out.reshape(-1).scatter_reduce(
        0, flat.reshape(-1), value.reshape(-1), reduce=reduce,
        include_self=True).reshape(out.shape)


def _flat_index(idx, shape):
    flat = torch.zeros_like(idx[0])
    for k, n in zip(idx, shape):
        flat = flat * n + k
    return flat


# ---------------------------------------------------------------------------
# The single wcr dispatch table shared by both backends: elementwise
# combine, axis reduce, and identity element per mode. WCR_MODES derives
# from these keys, so a mode can never be half-supported.
# ---------------------------------------------------------------------------

def _amax(v, axis):
    return torch.amax(v, dim=axis) if _has_axes(axis) else v


def _amin(v, axis):
    return torch.amin(v, dim=axis) if _has_axes(axis) else v


def _sum(v, axis):
    return torch.sum(v, dim=axis) if _has_axes(axis) else v


def _has_axes(axis) -> bool:
    return not isinstance(axis, (tuple, list)) or len(axis) > 0


_WCR_TABLE = {
    "add": (lambda a, b: a + b, _sum),
    "max": (torch.maximum, _amax),
    "min": (torch.minimum, _amin),
}

#: wcr modes with accumulate semantics (reductions / combining stitches);
#: anything else is a plain overwrite.
WCR_MODES = tuple(_WCR_TABLE)


def wcr_combine(wcr: str, a, b):
    if not isinstance(b, torch.Tensor):
        b = as_tensor(b, a.device, a.dtype)
    return _WCR_TABLE[wcr][0](a, b.to(a.dtype))


def wcr_reduce(wcr: str, value, axis):
    if isinstance(axis, list):
        axis = tuple(axis)
    return _WCR_TABLE[wcr][1](value, axis)


def wcr_identity(wcr: str, dtype):
    """The mode's identity element as a Python number: accumulator init
    value (the float type's finite extreme for max/min, as in the
    reference package)."""
    if wcr == "add":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return info.min if wcr == "max" else info.max
