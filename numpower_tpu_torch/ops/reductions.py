"""Reductions and arg-extrema (the port's counterpart of
numpower_tpu/ops/reductions.py): one torch reduction each, with NumPy's axis
and keepdims and the JAX package's semantics and dtypes:

- min/max and argmin/argmax propagate NaN (the first NaN wins);
- median is NumPy's (the mean of the two middle elements of an even count,
  NaN where a NaN is present), from a sort, as jnp.median;
- index results and integer sums are int32 (the JAX package runs with 64-bit
  types off; torch gives int64).
"""

from __future__ import annotations

import numpy as np
import torch

from numpower_tpu_torch.ops.creation import as_operands, asarray, dims, promoted


def _int32(x: torch.Tensor) -> torch.Tensor:
    """torch's int64 sum or product of integers as the JAX package's int32."""
    return x.to(torch.int32) if x.dtype == torch.int64 else x


def _integral(x: torch.Tensor) -> torch.Tensor:
    """bool as int32, as a JAX sum or product takes it."""
    return x.to(torch.int32) if x.dtype == torch.bool else x


def sum(a, axis=None, keepdims: bool = False):  # noqa: A001
    return _int32(torch.sum(_integral(asarray(a)), dim=dims(axis), keepdim=keepdims))


def prod(a, axis=None, keepdims: bool = False):
    a = _integral(asarray(a))
    if isinstance(axis, (list, tuple)):
        for ax in sorted((ax % a.ndim for ax in axis), reverse=True):
            a = torch.prod(a, dim=ax, keepdim=keepdims)
        return _int32(a)
    if axis is None:
        out = torch.prod(a)
        return _int32(out.reshape((1,) * a.ndim) if keepdims else out)
    return _int32(torch.prod(a, dim=axis, keepdim=keepdims))


def mean(a, axis=None, keepdims: bool = False):
    a = asarray(a)
    if not a.dtype.is_floating_point:
        a = a.to(torch.float32)
    return torch.mean(a, dim=dims(axis), keepdim=keepdims)


def median(a, axis=None, keepdims: bool = False):
    """NumPy's median: for an even count the mean of the two middle elements
    (torch.median gives the lower one), as the linear 0.5-quantile."""
    return sorted_quantile(a, 0.5, axis=axis, keepdims=keepdims)


def normalized_axes(axis, ndim: int) -> tuple:
    """An int or a sequence of axes as sorted nonnegative ones."""
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    return tuple(sorted(ax % ndim for ax in axes))


def sorted_quantile(a, q, axis=None, keepdims: bool = False, scale: float = 1.0):
    """The q-th quantiles (q a scalar or 1-d) by linear interpolation
    between the sorted elements: at position p = q (n - 1), the elements at
    floor(p) and ceil(p), weighted 1 - (p - floor(p)) and p - floor(p). With
    a 1-d q the quantiles lead the result's axes. `scale` multiplies n - 1
    in float32 before q does (statistics.percentile's 0.01)."""
    a, q = as_operands(a, q)
    if not a.dtype.is_floating_point:
        a = a.to(torch.float32)
    q = q.to(a.dtype)
    if q.ndim > 1:
        raise ValueError(f"q must be have rank <= 1, got shape {tuple(q.shape)}")
    shape = a.shape
    if axis is None:
        kept = (1,) * a.ndim
        a, axis = a.reshape(-1), 0
    else:
        axes = normalized_axes(axis, a.ndim)
        kept = tuple(1 if d in axes else s for d, s in enumerate(shape))
        rest = [d for d in range(a.ndim) if d not in axes]
        a = a.permute(*rest, *axes).reshape(*(shape[d] for d in rest), -1)
        axis = a.ndim - 1
    a = torch.where(torch.isnan(a).any(dim=axis, keepdim=True), float("nan"), a)
    a = torch.sort(a, dim=axis).values
    n = a.shape[axis]
    # the position q (n - 1); for a percentile (scale 0.01) q (0.01 (n - 1)),
    # the float32 constant XLA folds jnp.percentile's q / 100 (n - 1) into
    pos = q * torch.tensor(scale, dtype=a.dtype).mul(n - 1).item()
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1 - high_weight
    low = low.clamp(0, n - 1).to(torch.int64)
    high = high.clamp(0, n - 1).to(torch.int64)
    a = a.movedim(axis, 0)
    low_value, high_value = a[low], a[high]  # (*q.shape, *rest)
    extra = (1,) * (a.ndim - 1)
    low_weight = low_weight.reshape(q.shape + extra)
    high_weight = high_weight.reshape(q.shape + extra)
    result = low_value * low_weight + high_value * high_weight
    if keepdims:
        result = result.reshape(q.shape + kept)
    return result


def _extremum(fn, a, axis, keepdims):
    a = asarray(a)
    if axis is None:
        out = fn(a)
        return out.reshape((1,) * a.ndim) if keepdims else out
    return fn(a, dim=dims(axis), keepdim=keepdims)


def min(a, axis=None, keepdims: bool = False):  # noqa: A001
    return _extremum(torch.amin, a, axis, keepdims)


def max(a, axis=None, keepdims: bool = False):  # noqa: A001
    return _extremum(torch.amax, a, axis, keepdims)


def argmin(a, axis=None, keepdims: bool = False):
    """The index of the first minimum (of the first NaN, where one is
    present), int32; over the flattened array where axis is None."""
    return _extremum(torch.argmin, a, axis, keepdims).to(torch.int32)


def argmax(a, axis=None, keepdims: bool = False):
    return _extremum(torch.argmax, a, axis, keepdims).to(torch.int32)


def _along(a, axis):
    """`a` flattened where axis is None, and the axis to work along."""
    a = asarray(a)
    return (a.reshape(-1), 0) if axis is None else (a, axis)


def cumsum(a, axis=None):
    """In `a`'s dtype (bool counted as int32), as in the JAX package; torch
    gives int64 for an integer `a`."""
    a, axis = _along(a, axis)
    a = _integral(a)
    return torch.cumsum(a, dim=axis, dtype=a.dtype)


def cumprod(a, axis=None):
    a, axis = _along(a, axis)
    a = _integral(a)
    return torch.cumprod(a, dim=axis, dtype=a.dtype)


def _sort_axis(a, axis):
    """_along's array and axis, the axis checked as jnp.sort checks it: a
    0-d array has none (torch would sort it along dim -1 or 0)."""
    a, ax = _along(a, axis)
    if not -a.ndim <= ax < a.ndim:
        raise ValueError(f"axis {axis} is out of bounds for array of dimension {a.ndim}")
    return a, ax


def sort(a, axis=-1):
    """Ascending, NaN last; stable."""
    a, axis = _sort_axis(a, axis)
    return torch.sort(a, dim=axis, stable=True).values


def argsort(a, axis=-1):
    a, axis = _sort_axis(a, axis)
    return torch.argsort(a, dim=axis, stable=True).to(torch.int32)


def take(a, indices, axis=None):
    """Elements of `a` at `indices` along `axis` (of the flattened array
    where it is None), with jnp.take's default mode: a negative index counts
    from the end, and an index outside [-n, n) gives NaN (the most negative
    integer for a signed integer type, the largest for an unsigned one,
    True for bool)."""
    a = asarray(a)
    if not isinstance(indices, torch.Tensor):  # integers, as jnp.asarray takes them
        indices = asarray(np.asarray(indices), device=a.device)
    a, axis = _along(a, axis)
    axis %= a.ndim
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    outside = (idx < 0) | (idx >= n)
    got = torch.index_select(a, axis, idx.clamp(0, n - 1).reshape(-1))
    got = got.reshape(a.shape[:axis] + indices.shape + a.shape[axis + 1:])
    if a.dtype.is_floating_point or a.dtype.is_complex:
        fill = float("nan")
    elif a.dtype == torch.bool:
        fill = True
    else:
        info = torch.iinfo(a.dtype)
        fill = info.min if info.min < 0 else info.max
    mask = outside.reshape((1,) * axis + indices.shape + (1,) * (a.ndim - axis - 1))
    return torch.where(mask, torch.full((), fill, dtype=a.dtype, device=a.device), got)


def searchsorted(a, v, side="left"):
    """Insertion points of v in the sorted 1-d array a, int32."""
    a, v = promoted(a, v)
    out = torch.searchsorted(a, v.reshape(1) if v.ndim == 0 else v, side=side)
    return out.reshape(v.shape).to(torch.int32)
