"""Statistics ops (the port's counterpart of numpower_tpu/ops/statistics.py),
with NumPower's semantics as the JAX package keeps them:

- quantile and percentile sort and interpolate linearly (jnp.quantile's
  steps; torch.quantile refuses inputs of more than 2^24 elements, the sort
  has no such limit), NaN where a NaN is present;
- std and variance are population statistics (ddof = 0);
- average is the weighted mean.
"""

from __future__ import annotations

import torch

from numpower_tpu_torch.ops.creation import asarray, promoted
from numpower_tpu_torch.ops.reductions import normalized_axes, mean, sorted_quantile


def quantile(a, q, axis=None, keepdims: bool = False):
    """The q-th quantiles (q a scalar or 1-d) by linear interpolation
    between the sorted elements; with a 1-d q the quantiles lead the
    result's axes."""
    return sorted_quantile(a, q, axis=axis, keepdims=keepdims)


def percentile(a, q, axis=None, keepdims: bool = False):
    """The quantiles at q / 100, at the JAX package's positions: XLA folds
    jnp.percentile's q / 100 (n - 1) into q times one float32 constant, so
    percentile(a, 100) lies a hair below the maximum there, and here."""
    return sorted_quantile(a, q, axis=axis, keepdims=keepdims, scale=0.01)


def variance(a, axis=None, ddof: int = 0, keepdims: bool = False):
    """The population variance (ddof = 0), or with `ddof` degrees of freedom
    taken away; in two passes, as jnp.var: the mean, then the mean square of
    the deviations."""
    a = asarray(a)
    if not a.dtype.is_floating_point:
        a = a.to(torch.float32)
    dims = tuple(range(a.ndim)) if axis is None else normalized_axes(axis, a.ndim)
    count = 1
    for d in dims:
        count *= a.shape[d]
    centered = a - torch.mean(a, dim=dims, keepdim=True)
    return torch.sum(centered * centered, dim=dims, keepdim=keepdims) / float(count - ddof)


var = variance


def std(a, axis=None, ddof: int = 0, keepdims: bool = False):
    """The population standard deviation (ddof = 0)."""
    return torch.sqrt(variance(a, axis=axis, ddof=ddof, keepdims=keepdims))


def average(a, axis=None, weights=None):
    """The mean, or with `weights` (of `a`'s shape, or 1-d along `axis`)
    the weighted mean sum(a w) / sum(w)."""
    if weights is None:
        return mean(a, axis=axis)
    a, w = promoted(a, weights)
    if not a.dtype.is_floating_point:
        a, w = a.to(torch.float32), w.to(torch.float32)
    if axis is None:
        if a.shape != w.shape:
            raise ValueError("Axis must be specified when shapes of a and weights differ.")
        return torch.sum(a * w) / torch.sum(w)
    if a.shape != w.shape:
        if w.ndim != 1 or w.shape[0] != a.shape[axis]:
            raise ValueError("Length of weights not compatible with specified axis.")
        w = w.reshape([-1 if d == axis % a.ndim else 1 for d in range(a.ndim)])
        w = torch.broadcast_to(w, a.shape)
    return torch.sum(a * w, dim=axis) / torch.sum(w, dim=axis)

