"""Comparison and logic ops (the port's counterpart of
numpower_tpu/ops/logic.py).

As in NumPower and the JAX package, a comparison gives a float32 mask of 0
and 1, not a bool tensor, so that arithmetic on masks behaves alike; NumPy
broadcasting throughout.
"""

from __future__ import annotations

import torch

from numpower_tpu_torch.ops.creation import as_operands, asarray, binary, dims, promoted
from numpower_tpu_torch.utils.config import default_dtype


def _mask(x: torch.Tensor) -> torch.Tensor:
    return x.to(default_dtype())


def equal(a, b):
    return _mask(binary(torch.eq, "eq", a, b))


def not_equal(a, b):
    return _mask(binary(torch.ne, "ne", a, b))


def greater(a, b):
    return _mask(binary(torch.gt, "gt", a, b))


def greater_equal(a, b):
    return _mask(binary(torch.ge, "ge", a, b))


def less(a, b):
    return _mask(binary(torch.lt, "lt", a, b))


def less_equal(a, b):
    return _mask(binary(torch.le, "le", a, b))


def all(a, axis=None):  # noqa: A001
    """NumPower's NDArray_All: are all elements nonzero (along `axis`)?"""
    nonzero = asarray(a) != 0
    return _mask(nonzero.all() if axis is None else torch.all(nonzero, dim=dims(axis)))


def any(a, axis=None):  # noqa: A001
    nonzero = asarray(a) != 0
    return _mask(nonzero.any() if axis is None else torch.any(nonzero, dim=dims(axis)))


def allclose(a, b, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """|a - b| <= atol + rtol |b| everywhere."""
    return bool(torch.allclose(*promoted(a, b), rtol=rtol, atol=atol))


def array_equal(a, b) -> bool:
    """Same shape and equal elements."""
    a, b = promoted(a, b)
    return a.shape == b.shape and bool(torch.eq(a, b).all())


def isnan(a):
    return _mask(torch.isnan(asarray(a)))


def isinf(a):
    return _mask(torch.isinf(asarray(a)))


def isfinite(a):
    return _mask(torch.isfinite(asarray(a)))


def where(cond, x, y):
    """x where cond is nonzero, else y."""
    cond, x, y = as_operands(cond, x, y)
    return torch.where(cond != 0, *promoted(x, y))
