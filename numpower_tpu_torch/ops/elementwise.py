"""Elementwise unary and binary math (the port's counterpart of
numpower_tpu/ops/elementwise.py): NumPower's scalar-math surface and its
binary arithmetic, each a torch call with NumPy broadcasting.

Where torch's function differs from the JAX one, the JAX semantics win:
``pow`` by an integer exponent in [-64, 64] is exact repeated multiplication
(lax.integer_pow's order of products), ``mod`` is C's fmodf (torch.fmod, not
remainder), ``rsqrt`` is 1 / sqrt, ``round`` rounds half away from zero,
``sign`` of NaN is NaN, and binary operands are promoted as concrete arrays
(``creation.promoted``); operands whose shapes do not broadcast raise the
JAX op's TypeError (``creation.binary``).
"""

from __future__ import annotations

import torch

from numpower_tpu_torch.ops.creation import asarray, binary, promoted
from numpower_tpu_torch.utils.config import default_dtype

# ----------------------------------------------------------------------------
# Binary arithmetic
# ----------------------------------------------------------------------------


def add(a, b):
    return binary(torch.add, "add", a, b)


def subtract(a, b):
    return binary(torch.subtract, "sub", a, b)


def multiply(a, b):
    return binary(torch.multiply, "mul", a, b)


def divide(a, b):
    """True division (an integer quotient is float32)."""
    return binary(torch.true_divide, "div", a, b)


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y by lax.integer_pow's products: square-and-multiply from the
    lowest bit, then one reciprocal for a negative y."""
    if y == 0:
        return torch.ones_like(x)
    reciprocal_ = y < 0
    y = -y if reciprocal_ else y
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    if not reciprocal_:
        return acc
    if acc.dtype.is_floating_point or acc.dtype.is_complex:
        return torch.ones_like(acc) / acc
    return torch.div(torch.ones_like(acc), acc, rounding_mode="trunc")


def pow(a, b):  # noqa: A001 - mirrors the NumPower name
    """a ** b. A Python-number exponent that is an integer in [-64, 64] is
    exact repeated multiplication; other exponents take torch.pow."""
    if _number(b):
        bf = float(b)
        if bf.is_integer() and -64 <= bf <= 64:
            return _integer_pow(asarray(a), int(bf))
    return binary(torch.pow, "pow", a, b)


power = pow


def mod(a, b):
    """C fmodf: truncated, with the dividend's sign (not Python's modulo).
    An integer divided by zero gives 0, as XLA's remainder does (torch
    raises on the CPU, and the card's integer division is undefined)."""
    return binary(_fmod, "rem", a, b)


def _fmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype.is_floating_point or a.dtype.is_complex:
        return torch.fmod(a, b)
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a), torch.fmod(a, torch.where(zero, 1, b)))


def maximum(a, b):
    """Pairwise maximum, NaN propagating."""
    return binary(torch.maximum, "max", a, b)


def minimum(a, b):
    return binary(torch.minimum, "min", a, b)


def arctan2(a, b):
    return binary(torch.atan2, "atan2", a, b)


# ----------------------------------------------------------------------------
# Unary math
# ----------------------------------------------------------------------------


def abs(a):  # noqa: A001
    return torch.abs(asarray(a))


absolute = abs


def sqrt(a):
    return torch.sqrt(asarray(a))


def rsqrt(a):
    """1 / sqrt(a), both correctly rounded."""
    return 1.0 / torch.sqrt(asarray(a))


def exp(a):
    return torch.exp(asarray(a))


def exp2(a):
    return torch.exp2(asarray(a))


def expm1(a):
    return torch.expm1(asarray(a))


def log(a):
    return torch.log(asarray(a))


def log2(a):
    return torch.log2(asarray(a))


def log10(a):
    return torch.log10(asarray(a))


def log1p(a):
    return torch.log1p(asarray(a))


def logb(a):
    """C logbf: the exponent of |a| as a float, -inf at 0."""
    a = asarray(a)
    return torch.where(a == 0, -torch.inf, torch.floor(torch.log2(torch.abs(a))))


def sin(a):
    return torch.sin(asarray(a))


def cos(a):
    return torch.cos(asarray(a))


def tan(a):
    return torch.tan(asarray(a))


def arcsin(a):
    return torch.asin(asarray(a))


def arccos(a):
    return torch.acos(asarray(a))


def arctan(a):
    return torch.atan(asarray(a))


def sinh(a):
    return torch.sinh(asarray(a))


def cosh(a):
    return torch.cosh(asarray(a))


def tanh(a):
    return torch.tanh(asarray(a))


def arcsinh(a):
    return torch.asinh(asarray(a))


def arccosh(a):
    return torch.acosh(asarray(a))


def arctanh(a):
    return torch.atanh(asarray(a))


def degrees(a):
    return torch.rad2deg(asarray(a))


def radians(a):
    return torch.deg2rad(asarray(a))


def rint(a):
    """C rintf: round half to even. An integer or bool operand gives float32,
    as jnp.rint does."""
    a = asarray(a)
    return torch.round(a if a.dtype.is_floating_point else a.to(default_dtype()))


def fix(a):
    """Round toward zero, as trunc."""
    return torch.trunc(asarray(a))


def floor(a):
    return torch.floor(asarray(a))


def ceil(a):
    return torch.ceil(asarray(a))


def trunc(a):
    return torch.trunc(asarray(a))


def round(a, decimals: int = 0):  # noqa: A001
    """C roundf to `decimals` places: scale, round half away from zero
    (torch.round rounds half to even), unscale; the JAX package's steps."""
    a = asarray(a)
    scale = torch.tensor(10.0 ** decimals, dtype=a.dtype, device=a.device)
    scaled = a * scale
    return torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5) / scale


def sinc(a):
    """Normalized sinc, sin(pi a) / (pi a)."""
    return torch.sinc(asarray(a))


def negative(a):
    return torch.negative(asarray(a))


def positive(a):
    return torch.positive(asarray(a))


def sign(a):
    """-1, 0 or 1, and NaN for NaN (torch.sign gives 0 there)."""
    a = asarray(a)
    return torch.where(torch.isnan(a), a, torch.sign(a))


def reciprocal(a):
    return torch.reciprocal(asarray(a))


def square(a):
    return torch.square(asarray(a))


def clip(a, a_min, a_max):
    """Clamp to [a_min, a_max] (NaN propagating). A Python-number bound is
    weakly typed, as in jnp.clip: it does not widen `a`'s dtype."""
    a = asarray(a)
    if a_min is not None:
        a = torch.clamp(a, min=a_min) if _number(a_min) else torch.maximum(*promoted(a, a_min))
    if a_max is not None:
        a = torch.clamp(a, max=a_max) if _number(a_max) else torch.minimum(*promoted(a, a_max))
    return a


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)
