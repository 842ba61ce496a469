"""The port's elementwise ops (numpower_tpu_torch.ops) against the JAX
package's (numpower_tpu.ops) on the same seeded inputs, on the CPU: the twin
of tests/test_elementwise.py, each of the 49 names. Tolerances
(tests/torch_ops_twins.py): EXACT for the IEEE-exact arithmetic (add ...
divide, sqrt, floor, the integer powers, ...); TRANSCENDENTAL (rtol 1e-6,
atol 1e-7) for exp, log, the trigonometric and hyperbolic functions, pow by
a float exponent and rsqrt (libm-style torch against XLA's CPU
approximations). Each trap of the port has its own test: round half away
from zero, sign of NaN, fmod, exact integer powers, rsqrt = 1 / sqrt, and
the JAX dtypes of mixed operands.
"""

import numpy as np
import pytest
import torch
from torch_ops_twins import EXACT, TRANSCENDENTAL, assert_same, check

from numpower_tpu import ops as jops
from numpower_tpu_torch import ops as tops

SHAPE = (6, 7)


def _data(seed, low=-3.0, high=3.0, shape=SHAPE):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(np.float32)


BINARY_EXACT = ["add", "subtract", "multiply", "divide", "maximum", "minimum", "mod"]


@pytest.mark.parametrize("name", BINARY_EXACT)
def test_binary_exact(name):
    a, b = _data(1), _data(2)
    b[np.abs(b) < 0.1] = 0.5
    check(name, a, b)
    check(name, a, b[0])  # row broadcast
    check(name, a, b[:, :1])  # column broadcast
    check(name, a, 2.5)  # Python scalar
    check(name, a, np.float32(-1.5))
    check(name, np.ones((2, 3, 4), np.float32), np.arange(4, dtype=np.float32) + 1)


@pytest.mark.parametrize("name", BINARY_EXACT)
@pytest.mark.parametrize("dtypes", [("int32", "int32"), ("int32", "float32"),
                                    ("float16", "float32"), ("uint8", "int8"),
                                    ("bool", "float32"), ("int32", "scalar")])
def test_binary_dtypes(name, dtypes):
    """Mixed operands take the JAX package's dtype: every operand, a Python
    scalar too, is a concrete array there (a Python scalar is float32)."""
    rng = np.random.default_rng(3)
    a = (rng.uniform(1, 9, SHAPE)).astype(dtypes[0])
    b = 3.0 if dtypes[1] == "scalar" else rng.uniform(1, 9, SHAPE).astype(dtypes[1])
    check(name, a, b)


def test_mod_is_fmod():
    """C fmodf: the result takes the dividend's sign (torch.remainder and
    Python's % take the divisor's)."""
    a = np.array([5.0, -5.0, 5.0, -5.0, 7.5, -0.0], np.float32)
    b = np.array([3.0, 3.0, -3.0, -3.0, 2.0, 1.0], np.float32)
    got = check("mod", a, b)
    np.testing.assert_array_equal(got.numpy(), np.fmod(a, b))
    assert not torch.equal(got, torch.remainder(torch.from_numpy(a), torch.from_numpy(b)))
    check("mod", _data(4), _data(5, 0.5, 2.0))


@pytest.mark.parametrize("exponent", [0, 1, 2, 3, 5, 7, 13, 64, -1, -2, -3, -64, 2.0, -5.0])
def test_pow_integer_exponent_is_exact(exponent):
    """An integer exponent in [-64, 64] is lax.integer_pow's exact
    square-and-multiply in both packages, bit for bit."""
    check("pow", _data(6, 0.5, 1.5), exponent)
    check("power", _data(7, -1.2, 1.2), exponent)
    check("pow", (np.arange(1, 7, dtype=np.int32)).reshape(2, 3), abs(exponent) % 9)


@pytest.mark.parametrize("b", [0.5, 2.5, -1.3, 65, "array"])
def test_pow_float_exponent(b):
    """Other exponents take the transcendental pow."""
    exponent = _data(8, -2.0, 2.0) if b == "array" else b
    check("pow", _data(9, 0.1, 3.0), exponent, tol=TRANSCENDENTAL)


UNARY_EXACT = {
    "abs": (-3, 3), "absolute": (-3, 3), "sqrt": (0, 9), "floor": (-3, 3), "ceil": (-3, 3),
    "trunc": (-3, 3), "fix": (-3, 3), "rint": (-3, 3), "negative": (-3, 3),
    "positive": (-3, 3), "sign": (-3, 3), "reciprocal": (0.1, 3), "square": (-3, 3),
    "logb": (0.01, 100), "round": (-3, 3), "degrees": (-3, 3), "radians": (-180, 180),
}
UNARY_TRANSCENDENTAL = {
    "exp": (-5, 5), "exp2": (-5, 5), "expm1": (-1, 1), "log": (0.01, 10), "log2": (0.01, 10),
    "log10": (0.01, 10), "log1p": (-0.5, 5), "sin": (-6, 6), "cos": (-6, 6), "tan": (-1.5, 1.5),
    "arcsin": (-1, 1), "arccos": (-1, 1), "arctan": (-5, 5), "sinh": (-3, 3), "cosh": (-3, 3),
    "tanh": (-3, 3), "arcsinh": (-5, 5), "arccosh": (1, 5), "arctanh": (-0.9, 0.9),
    "sinc": (-3, 3), "rsqrt": (0.01, 9),
}


@pytest.mark.parametrize("name", sorted(UNARY_EXACT))
def test_unary_exact(name):
    check(name, _data(10, *UNARY_EXACT[name]))
    check(name, np.float32(UNARY_EXACT[name][1] / 2))


@pytest.mark.parametrize("name", sorted(UNARY_TRANSCENDENTAL))
def test_unary_transcendental(name):
    check(name, _data(11, *UNARY_TRANSCENDENTAL[name]), tol=TRANSCENDENTAL)


@pytest.mark.parametrize("name", ["sqrt", "exp", "sin", "floor", "abs", "square", "sign"])
def test_unary_of_integers(name):
    """An integer operand keeps JAX's result dtype (float32 where the
    function is transcendental)."""
    check(name, np.arange(-4, 8, dtype=np.int32).reshape(3, 4) if name != "sqrt"
          else np.arange(12, dtype=np.int32), tol=TRANSCENDENTAL)


@pytest.mark.parametrize("dtype", ["int32", "uint8", "bool", "float16"])
def test_rint_of_integers_is_float(dtype):
    """A repaired fault: jnp.rint casts an integer or bool operand to
    float32 (the port once returned int32). EXACT, dtype included."""
    got = check("rint", np.array([1, 2, 0, 3], dtype))
    assert got.dtype == (torch.float16 if dtype == "float16" else torch.float32)


@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8"])
def test_integer_mod_by_zero_is_zero(dtype):
    """A repaired fault: an integer divided by zero gives 0, as XLA's
    remainder does (the port raised ZeroDivisionError on the CPU). EXACT."""
    a = np.array([7, 100, 0, 5], dtype) if dtype == "uint8" else np.array([7, -7, 0, 5], dtype)
    b = np.array([0, 0, 0, 3], dtype)
    got = check("mod", a, b)
    np.testing.assert_array_equal(got.numpy()[:3], 0)
    check("mod", a.reshape(2, 2), np.zeros(2, dtype))


@pytest.mark.parametrize("shapes,error", [(((2, 2), (3, 3)), TypeError),
                                          (((2, 3), (4,)), ValueError)])
@pytest.mark.parametrize("name", BINARY_EXACT + ["pow", "arctan2"])
def test_shapes_that_do_not_broadcast_raise_jax_errors(name, shapes, error):
    """A repaired fault: both packages raise TypeError for operands of one
    rank (JAX's "add got incompatible shapes for broadcasting") and
    ValueError for operands of two; the port raised torch's RuntimeError."""
    for pkg, mk in ((jops, lambda s: np.ones(s, np.float32)), (tops, torch.ones)):
        with pytest.raises(error, match="ncompatible shapes for broadcasting"):
            getattr(pkg, name)(mk(shapes[0]), mk(shapes[1]))


def test_arctan2():
    check("arctan2", _data(12), _data(13), tol=TRANSCENDENTAL)
    check("arctan2", _data(14), 1.0, tol=TRANSCENDENTAL)


def test_round_half_away_from_zero():
    """C roundf: half away from zero; torch.round rounds half to even."""
    x = np.array([2.5, -2.5, 0.5, -0.5, 1.5, -1.5, 1.4, -1.6, 0.0], np.float32)
    got = check("round", x)
    np.testing.assert_array_equal(got.numpy(), [3, -3, 1, -1, 2, -2, 1, -2, 0])
    assert torch.round(torch.tensor(2.5)).item() == 2.0
    for decimals in (1, 2, 3, -1):
        check("round", _data(15, -50, 50), decimals)
    check("round", np.arange(-5, 5, dtype=np.int32))


def test_sign_of_nan_is_nan():
    """jnp.sign(NaN) is NaN; torch.sign gives 0."""
    x = np.array([np.nan, -2.0, 0.0, -0.0, 3.0, np.inf, -np.inf], np.float32)
    got = check("sign", x)
    assert np.isnan(got[0].item())
    assert torch.sign(torch.tensor(float("nan"))).item() == 0.0


def test_rsqrt_is_one_over_sqrt():
    x = _data(16, 0.01, 100)
    got = check("rsqrt", x, tol=TRANSCENDENTAL)
    torch.testing.assert_close(got, 1.0 / torch.sqrt(torch.from_numpy(x)), rtol=0, atol=0)


def test_clip():
    x = _data(17)
    x[0, 0] = np.nan
    check("clip", x, -1.0, 1.0)
    check("clip", x, None, 0.5)
    check("clip", x, -0.5, None)
    check("clip", x, _data(18, -3, 0), _data(19, 0, 3))
    check("clip", x, 2.0, 1.0)  # a_min above a_max: a_max everywhere
    check("clip", np.arange(-5, 5, dtype=np.int32), 0, 3)


def test_nan_and_inf_propagate():
    x = np.array([np.nan, np.inf, -np.inf, 0.0, 1.0], np.float32)
    for name in ("add", "multiply", "maximum", "minimum"):
        check(name, x, x[::-1].copy())
    for name in ("floor", "abs", "square", "negative"):
        check(name, x)
    for name in ("exp", "log", "tanh"):
        check(name, x, tol=TRANSCENDENTAL)


def test_numpy_operands_follow_the_tensor():
    """A numpy operand or Python scalar goes to the tensor operand's device
    (the CPU here)."""
    t = torch.from_numpy(_data(20))
    got = tops.add(_data(21), t)
    assert got.device.type == "cpu"
    assert_same(jops.add(_data(21), _data(20)), got, EXACT)
