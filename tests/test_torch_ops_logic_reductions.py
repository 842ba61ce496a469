"""The port's logic, reduction and statistics ops (numpower_tpu_torch.ops)
against the JAX package's (numpower_tpu.ops) on the same seeded inputs, on
the CPU: the twin of tests/test_logic_reductions.py, each of the 14 logic,
14 reduction and 6 statistics names. Tolerances (tests/torch_ops_twins.py):
EXACT for the comparisons and masks, min/max, the arg-extrema, sort,
argsort, take, searchsorted, median and integer sums; REDUCTION (rtol 1e-6,
atol 1e-6) for the float sums, products, means, cumulative sums, quantiles,
variances and averages (another summation order; the atol for sums of data
of order one that cancel to near zero). Each trap has its own test: the
median of an even count, NaN in the extrema and arg-extrema, population
statistics, linear quantiles (also past torch.quantile's 2^24 elements),
int32 index results and cumulative sums, float32 masks.
"""

import numpy as np
import pytest
import torch
from torch_ops_twins import EXACT, REDUCTION, assert_same, check

from numpower_tpu import ops as jops
from numpower_tpu_torch import ops as tops


def _data(seed, shape=(5, 6, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


AXES = [None, 0, 1, -1, (0, 2), (0, 1, 2)]


@pytest.mark.parametrize("name", ["equal", "not_equal", "greater", "greater_equal", "less",
                                  "less_equal"])
def test_comparisons_are_float32_masks(name):
    a = np.round(_data(1, (6, 7)))
    b = np.round(_data(2, (6, 7)))
    got = check(name, a, b)
    assert got.dtype == torch.float32
    check(name, a, b[0])
    check(name, a, 0.0)
    check(name, np.arange(12, dtype=np.int32).reshape(3, 4), 5)
    check(name, np.array([np.nan, 1.0, np.inf], np.float32), np.array([np.nan, 1.0, 2.0],
                                                                        np.float32))


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("name", ["all", "any"])
def test_all_any(name, axis):
    x = (np.random.default_rng(3).uniform(size=(4, 5)) > 0.3).astype(np.float32)
    check(name, x, axis=axis)
    check(name, np.ones((3, 3), np.float32), axis=axis)
    check(name, np.zeros((3, 3), np.float32), axis=axis)


def test_allclose_array_equal():
    a = _data(4, (4, 4))
    for b in (a, a + 1e-9, a + 1e-4, a + 1.0, a.T.copy()):
        assert tops.allclose(torch.from_numpy(a), torch.from_numpy(b)) == jops.allclose(a, b)
        assert tops.array_equal(torch.from_numpy(a), torch.from_numpy(b)) == \
            jops.array_equal(a, b)
    assert tops.allclose(torch.from_numpy(a), a + 1e-3, rtol=1e-2) == \
        jops.allclose(a, a + 1e-3, rtol=1e-2)
    assert tops.array_equal(torch.from_numpy(a), a[:2]) == jops.array_equal(a, a[:2]) is False


@pytest.mark.parametrize("name", ["isnan", "isinf", "isfinite"])
def test_isnan_isinf_isfinite(name):
    check(name, np.array([np.nan, 1.0, np.inf, -np.inf, 0.0], np.float32))


def test_where():
    x = np.array([1.0, np.nan, 3.0, -4.0], np.float32)
    check("where", np.isnan(x).astype(np.float32), 0.0, x)
    check("where", x > 0, x, -x)
    check("where", _data(5, (3, 4)) > 0, _data(6, (3, 4)), _data(7, (4,)))
    check("where", np.array([1, 0, 2], np.int32), np.arange(3, dtype=np.int32), 7.5)


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("name", ["sum", "prod", "mean"])
def test_sum_prod_mean(name, axis, keepdims):
    check(name, _data(8), axis=axis, keepdims=keepdims, tol=REDUCTION)


@pytest.mark.parametrize("name", ["sum", "prod", "mean", "cumsum", "cumprod"])
@pytest.mark.parametrize("dtype", ["int32", "bool", "int8", "float16"])
def test_reduction_dtypes(name, dtype):
    """Integer sums and products (and cumulative ones) are int32 as in the
    JAX package (torch gives int64), bool counts as int32, a mean of
    integers is float32."""
    x = np.random.default_rng(9).integers(0, 3, (4, 5)).astype(dtype)
    check(name, x, tol=REDUCTION)
    check(name, x, axis=1, tol=REDUCTION)


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("name", ["min", "max", "median"])
def test_min_max_median(name, axis, keepdims):
    check(name, _data(10), axis=axis, keepdims=keepdims)


def test_median_of_an_even_count():
    """The mean of the two middle elements (2.5 for [1, 2, 3, 4]):
    torch.median gives the lower one (2.0)."""
    x = np.array([3.0, 1.0, 4.0, 2.0], np.float32)
    got = check("median", x)
    assert got.item() == 2.5
    assert torch.median(torch.from_numpy(x)).item() == 2.0
    check("median", _data(11, (6, 8)), axis=1)
    check("median", _data(12, (7, 5)), axis=0)
    check("median", np.array([5.0, np.nan, 1.0, 2.0], np.float32))


@pytest.mark.parametrize("name", ["argmin", "argmax"])
@pytest.mark.parametrize("axis,keepdims", [(None, False), (None, True), (0, False),
                                           (1, True), (-1, False)])
def test_argminmax(name, axis, keepdims):
    got = check(name, _data(13, (5, 6)), axis=axis, keepdims=keepdims)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("name", ["argmin", "argmax", "min", "max"])
def test_extrema_propagate_nan(name):
    """The first NaN wins, in the flat array and along an axis."""
    x = np.array([1.0, np.nan, 0.5, np.nan], np.float32)
    check(name, x)
    y = np.array([[1.0, 5.0, 2.0], [np.nan, 0.0, 3.0], [4.0, np.nan, np.nan]], np.float32)
    check(name, y, axis=1)
    check(name, y, axis=0)


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_cumulative(name, axis):
    check(name, _data(14, (4, 6)) * 0.5 + 1.0, axis=axis, tol=REDUCTION)


@pytest.mark.parametrize("axis", [-1, 0, None])
@pytest.mark.parametrize("name", ["sort", "argsort"])
def test_sort_argsort(name, axis):
    x = _data(15, (5, 7))
    x[1, 2] = np.nan
    x[3, :2] = 1.0  # ties: both sorts are stable
    got = check(name, x, axis=axis)
    if name == "argsort":
        assert got.dtype == torch.int32


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("name", ["sort", "argsort"])
def test_sort_argsort_of_0d_raise(name, axis):
    """A repaired fault: a 0-d operand has no axis to sort along, and both
    packages raise ValueError (the port once returned a value); with
    axis=None both sort its one element."""
    x = np.float32(1.5)
    with pytest.raises(ValueError, match="out of bounds"):
        getattr(jops, name)(x, axis=axis)
    with pytest.raises(ValueError, match="out of bounds"):
        getattr(tops, name)(torch.tensor(1.5), axis=axis)
    check(name, x, axis=None)


@pytest.mark.parametrize("name", ["equal", "not_equal", "greater", "greater_equal", "less",
                                  "less_equal"])
@pytest.mark.parametrize("shapes,error", [(((2, 3), (2, 4)), TypeError),
                                          (((2, 3), (4,)), ValueError)])
def test_comparison_of_shapes_that_do_not_broadcast_raises_jax_errors(name, shapes, error):
    """A repaired fault: TypeError for operands of one rank, ValueError for
    operands of two, in both packages (the port raised RuntimeError)."""
    for pkg, mk in ((jops, lambda s: np.ones(s, np.float32)), (tops, torch.ones)):
        with pytest.raises(error, match="ncompatible shapes for broadcasting"):
            getattr(pkg, name)(mk(shapes[0]), mk(shapes[1]))


def test_take():
    x = _data(16, (4, 5))
    check("take", x, [2, 0, 7])
    check("take", x, np.array([[1, 3], [0, 0]], np.int32), axis=1)
    check("take", x, [3, -1, -4], axis=0)
    check("take", x, [25, -30, 4])  # outside [-n, n): NaN, jnp.take's fill
    check("take", np.arange(6, dtype=np.int32), [0, 9, -7, 5])  # int: the most negative int
    big = np.arange(2 ** 24 + 5, dtype=np.int32)
    check("take", big, [2 ** 24 + 1, 2 ** 24 + 3, -1])  # list indices stay integers


def test_searchsorted():
    a = np.sort(_data(17, (20,)))
    v = _data(18, (3, 4))
    for side in ("left", "right"):
        got = check("searchsorted", a, v, side=side)
        assert got.dtype == torch.int32
        check("searchsorted", a, a[5], side=side)
        check("searchsorted", a, 0.0, side=side)


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("q", [0.5, 0.0, 1.0, 0.37, [0.1, 0.5, 0.9]])
def test_quantile_percentile(q, axis, keepdims):
    """Linear interpolation between the sorted elements; a percentile at the
    position XLA folds q / 100 (n - 1) into (so percentile 100 lies a hair
    below the maximum in both packages)."""
    x = _data(19)
    check("quantile", x, q, axis=axis, keepdims=keepdims, tol=REDUCTION)
    pct = [100 * v for v in q] if isinstance(q, list) else 100 * q
    check("percentile", x, pct, axis=axis, keepdims=keepdims, tol=REDUCTION)


def test_quantile_linear_interpolation():
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    assert check("quantile", x, 0.5).item() == 2.5
    check("quantile", x, 0.25, tol=REDUCTION)
    check("quantile", np.array([1.0, np.nan, 3.0], np.float32), 0.5)


def test_median_and_quantile_past_torch_quantiles_limit():
    """4097 x 4097 = 2^24 + 8193 elements: torch.quantile refuses the input
    ("input tensor is too large"); the port sorts, as XLA does."""
    x = np.random.default_rng(20).standard_normal((4097, 4097)).astype(np.float32)
    t = torch.from_numpy(x)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(t, 0.5)
    assert_same(jops.median(x), tops.median(t), EXACT, "median")
    assert_same(jops.quantile(x, 0.3), tops.quantile(t, 0.3), REDUCTION, "quantile")


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("name", ["std", "variance", "var"])
def test_population_statistics(name, axis, keepdims, ddof):
    """ddof = 0 by default: the population statistics."""
    check(name, _data(21) * 3 + 1, axis=axis, keepdims=keepdims, ddof=ddof, tol=REDUCTION)


def test_std_is_population_by_default():
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    got = check("std", x, tol=REDUCTION)
    np.testing.assert_allclose(got.item(), x.std(ddof=0), rtol=1e-6)
    check("var", np.arange(12, dtype=np.int32), tol=REDUCTION)


def test_average():
    x = _data(22, (4, 5))
    w = np.random.default_rng(23).uniform(0.1, 2.0, (4, 5)).astype(np.float32)
    check("average", x, tol=REDUCTION)
    check("average", x, axis=0, tol=REDUCTION)
    check("average", x, weights=w, tol=REDUCTION)
    check("average", x, axis=1, weights=w, tol=REDUCTION)
    check("average", x, axis=1, weights=w[0], tol=REDUCTION)
    check("average", x, axis=0, weights=w[:, 0], tol=REDUCTION)
