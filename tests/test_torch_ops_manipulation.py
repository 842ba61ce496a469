"""The port's shape and layout ops (numpower_tpu_torch.ops) against the JAX
package's (numpower_tpu.ops) on the same seeded inputs, on the CPU: the twin
of tests/test_manipulation.py, each of the 27 names. Tolerance: exact
(values, shapes and dtypes equal).
"""

import numpy as np
import pytest
import torch
from torch_ops_twins import check

from numpower_tpu import ops as jops
from numpower_tpu_torch import ops as tops

A = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(np.float32)
M = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
V = np.random.default_rng(2).standard_normal(4).astype(np.float32)


@pytest.mark.parametrize("axes", [None, (2, 0, 1), (0, 2, 1)])
def test_transpose(axes):
    check("transpose", A, axes)
    check("transpose", M)


@pytest.mark.parametrize("x", [np.float32(2.5), np.array(7, np.int32)])
def test_transpose_of_0d(x):
    """A repaired fault: a 0-d operand is its own transpose (the port raised
    TypeError from permute). EXACT."""
    check("transpose", x)
    check("transpose", x, ())


@pytest.mark.parametrize("shape", [(3, 3), (5,), (2, 3, 5)])
def test_reshape_to_another_size_raises_type_error(shape):
    """A repaired fault: TypeError in both packages (the port raised
    RuntimeError)."""
    for pkg, a in ((jops, A), (tops, torch.from_numpy(A))):
        with pytest.raises(TypeError, match="cannot reshape"):
            pkg.reshape(a, shape)


@pytest.mark.parametrize("shape", [(6, 4), -1, (4, -1), [2, 12], (24,)])
def test_reshape(shape):
    check("reshape", A, shape)


@pytest.mark.parametrize("name", ["flatten", "ravel"])
def test_flatten(name):
    check(name, A)
    check(name, np.float32(3.0))


@pytest.mark.parametrize("axis", [None, 0, 1, -1, (0, 2)])
def test_flip(axis):
    check("flip", A, axis)


@pytest.mark.parametrize("axis", [0, 1, -1, (0, 2), (0, -1)])
def test_expand_dims(axis):
    check("expand_dims", M, axis)


def test_squeeze():
    x = A.reshape(2, 1, 3, 1, 4)
    check("squeeze", x)
    check("squeeze", x, 1)
    check("squeeze", x, (1, 3))
    check("squeeze", x, -2)
    for ops, arg in ((jops, x), (tops, torch.from_numpy(x))):
        with pytest.raises(ValueError):
            ops.squeeze(arg, 0)


@pytest.mark.parametrize("a1,a2", [(0, 2), (1, -1), (2, 2)])
def test_swapaxes(a1, a2):
    check("swapaxes", A, a1, a2)


@pytest.mark.parametrize("axis,start", [(2, 0), (0, 3), (1, 0), (-1, 1), (0, -1), (2, 3)])
def test_rollaxis(axis, start):
    check("rollaxis", A, axis, start)


@pytest.mark.parametrize("src,dst", [(0, -1), (-1, 0), ((0, 1), (2, 0)), (1, 1)])
def test_moveaxis(src, dst):
    check("moveaxis", A, src, dst)


@pytest.mark.parametrize("axis", [0, 1, None, -1])
def test_concatenate(axis):
    check("concatenate", [M, M * 2, M + 1], axis=axis)
    check("concatenate", [M, np.arange(15, dtype=np.int32).reshape(3, 5)], axis=axis)


def test_append():
    check("append", V, [3.0])
    check("append", M, M, axis=0)
    check("append", M, M[:, :2], axis=1)
    check("append", A, M)


@pytest.mark.parametrize("name", ["vstack", "hstack", "dstack", "column_stack"])
def test_stacks(name):
    check(name, [M, M * 2])
    check(name, [V, V + 1])
    check(name, [M[:, :1], M[:, 1:3]] if name in ("hstack", "column_stack") else [M, M])


@pytest.mark.parametrize("axis", [0, 1, -1, 2])
def test_stack(axis):
    check("stack", [M, M * 2, M - 1], axis=axis)
    check("stack", [M, np.ones((3, 5), np.int32)], axis=axis)


@pytest.mark.parametrize("name", ["atleast_1d", "atleast_2d", "atleast_3d"])
def test_atleast(name):
    for x in (np.float32(5.0), V, M, A):
        check(name, x)


def test_split():
    check("split", A, 2)
    check("split", A, 3, axis=1)
    check("split", A, [1, 3], axis=2)
    check("split", M, [2, 4], axis=1)
    for ops, arg in ((jops, A), (tops, torch.from_numpy(A))):
        with pytest.raises(ValueError):
            ops.split(arg, 3, axis=2)  # not an equal division
        with pytest.raises(ValueError):
            ops.split(arg, [2, 9], axis=2)  # a cut past the axis
        with pytest.raises(ValueError):
            ops.split(arg, [3, 1], axis=2)  # cuts out of order
        with pytest.raises(ValueError):
            ops.split(arg, [-3, 3], axis=2)  # a negative cut


@pytest.mark.parametrize("reps", [2, (2, 1), (1, 2, 3), (2, 1, 1, 2)])
def test_tile(reps):
    check("tile", M, reps)
    check("tile", V, reps)


def test_repeat():
    check("repeat", V, 2)
    check("repeat", M, 3, axis=1)
    check("repeat", M, np.array([1, 0, 2], np.int32), axis=0)
    check("repeat", M, 2)


@pytest.mark.parametrize("shift,axis", [(1, None), (-2, None), (2, 0), (-1, 1), ((1, 2), (0, 2))])
def test_roll(shift, axis):
    check("roll", A, shift, axis)


def test_broadcast_to_and_is_broadcastable():
    check("broadcast_to", V, (3, 4))
    check("broadcast_to", M[:, :1], (2, 3, 5))
    for a, b in ((np.ones((2, 3)), np.ones((3,))), (np.ones((2, 3)), np.ones((4,))),
                 (np.ones((5, 1, 4)), np.ones((3, 1))), (np.ones(3), np.ones((2, 2)))):
        got = tops.is_broadcastable(torch.from_numpy(a), torch.from_numpy(b))
        assert got is jops.is_broadcastable(a, b)


@pytest.mark.parametrize("specs", [
    ([2, 7],), ([2, 9, 2],), ([-3],), ([],), (slice(None, None, -1),), ([None, None, -2],),
    ([8, 1, -3],), (3,), (-1,),
], ids=str)
def test_slice_1d(specs):
    check("slice", np.arange(10, dtype=np.float32), *specs)


@pytest.mark.parametrize("specs", [
    ([0, 2], [1, 3]), (1,), (1, [None, None, -1]), ([None, None, -1], 2),
    ([None, None, -2], [4, 0, -2]), (slice(1, None), -1), ([0, 3, 2], [1, 4]),
], ids=str)
def test_slice_2d(specs):
    check("slice", np.arange(20, dtype=np.float32).reshape(4, 5), *specs)


def test_slice_index_out_of_bounds_raises_in_the_port():
    """A deliberate difference (ROADMAP queue 3): an int index past the axis
    raises IndexError in the port (torch indexing; NumPower raises too),
    where the JAX op clamps it to the last row."""
    np.testing.assert_array_equal(np.asarray(jops.slice(M, 7)), M[-1])
    with pytest.raises(IndexError):
        tops.slice(torch.from_numpy(M), 7)
