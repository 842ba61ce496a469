"""Shared steps of the op-surface twins (tests/test_torch_ops_*.py): one op of
numpower_tpu.ops and its counterpart in numpower_tpu_torch.ops run on the
same numpy inputs on the CPU, and their results compared in value, shape and
dtype.

Tolerance classes (each twin file names the class of every case):
- EXACT: creation, manipulation, logic and the IEEE-exact arithmetic
  (add ... divide, sqrt, floor, ...): equal values, NaN where NaN;
- TRANSCENDENTAL: rtol 1e-6, atol 1e-7 (torch's libm-style functions against
  XLA's CPU approximations);
- REDUCTION: rtol 1e-6 (another summation order), with atol 1e-6 for the
  sums of data of order one that cancel to near zero, where a relative
  bound measures the cancellation.
"""

import numpy as np
import torch

from numpower_tpu import ops as jops
from numpower_tpu_torch import ops as tops

EXACT = {"rtol": 0.0, "atol": 0.0}
TRANSCENDENTAL = {"rtol": 1e-6, "atol": 1e-7}
REDUCTION = {"rtol": 1e-6, "atol": 1e-6}


def to_port(x):
    """A numpy operand (array or scalar) as a CPU tensor of the dtype JAX
    gives it (the port's asarray rule); lists and tuples of arrays element
    by element; anything else (Python scalars, lists of numbers) as it is,
    to follow the tensor operands."""
    if isinstance(x, (np.ndarray, np.generic)):
        return tops.asarray(x, device="cpu")
    if isinstance(x, (list, tuple)) and any(isinstance(v, np.ndarray) for v in x):
        return type(x)(to_port(v) for v in x)
    return x


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def assert_same(want, got, tol=EXACT, what=""):
    """The JAX result `want` and the port's `got`: the same value, shape and
    dtype (Python bools and floats, lists of arrays, element by element)."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for w, g in zip(want, got):
            assert_same(w, g, tol, what)
        return
    if isinstance(want, (bool, float, int)):
        assert type(got) is type(want) and got == want, (what, want, got)
        return
    assert isinstance(got, torch.Tensor), (what, type(got))
    assert got.device.type == "cpu", what
    assert tuple(got.shape) == tuple(want.shape), (what, want.shape, got.shape)
    assert dtype_name(got) == dtype_name(want), (what, want.dtype, got.dtype)
    w = np.asarray(want.astype(np.float32) if dtype_name(want) == "bfloat16" else want)
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if tol is EXACT:
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, equal_nan=True, err_msg=what, **tol)


def check(name, *args, tol=EXACT, port_kwargs=None, **kwargs):
    """ops.<name>(*args, **kwargs) in both packages, the port's numpy
    operands as CPU tensors (and `port_kwargs` added, e.g. device="cpu"),
    compared by :func:`assert_same`; returns the port's result."""
    want = getattr(jops, name)(*args, **kwargs)
    got = getattr(tops, name)(*(to_port(a) for a in args),
                              **{k: to_port(v) for k, v in kwargs.items()}, **(port_kwargs or {}))
    assert_same(want, got, tol, f"{name}{args!r:.200}{kwargs!r:.100}")
    return got
