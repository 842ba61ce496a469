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
  bound measures the cancellation; products (matmul, dot, einsum, ...) of
  order-one data take it too;
- CONVOLUTION: rtol 1e-5, atol 1e-5: a convolution's outputs, each a sum
  of 9 to a few hundred products of order-one data, in another order (K
  terms in float32 part by up to about K eps times the sum of their
  magnitudes, ~1e-6 at K = 27: past the reductions' atol);
- SOLVE: rtol 1e-5, atol 1e-5: what a solve, an inverse, a determinant, a
  least-squares or pseudo-inverse returns, on matrices of condition number
  at most ~100 (two LAPACK orders part by about cond(A) eps);
- FACTORIZATION: atol 1e-5 times max(1, max |A|), held by reconstruction
  (:func:`assert_reconstructs`: the port's factors multiplied back in
  float64) and invariants (orthonormal columns, triangles, the spectrum
  against the JAX one sorted), never factor by factor: eigenvector signs,
  eigenvalue order and the SVD's vectors differ between two correct
  implementations.
"""

import numpy as np
import torch

from numpower_tpu import ops as jops
from numpower_tpu_torch import ops as tops

EXACT = {"rtol": 0.0, "atol": 0.0}
TRANSCENDENTAL = {"rtol": 1e-6, "atol": 1e-7}
REDUCTION = {"rtol": 1e-6, "atol": 1e-6}
CONVOLUTION = {"rtol": 1e-5, "atol": 1e-5}
SOLVE = {"rtol": 1e-5, "atol": 1e-5}
FACTORIZATION = {"rtol": 0.0, "atol": 1e-5}


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


def assert_reconstructs(A, product, tol=FACTORIZATION, what=""):
    """`product` (the port's factors multiplied back, any array type) equals
    A within the FACTORIZATION class: |product - A| <= atol max(1, max |A|),
    in float64."""
    A = np.asarray(A, np.float64)
    got = product.double().cpu().numpy() if isinstance(product, torch.Tensor) else \
        np.asarray(product, np.float64)
    bound = tol["atol"] * max(1.0, float(np.abs(A).max(initial=0.0)))
    err = float(np.abs(got - A).max(initial=0.0))
    assert err <= bound, (what, err, bound)


def assert_orthonormal_columns(Q, tol=FACTORIZATION, what=""):
    """Q' Q = I within the FACTORIZATION class (float64)."""
    q = Q.double().cpu().numpy()
    eye = np.broadcast_to(np.eye(q.shape[-1]), q.shape[:-2] + (q.shape[-1],) * 2)
    assert_reconstructs(eye, np.swapaxes(q, -1, -2).conj() @ q, tol, what)


def port_default_device_cpu(monkeypatch):
    """Point the port's default device (``utils.device.default_device``, the
    card) at the CPU for one test, in every loaded module of the port that
    imported it, so that its NDArray and ops build on the CPU here without a
    device argument. Test-only: the port has no such switch."""
    import sys

    from numpower_tpu_torch.utils import device

    original = device.default_device

    def cpu():
        return torch.device("cpu")

    for name, module in list(sys.modules.items()):
        if name.split(".")[0] == "numpower_tpu_torch" and \
                getattr(module, "default_device", None) is original:
            monkeypatch.setattr(module, "default_device", cpu)
