"""utils/smallmat.py of numpower_tpu_torch against the JAX package's on the
same numpy inputs (CPU).

Both run the same unrolled recurrences in fp32, so the port is held to the
tolerances the JAX package holds its own functions to against LAPACK
(tests/test_smallmat.py): Cholesky and triangular solves 2e-5, the SPD solve
2e-4, the LU solves 3e-4, the unpivoted solve rtol 1e-3 / atol 1e-4. The
failure behaviours (NaN from the failing column on, NaN inputs spreading) must
match pattern for pattern.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.utils.smallmat as js  # noqa: E402
import numpower_tpu_torch.utils.smallmat as ts  # noqa: E402

NS = [1, 2, 3, 4, 12]
RHS = ["matrix", "vector"]


def _spd(rng, batch, n):
    A = rng.standard_normal((batch, n, n)).astype(np.float32)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n, dtype=np.float32)


def _general(rng, batch, n):
    return rng.standard_normal((batch, n, n)).astype(np.float32) + 2 * np.eye(n, dtype=np.float32)


def _rhs(rng, batch, n, kind):
    shape = (batch, n, 3) if kind == "matrix" else (batch, n)
    return rng.standard_normal(shape).astype(np.float32)


def _both(name, *arrays, **kw):
    """(JAX result, port result) of smallmat.<name> as numpy arrays."""
    want = getattr(js, name)(*(jnp.asarray(a) for a in arrays), **kw)
    got = getattr(ts, name)(*(torch.from_numpy(a) for a in arrays), **kw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("n", NS)
def test_cholesky_unrolled_matches_jax(n):
    M = _spd(np.random.default_rng(n), 6, n)
    want, got = _both("cholesky_unrolled", M)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert not np.triu(got, 1).any()


@pytest.mark.parametrize("kind", RHS)
@pytest.mark.parametrize("n", NS)
def test_psd_solve_unrolled_matches_jax(n, kind):
    rng = np.random.default_rng(10 + n)
    M, b = _spd(rng, 5, n), _rhs(rng, 5, n, kind)
    want, got = _both("psd_solve_unrolled", M, b)
    assert got.shape == b.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", RHS)
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("n", NS)
def test_tri_solve_unrolled_matches_jax(n, lower, kind):
    rng = np.random.default_rng(3 + n)
    L = np.tril(rng.standard_normal((4, n, n)).astype(np.float32)) + 2 * np.eye(n, dtype=np.float32)
    if not lower:
        L = np.swapaxes(L, -1, -2).copy()
    b = _rhs(rng, 4, n, kind)
    want, got = _both("tri_solve_unrolled", L, b, lower=lower)
    assert got.shape == b.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", RHS)
@pytest.mark.parametrize("n", NS)
def test_lu_solve_unrolled_matches_jax(n, kind):
    rng = np.random.default_rng(20 + n)
    M, b = _general(rng, 5, n), _rhs(rng, 5, n, kind)
    want, got = _both("lu_solve_unrolled", M, b)
    assert got.shape == b.shape
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("kind", RHS)
@pytest.mark.parametrize("n", NS)
def test_lu_solve_nopivot_matches_jax(n, kind):
    """On the algebra it is specified for: I + C J with C, J PSD."""
    rng = np.random.default_rng(40 + n)
    a, c = rng.standard_normal((2, 8, n, n))
    M = (np.eye(n) + 0.1 * (a @ np.swapaxes(a, -1, -2)) @ (c @ np.swapaxes(c, -1, -2)))
    M = M.astype(np.float32)
    want, got = _both("lu_solve_nopivot", M, _rhs(rng, 8, n, kind))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,kind", [(n, kind) for n in NS for kind in RHS]
                         # jnp.linalg.solve reads a batched (N, n) rhs as matrices
                         + [(17, "matrix")])
def test_solve_small_matches_jax(n, kind):
    """Every regime: adjugate (n <= 3, batched vector rhs included), unrolled
    LU (<= 16), the library solve beyond."""
    rng = np.random.default_rng(30 + n)
    M, b = _general(rng, 8, n), _rhs(rng, 8, n, kind)
    want, got = _both("solve_small", M, b)
    assert got.shape == b.shape
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, np.linalg.solve(M, b[..., None] if kind == "vector" else b)
                               .reshape(b.shape), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("name", ["cholesky_unrolled", "psd_solve_unrolled"])
def test_cholesky_paths_read_the_lower_triangle_only(name):
    rng = np.random.default_rng(5)
    M = _spd(rng, 6, 12)
    junk = M + np.triu(rng.standard_normal(M.shape).astype(np.float32), 1)
    args = (junk,) if name == "cholesky_unrolled" else (junk, _rhs(rng, 6, 12, "matrix"))
    want, got = _both(name, *args)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    clean = getattr(ts, name)(torch.from_numpy(M), *(torch.from_numpy(a) for a in args[1:]))
    assert torch.equal(torch.from_numpy(got), clean)


@pytest.mark.parametrize("name", ["cholesky_unrolled", "psd_solve_unrolled"])
def test_non_pd_is_nan_from_the_failing_column_on(name):
    M = np.tile(np.diag([1.0, -1.0, 2.0, 3.0]).astype(np.float32), (3, 1, 1))
    M[:, 2, 0] = M[:, 0, 2] = 0.5
    args = (M,) if name == "cholesky_unrolled" else (M, np.ones((3, 4, 2), np.float32))
    want, got = _both(name, *args)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if name == "cholesky_unrolled":
        assert np.isfinite(got[:, :, 0]).all() and np.isnan(got[:, 1:, 1]).all()
    else:
        assert np.isnan(got).any()


@pytest.mark.parametrize("name", ["cholesky_unrolled", "psd_solve_unrolled", "lu_solve_unrolled",
                                  "lu_solve_nopivot", "solve_small"])
def test_nan_input_propagates_like_jax(name):
    rng = np.random.default_rng(2)
    M = _spd(rng, 2, 12)
    M[:, 3, 2] = M[:, 2, 3] = np.nan
    args = (M,) if name == "cholesky_unrolled" else (M, _rhs(rng, 2, 12, "matrix"))
    want, got = _both(name, *args)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()
    if name.startswith("lu_solve_unrolled") or name == "solve_small":
        assert np.isnan(got).all()  # a NaN poisons the pivot argmax


@pytest.mark.parametrize("n", [4, 8, 12])
def test_lu_pivot_ties_and_zero_leading_pivots_match_jax(n):
    """Ties in every column (a Hadamard-like sign matrix) and a zero leading
    pivot at every step (a cyclic permutation): the masked argmax must take
    the first maximum, as jnp.argmax does."""
    H = np.array([[1.0]], np.float32)
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]]).astype(np.float32)
    H = H[:n, :n] + np.diag(np.linspace(0, 1e-3, n)).astype(np.float32)
    P = np.zeros((n, n), np.float32)
    P[np.arange(n), (np.arange(n) + 1) % n] = 1.0
    M = np.stack([H, P, np.eye(n, dtype=np.float32)])
    b = np.random.default_rng(n).standard_normal((3, n, 2)).astype(np.float32)
    want, got = _both("lu_solve_unrolled", M, b)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1:], np.linalg.solve(M[1:], b[1:]), atol=1e-6)
