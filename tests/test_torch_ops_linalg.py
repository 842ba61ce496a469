"""The port's linear algebra (numpower_tpu_torch.ops) against the JAX
package's (numpower_tpu.ops) on the same seeded inputs, on the CPU: the twin
of tests/test_linalg.py, each of the 27 names. Tolerances
(tests/torch_ops_twins.py):

- EXACT for integer products (float32 accumulation of small integers), the
  NaN pattern of a failed Cholesky, ranks, shapes and dtypes;
- REDUCTION (rtol 1e-6, atol 1e-6) for the float products (matmul, dot,
  inner, outer, trace, kron, einsum, matrix_power) and the norms;
- SOLVE (rtol 1e-5, atol 1e-5) for solves, inverses, determinants,
  Cholesky factors, singular values, eigenvalues, least squares and
  pseudo-inverses (the pseudo-inverse near rank loss relative to its
  largest entry);
- FACTORIZATION (1e-5 of max(1, max |A|)) for lu, qr, svd, eig, eigh: the
  port's factors multiplied back, their invariants (orthonormal columns,
  triangles, A v = lambda v) and the spectrum against JAX's sorted, never
  factor by factor.

Each trap has its own test: the NaN of a non-PD Cholesky, pinv's and
matrix_rank's default cuts near rank loss, the minimum-norm lstsq of wide
and rank-deficient systems, integer and N-d dot/matmul, a 1-d right-hand
side with `trans`, eig's real parts, and batched (N, 12, 12) stacks, the MPC
state size, at a small N.
"""

import numpy as np
import pytest
import torch
from torch_ops_twins import (
    EXACT, FACTORIZATION, REDUCTION, SOLVE, assert_orthonormal_columns, assert_reconstructs,
    assert_same, check, to_port,
)

from numpower_tpu import ops as jops
from numpower_tpu_torch import ops as tops

M = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
SPD = np.array([[4.0, 2.0], [2.0, 3.0]], np.float32)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _spd(seed, shape):
    """Symmetric positive definite stacks of condition number below ~10."""
    a = _normal(seed, shape)
    n = shape[-1]
    return (a @ np.swapaxes(a, -1, -2) / n + np.eye(n, dtype=np.float32)).astype(np.float32)


def _conditioned(seed, shape, singular_values):
    """A matrix U diag(s) V' with the given singular values (float32)."""
    rng = np.random.default_rng(seed)
    m, n = shape
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    S = np.zeros(shape)
    k = len(singular_values)
    S[:k, :k] = np.diag(singular_values)
    return (U @ S @ V.T).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- products -------------------------------------------------------------------

PRODUCT_SHAPES = [((2, 2), (2, 2)), ((2, 2), (2, 1)), ((5, 3, 4), (5, 4, 2)), ((4,), (4, 3)),
                  ((3, 4), (4,)), ((4,), (4,)), ((1, 3, 4), (5, 4, 2)), ((), (3, 3)),
                  ((3, 3), ())]


@pytest.mark.parametrize("shapes", PRODUCT_SHAPES)
def test_matmul(shapes):
    check("matmul", _normal(1, shapes[0]), _normal(2, shapes[1]), tol=REDUCTION)


def test_matmul_2x2_phpt():
    got = check("matmul", M, M, tol=REDUCTION)
    np.testing.assert_allclose(got.numpy(), M @ M, rtol=1e-6)


@pytest.mark.parametrize("dtypes", [("int32", "int32"), ("int32", "float32"), ("uint8", "int8"),
                                    ("float16", "float32"), ("bool", "int32")])
@pytest.mark.parametrize("name", ["matmul", "dot"])
def test_products_of_integers(name, dtypes):
    """Integers are multiplied as float32 and cast back to the promoted
    dtype, as the JAX ops' preferred element type does. EXACT."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 5, (3, 4)).astype(dtypes[0])
    b = rng.integers(0, 5, (4, 2)).astype(dtypes[1])
    check(name, a, b, tol=EXACT if dtypes[0] != "float16" else REDUCTION)


def test_matmul_integers_accumulate_in_float32():
    """2^24 + 1 plus 1 in float32 rounds to 2^24 in both packages."""
    got = check("matmul", np.array([[2 ** 24 + 1, 1]], np.int32), np.array([[1], [1]], np.int32))
    assert got.item() == 2 ** 24


@pytest.mark.parametrize("shapes", [((4,), (4,)), ((2, 2), (2, 2)), ((2, 2), (2,)), ((2,), (2, 3)),
                                    ((2, 3, 4), (4, 5)), ((2, 3, 4), (5, 4, 2)), ((2, 3, 4), (4,)),
                                    ((), (3, 3)), ((3,), ())])
def test_dot(shapes):
    """N-d operands contract a's last axis with b's second-to-last (a
    tensordot: (2, 3, 4) . (5, 4, 2) is (2, 3, 5, 2))."""
    check("dot", _normal(4, shapes[0]), _normal(5, shapes[1]), tol=REDUCTION)


def test_dot_of_nd_integers():
    rng = np.random.default_rng(6)
    got = check("dot", rng.integers(-3, 4, (2, 3, 4)).astype(np.int32),
                rng.integers(-3, 4, (5, 4, 2)).astype(np.int32))
    assert tuple(got.shape) == (2, 3, 5, 2) and got.dtype == torch.int32


@pytest.mark.parametrize("name", ["matmul", "dot"])
def test_contraction_mismatch_raises_type_error(name):
    for pkg, x in ((jops, M), (tops, torch.from_numpy(M))):
        with pytest.raises(TypeError):
            getattr(pkg, name)(x, np.ones((3, 3), np.float32))


@pytest.mark.parametrize("shapes", [((3,), (3,)), ((2, 3), (4, 3)), ((2, 3, 4), (4,)), ((), (3,))])
def test_inner(shapes):
    check("inner", _normal(7, shapes[0]), _normal(8, shapes[1]), tol=REDUCTION)


def test_inner_outer_of_integers():
    v = np.array([1, 2, 3], np.int32)
    w = np.array([4, 5, 6], np.int32)
    check("inner", v, w)
    check("inner", v.reshape(1, 3), np.stack([v, w]))
    check("outer", v, w.astype(np.float32))
    check("outer", v.reshape(3, 1), w)


@pytest.mark.parametrize("shapes", [((3,), (4,)), ((2, 3), (4,)), ((2,), ())])
def test_outer(shapes):
    check("outer", _normal(9, shapes[0]), _normal(10, shapes[1]), tol=REDUCTION)


@pytest.mark.parametrize("offset", [0, 1, -1, 3])
def test_trace(offset):
    check("trace", _normal(11, (4, 5)), offset, tol=REDUCTION)
    check("trace", _normal(12, (3, 4, 4)), offset, tol=REDUCTION)
    check("trace", np.arange(20, dtype=np.int32).reshape(4, 5), offset)
    check("trace", np.eye(4, dtype=bool), offset)


@pytest.mark.parametrize("shapes", [((2, 2), (2, 3)), ((2,), (3,)), ((2, 2), (3,)), ((2, 1, 2), (2, 3))])
def test_kron(shapes):
    check("kron", _normal(13, shapes[0]), _normal(14, shapes[1]), tol=REDUCTION)
    check("kron", np.ones(shapes[0], np.int32), np.arange(np.prod(shapes[1]), dtype=np.float32)
          .reshape(shapes[1]))


@pytest.mark.parametrize("spec,shapes", [("ij,jk->ik", ((3, 4), (4, 5))),
                                         ("bij,bjk->bik", ((2, 3, 4), (2, 4, 5))),
                                         ("ii->", ((4, 4),)), ("ij->ji", ((3, 4),)),
                                         ("i,i->", ((5,), (5,))), ("ij,kj->ikj", ((2, 3), (4, 3)))])
def test_einsum(spec, shapes):
    check("einsum", spec, *(_normal(15 + i, s) for i, s in enumerate(shapes)), tol=REDUCTION)


def test_einsum_of_integers_is_float32():
    got = check("einsum", "ij,jk->ik", np.ones((2, 3), np.int32), np.ones((3, 2), np.int32))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 10, -1, -2, -3])
def test_matrix_power(n):
    a = (_normal(20, (4, 4)) / 2 + np.eye(4, dtype=np.float32)).astype(np.float32)
    check("matrix_power", a, n, tol=SOLVE if n < 0 else REDUCTION)
    check("matrix_power", np.stack([a, a.T]), n, tol=SOLVE if n < 0 else REDUCTION)
    if n >= 0:
        check("matrix_power", np.array([[1, 1], [1, 0]], np.int32), n)


# -- Cholesky and solves ------------------------------------------------------------


def test_cholesky_phpt():
    check("cholesky", SPD, tol=SOLVE)
    got = check("cholesky", SPD, upper=True, tol=SOLVE)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(SPD).T, rtol=1e-5)


@pytest.mark.parametrize("upper", [False, True])
def test_cholesky_batched(upper):
    spd = _spd(3, (8, 5, 5))
    got = check("cholesky", spd, upper=upper, tol=SOLVE)
    L = got.mT if upper else got
    assert_reconstructs(spd, L @ L.mT)


@pytest.mark.parametrize("a", [
    [[1.0, 2.0], [2.0, 1.0]],
    [[4.0, 2.0, 0.0], [2.0, 3.0, 0.0], [0.0, 0.0, -1.0]],
    [[0.0, 0.0], [0.0, 1.0]],
], ids=["2x2", "third-pivot", "zero-pivot"])
@pytest.mark.parametrize("upper", [False, True])
def test_cholesky_not_positive_definite_is_nan(a, upper):
    """A trap: the JAX op gives NaN in the factor's triangle and zeros
    outside it; torch.linalg.cholesky raises. EXACT, NaN where NaN."""
    a = np.array(a, np.float32)
    got = check("cholesky", a, upper=upper)
    assert torch.isnan(got).any()
    with pytest.raises(RuntimeError):
        torch.linalg.cholesky(torch.from_numpy(a))


def test_cholesky_batch_with_one_failure():
    batch = np.stack([np.eye(2, dtype=np.float32), np.array([[1, 2], [2, 1]], np.float32), SPD])
    got = check("cholesky", batch, tol=SOLVE)
    assert not torch.isnan(got[0]).any() and torch.isnan(got[1, :, 0]).all()


def test_cholesky_symmetrizes():
    """Both packages factor (A + A') / 2."""
    check("cholesky", np.array([[4.0, 1.0], [0.0, 3.0]], np.float32), tol=SOLVE)


@pytest.mark.parametrize("b_shape", [(2,), (2, 1), (2, 3)])
def test_solve(b_shape):
    x = check("solve", M, _normal(21, b_shape), tol=SOLVE)
    assert tuple(x.shape) == b_shape


@pytest.mark.parametrize("b_shape", [(6, 5), (6, 5, 2), (5,)])
def test_solve_batched(b_shape):
    """b.ndim == a.ndim - 1 is a stack of vectors (b unsqueezed)."""
    check("solve", _spd(22, (6, 5, 5)), _normal(23, b_shape), tol=SOLVE)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("b_shape", [(4,), (4, 3), (2, 4), (2, 4, 3)], ids=str)
@pytest.mark.parametrize("unit", [False, True])
def test_solve_triangular(trans, lower, b_shape, unit):
    """A trap: a 1-d right-hand side and `trans` (torch's solve_triangular
    needs a 2-d b and has no trans: the port transposes a and flips lower)."""
    L = np.linalg.cholesky(_spd(24, (4, 4))).astype(np.float32)
    a = L if lower else L.T
    if len(b_shape) == 3 or b_shape == (2, 4):
        a = np.stack([a, 2 * a])
    a = a + np.triu(np.ones_like(a), 1) * 7 if lower else a  # the other triangle is never read
    check("solve_triangular", a, _normal(25, b_shape), lower=lower, trans=trans,
          unit_diagonal=unit, tol=SOLVE)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("b_shape", [(5,), (5, 2)])
def test_cho_solve(lower, b_shape):
    spd = _spd(26, (5, 5))
    L = np.linalg.cholesky(spd).astype(np.float32)
    x = check("cho_solve", L if lower else L.T, _normal(27, b_shape), lower=lower, tol=SOLVE)
    assert_reconstructs(_normal(27, b_shape), torch.from_numpy(spd) @ x, SOLVE)


def test_solve_triangular_and_cho_solve_phpt():
    L = np.linalg.cholesky(SPD).astype(np.float32)
    b = np.array([1.0, 2.0], np.float32)
    check("solve_triangular", L, b, lower=True, tol=SOLVE)
    check("cho_solve", L, b, tol=SOLVE)


@pytest.mark.parametrize("a", ["M", "batched", "int"])
def test_inv_det(a):
    x = {"M": M, "batched": _spd(28, (4, 3, 3)), "int": np.array([[2, 1], [1, 3]], np.int32)}[a]
    check("inv", x, tol=SOLVE)
    check("det", x, tol=SOLVE)


def test_inv_of_a_non_square_matrix_raises_value_error():
    for pkg, x in ((jops, np.ones((2, 3), np.float32)), (tops, torch.ones(2, 3))):
        with pytest.raises(ValueError):
            pkg.inv(x)


# -- factorizations -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (5, 5), (3, 5), (5, 3)])
def test_lu(shape):
    a = M if shape == (2, 2) else _normal(29, shape)
    want = jops.lu(a)
    P, L, U = tops.lu(to_port(a))
    for w, g in zip(want, (P, L, U)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    assert_reconstructs(a, P @ L @ U)
    k = min(shape)
    np.testing.assert_array_equal(torch.tril(L, -1).numpy() + np.eye(*L.shape), L.numpy())
    np.testing.assert_array_equal(torch.triu(U).numpy(), U.numpy())
    assert sorted(P.sum(0).tolist()) == [1.0] * shape[0] and L.shape[1] == k
    np.testing.assert_allclose(np.abs(np.diag(U.numpy())), np.abs(np.diag(np.asarray(want[2]))),
                               **SOLVE)


@pytest.mark.parametrize("mode", ["reduced", "complete", "r", "raw"])
@pytest.mark.parametrize("shape", [(2, 2), (5, 3), (3, 5), (2, 4, 3)])
def test_qr(mode, shape):
    a = M if shape == (2, 2) else _normal(30, shape)
    want = jops.qr(a, mode=mode)
    got = tops.qr(to_port(a), mode=mode)
    if mode == "r":
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, (w.shape, g.shape)
    if mode == "raw":
        h, tau = got
        k = min(shape[-2:])
        Q = torch.linalg.householder_product(h.mT[..., :, :k], tau)
        R = torch.triu(h.mT)[..., :k, :]
        assert_reconstructs(a, Q @ R)
        return
    R = got[-1]
    np.testing.assert_array_equal(torch.triu(R).numpy(), R.numpy())
    np.testing.assert_allclose(np.abs(np.diagonal(R.numpy(), 0, -2, -1)),
                               np.abs(np.diagonal(np.asarray(want[-1]), 0, -2, -1)), **SOLVE)
    if mode != "r":
        Q = got[0]
        assert_orthonormal_columns(Q)
        assert_reconstructs(a, Q @ R)


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("shape", [(2, 2), (5, 3), (3, 5), (3, 4, 4)])
def test_svd(full, shape):
    a = M if shape == (2, 2) else _normal(31, shape)
    want = jops.svd(a, full_matrices=full)
    U, S, Vt = tops.svd(to_port(a), full_matrices=full)
    for w, g in zip(want, (U, S, Vt)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    assert_same(want[1], S, SOLVE)
    k = S.shape[-1]
    assert_reconstructs(a, (U[..., :, :k] * S[..., None, :]) @ Vt[..., :k, :])
    assert_orthonormal_columns(U)
    assert_orthonormal_columns(Vt.mT)


@pytest.mark.parametrize("shape", [(2, 2), (5, 3), (3, 4, 4)])
def test_svdvals(shape):
    check("svdvals", M if shape == (2, 2) else _normal(32, shape), tol=SOLVE)


def _sorted_eig_check(a, w, v, want_w):
    """The eigenvalues against JAX's (both sorted), and A v = v diag(w)."""
    order = lambda x: np.sort_complex(np.asarray(x).astype(np.complex128))  # noqa: E731
    np.testing.assert_allclose(order(_np(w)), order(want_w), **SOLVE)
    av = np.asarray(a, np.complex128) @ _np(v).astype(np.complex128)
    assert_reconstructs(av.real, (_np(v).astype(np.complex128) * _np(w)[..., None, :]).real)
    assert_reconstructs(av.imag, (_np(v).astype(np.complex128) * _np(w)[..., None, :]).imag)


@pytest.mark.parametrize("a", ["SPD", "symmetric", "nonsymmetric"])
def test_eig(a):
    """eig keeps the real parts in the operand's dtype (NumPower discards the
    imaginary ones); on a real spectrum A v = lambda v holds. FACTORIZATION."""
    x = {"SPD": SPD, "symmetric": _normal(33, (4, 4)) + _normal(33, (4, 4)).T,
         "nonsymmetric": np.triu(_normal(34, (4, 4))) + np.diag([0.0, 1, 2, 3]).astype(np.float32)
         }[a].astype(np.float32)
    want_w, want_v = jops.eig(x)
    w, v = tops.eig(to_port(x))
    assert w.dtype == torch.float32 and tuple(v.shape) == want_v.shape
    _sorted_eig_check(x, w, v, want_w)


def test_eig_batched():
    sym = _normal(7, (4, 3, 3))
    sym = sym + np.swapaxes(sym, -1, -2)
    want_w, _ = jops.eig(sym)
    w, v = tops.eig(to_port(sym))
    for i in range(4):
        _sorted_eig_check(sym[i], w[i], v[i], np.asarray(want_w)[i])


def test_eig_keeps_real_parts_of_a_complex_spectrum():
    """A trap: a rotation's spectrum is +-i; eig gives its real parts (0),
    eig_complex the complex64 pair."""
    R = np.array([[0.0, -1.0], [1.0, 0.0]], np.float32)
    w, _ = tops.eig(to_port(R))
    assert_same(jops.eig(R)[0], w, SOLVE)
    wc, vc = tops.eig_complex(to_port(R))
    assert wc.dtype == torch.complex64 and vc.dtype == torch.complex64
    _sorted_eig_check(R, wc, vc, jops.eig_complex(R)[0])
    check("eigvals", R, tol=SOLVE)


def test_eig_of_integers_keeps_their_dtype():
    """eig's real parts take the operand's dtype: an int32 matrix gives
    int32 eigenvalues (3, 1) in both packages."""
    a = np.array([[2, 1], [1, 2]], np.int32)
    want_w, _ = jops.eig(a)
    w, _ = tops.eig(to_port(a))
    assert w.dtype == torch.int32
    assert sorted(w.tolist()) == sorted(np.asarray(want_w).tolist())


def test_eig_complex_stays_on_the_operands_device():
    """A deliberate difference: the JAX package puts eig_complex's results
    on its CPU device; the port leaves them on the operand's device (the
    card's test checks CUDA)."""
    x = to_port(_normal(35, (3, 3)))
    w, v = tops.eig_complex(x)
    assert w.device == x.device and v.device == x.device


@pytest.mark.parametrize("a", ["SPD", "batched", "nonsymmetric"])
def test_eigh(a):
    """Eigenvalues ascending against JAX's (SOLVE); V diag(w) V' = (A + A')/2
    (FACTORIZATION)."""
    x = {"SPD": SPD, "batched": _spd(36, (3, 5, 5)),
         "nonsymmetric": _normal(37, (4, 4))}[a]
    want_w, _ = jops.eigh(x)
    w, v = tops.eigh(to_port(x))
    assert_same(want_w, w, SOLVE)
    assert_reconstructs((x + np.swapaxes(x, -1, -2)) / 2, (v * w[..., None, :]) @ v.mT)
    assert_orthonormal_columns(v)


def test_eigvals():
    check("eigvals", SPD, tol=SOLVE)
    x = np.triu(_normal(38, (4, 4)))
    np.testing.assert_allclose(np.sort(tops.eigvals(to_port(x)).numpy()),
                               np.sort(np.asarray(jops.eigvals(x))), **SOLVE)


# -- norms, condition, rank, least squares, pseudo-inverse ----------------------------


@pytest.mark.parametrize("order", ["l1", "l2", None, 1, 2, -1, -2, np.inf, -np.inf, "fro", "nuc"])
def test_norm(order):
    """The vector-or-matrix rule: a vector takes a vector norm ("fro" and
    "nuc" raise ValueError there in both), a matrix a matrix norm."""
    check("norm", _normal(39, (4, 3)), order, tol=REDUCTION)
    check("norm", M, order, tol=REDUCTION)
    v = np.array([3.0, -4.0, 1.0], np.float32)
    if order in ("fro", "nuc"):
        for pkg, x in ((jops, v), (tops, to_port(v))):
            with pytest.raises(ValueError):
                pkg.norm(x, order)
    else:
        check("norm", v, order, tol=REDUCTION)


def test_norm_phpt_and_other_ranks():
    np.testing.assert_allclose(tops.norm(to_port(M), "l1").item(), np.linalg.norm(M, 1), rtol=1e-6)
    np.testing.assert_allclose(tops.norm(to_port(M), "l2").item(), np.linalg.norm(M, 2), rtol=1e-5)
    check("norm", np.array([3, 4], np.int32))
    for pkg, x in ((jops, np.ones((2, 2, 2), np.float32)), (tops, torch.ones(2, 2, 2))):
        with pytest.raises(ValueError):
            pkg.norm(x)


@pytest.mark.parametrize("p", [None, 2, -2, 1, -1, np.inf, "fro", "nuc"])
def test_cond(p):
    check("cond", M, p, tol=SOLVE)
    check("cond", _spd(40, (3, 4, 4)), p, tol=SOLVE)


def test_cond_of_a_singular_matrix_is_inf():
    s = np.array([[1.0, 2.0], [2.0, 4.0]], np.float32)
    for p in (2, 1):
        got = tops.cond(to_port(s), p)
        assert bool(torch.isinf(got)) or got.item() > 1e6
        want = float(jops.cond(s, p))
        assert np.isinf(want) or want > 1e6


@pytest.mark.parametrize("tol", [None, 1e-4, 1e-2])
def test_matrix_rank(tol):
    check("matrix_rank", M, tol)
    check("matrix_rank", np.ones((3, 3), np.float32), tol)
    check("matrix_rank", _normal(41, (3, 4, 4)), tol)
    check("matrix_rank", np.array([0.0, 2.0], np.float32), tol)


def test_matrix_rank_near_rank_loss():
    """A trap: the cut is max(M, N) eps times the largest singular value
    (an absolute tol where given): s = 1e-6 is rank at the default cut of a
    6 x 6 matrix (7.2e-7) and not at tol 1e-5. EXACT."""
    x = _conditioned(42, (6, 6), [1.0, 0.5, 0.25, 0.1, 1e-6, 1e-9])
    assert check("matrix_rank", x).item() == 5
    assert check("matrix_rank", x, 1e-5).item() == 4


def test_lstsq_phpt():
    a = np.array([[1.0, 1.0], [1.0, 2.0], [1.0, 3.0]], np.float32)
    b = np.array([6.0, 9.0, 12.0], np.float32)
    x = check("lstsq", a, b, tol=SOLVE)
    np.testing.assert_allclose(x.numpy(), np.linalg.lstsq(a, b, rcond=None)[0], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case", ["tall", "wide", "rank-deficient", "matrix-b", "square"])
def test_lstsq_minimum_norm(case):
    """A trap: the minimum-norm solution of wide and rank-deficient systems
    (JAX's SVD route; torch's CUDA driver "gels" assumes a full-rank tall
    a). SOLVE."""
    a = {"tall": _normal(43, (6, 3)), "wide": _normal(44, (3, 5)),
         "rank-deficient": _conditioned(45, (5, 4), [2.0, 1.0]),
         "matrix-b": _normal(46, (5, 3)), "square": _spd(47, (4, 4))}[case]
    b = _normal(48, (a.shape[0], 2) if case == "matrix-b" else (a.shape[0],))
    x = check("lstsq", a, b, tol=SOLVE)
    # the float64 minimum-norm solution, float32's rounding of a's zero
    # singular values cut as both packages cut them
    want64 = np.linalg.lstsq(a.astype(np.float64), b, rcond=1e-5)[0]
    np.testing.assert_allclose(x.numpy(), want64, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 2), (4, 3), (3, 5), (2, 4, 4)])
def test_pinv(shape):
    check("pinv", M if shape == (2, 2) else _normal(49, shape), tol=SOLVE)


def test_pinv_near_rank_loss():
    """A trap: JAX cuts singular values at 10 max(M, N) eps of the largest
    (7.2e-6 on a 6 x 6 matrix), torch's default at max(M, N) eps; with s
    down to 1e-6 the two pseudo-inverses differ by ~1e6, while the port's
    matches JAX's within SOLVE of its largest entry (1 / 0.1 = 10)."""
    x = _conditioned(50, (6, 6), [1.0, 0.5, 0.25, 0.1, 1e-6, 1e-7])
    want = np.asarray(jops.pinv(x))
    got = tops.pinv(to_port(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= SOLVE["atol"] * scale
    assert np.abs(torch.linalg.pinv(to_port(x)).numpy() - want).max() > 1e3


# -- batched stacks of 12 x 12, the MPC state size ------------------------------------


@pytest.mark.parametrize("name", ["cholesky", "inv", "det", "solve", "svdvals", "eigh", "matmul"])
def test_batched_12x12_stacks(name):
    """(N, 12, 12) stacks, the (4096, 12, 12) shape of the MPC state, at
    N = 32."""
    spd = _spd(51, (32, 12, 12))
    args = {"solve": (spd, _normal(52, (32, 12, 4))), "matmul": (spd, _normal(53, (32, 12, 12)))
            }.get(name, (spd,))
    tol = REDUCTION if name == "matmul" else SOLVE
    if name == "eigh":
        w, v = tops.eigh(to_port(spd))
        assert_same(jops.eigh(spd)[0], w, SOLVE)
        assert_reconstructs(spd, (v * w[..., None, :]) @ v.mT)
        return
    check(name, *args, tol=tol)


def test_every_linalg_name_is_ported():
    import numpower_tpu.ops.linalg as jl

    import numpower_tpu_torch.ops.linalg as tl

    names = {n for n in dir(jl) if not n.startswith("_") and callable(getattr(jl, n))
             and getattr(getattr(jl, n), "__module__", "") == jl.__name__}
    assert len(names) == 27
    assert all(callable(getattr(tl, n, None)) for n in names), sorted(
        n for n in names if not hasattr(tl, n))
