"""Dense linear algebra (the port's counterpart of numpower_tpu/ops/linalg.py).

Each op is a torch.linalg call on the operand's device, batched over leading
axes, with the JAX function's semantics where torch's differ:

- products (``matmul``, ``dot``, ``einsum``) accumulate in float32 and cast
  back to the operands' promoted dtype, as the JAX ops' preferred float32
  element type does: integer operands are multiplied as float32 (the card's
  matmul has no integer kernel), and ``dot`` of N-d operands contracts a's
  last axis with b's second-to-last (a tensordot, not matmul's broadcast);
- the factorizations promote integer operands to float32, and ``cholesky``
  and ``eigh`` symmetrize their input first, as ``jnp.linalg`` does;
- ``cholesky`` of a matrix that is not positive definite gives NaN in its
  triangle (the JAX/XLA pattern) instead of raising;
- ``pinv``, ``matrix_rank`` and ``lstsq`` cut small singular values at the
  JAX defaults (``pinv``: 10 max(M, N) eps of the largest; ``lstsq``:
  max(M, N) eps, the minimum-norm solution through the SVD on every device);
- ``eig`` runs ``torch.linalg.eig`` in float64 on the operand's device (the
  JAX package runs numpy's double-precision geev on the host) and keeps the
  real parts in the operand's dtype; ``eig_complex`` gives complex64 on the
  operand's device (the JAX package puts its results on its CPU device).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from numpower_tpu_torch.ops.creation import accumulation_dtype, as_operands, asarray
from numpower_tpu_torch.utils.config import default_dtype


def _promoted_dtype(*ts) -> torch.dtype:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _inexact(*xs) -> tuple:
    """The operands as tensors of one floating dtype (integers and bools as
    float32), as jnp.linalg promotes them."""
    ts = as_operands(*xs)
    dt = _promoted_dtype(*ts)
    if not (dt.is_floating_point or dt.is_complex):
        dt = default_dtype()
    return tuple(t.to(dt) for t in ts)


def _square(a: torch.Tensor, name: str) -> None:
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"Argument to {name} must have shape [..., n, n], got {tuple(a.shape)}.")


def _symmetrized(a: torch.Tensor) -> torch.Tensor:
    return (a + a.mT.conj()) / 2


def _svd_driver(a: torch.Tensor):
    """cuSOLVER's gesvd (QR iteration) on the card: torch's default there
    (Jacobi, gesvdj) stops at a tolerance that left singular values 1.8e-4
    of the largest off at order 1024 on an H100, against 4e-6 for the CPU's
    LAPACK and the JAX package; None (torch's choice) on the CPU."""
    return "gesvd" if a.is_cuda else None


def _svd(a: torch.Tensor, full_matrices: bool = False):
    return torch.linalg.svd(a, full_matrices=full_matrices, driver=_svd_driver(a))


def _svdvals(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svdvals(a, driver=_svd_driver(a))


def _product(fn, *ts) -> torch.Tensor:
    """fn on the operands cast to the accumulation dtype, cast back to their
    promoted dtype."""
    dt = _promoted_dtype(*ts)
    acc = accumulation_dtype(dt)
    return fn(*(t.to(acc) for t in ts)).to(dt)


def matmul(a, b) -> torch.Tensor:
    """NumPower's NDArray_Matmul, batched with NumPy's broadcasting; a 0-d
    operand multiplies."""
    a, b = as_operands(a, b)
    if a.ndim == 0 or b.ndim == 0:
        dt = _promoted_dtype(a, b)
        return a.to(dt) * b.to(dt)
    k_b = b.shape[-2] if b.ndim > 1 else b.shape[0]
    if a.shape[-1] != k_b:
        raise TypeError(f"matmul: contracting dimensions differ: {tuple(a.shape)} and "
                        f"{tuple(b.shape)}")
    return _product(torch.matmul, a, b)


def dot(a, b) -> torch.Tensor:
    """NumPower's NDArray_Dot generalized to NumPy's dot: a product by a 0-d
    operand, the inner product of two vectors, else a's last axis contracted
    with b's second-to-last (b's only axis where it is a vector)."""
    a, b = as_operands(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return _product(torch.multiply, a, b)
    k_b = b.shape[-2] if b.ndim > 1 else b.shape[0]
    if a.shape[-1] != k_b:
        raise TypeError(f"dot: contracting dimensions differ: {tuple(a.shape)} and "
                        f"{tuple(b.shape)}")
    dims = ([a.ndim - 1], [max(b.ndim - 2, 0)])
    return _product(lambda x, y: torch.tensordot(x, y, dims=dims), a, b)


def inner(a, b) -> torch.Tensor:
    """The sum of products over the last axes (a product where one is 0-d),
    in the promoted dtype (integers exactly, wrapping as int32 does)."""
    a, b = as_operands(a, b)
    dt = _promoted_dtype(a, b)
    a, b = a.to(dt), b.to(dt)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if dt.is_floating_point or dt.is_complex:
        return torch.inner(a, b)
    prods = a.reshape(a.shape[:-1] + (1,) * (b.ndim - 1) + a.shape[-1:]) * b
    return prods.sum(-1).to(dt)


def outer(a, b) -> torch.Tensor:
    """The outer product of the flattened operands."""
    a, b = as_operands(a, b)
    dt = _promoted_dtype(a, b)
    return a.reshape(-1, 1).to(dt) * b.reshape(1, -1).to(dt)


def trace(a, offset: int = 0) -> torch.Tensor:
    """The sum of the offset diagonal of the last two axes (integers and
    bools summed as int32)."""
    a = asarray(a)
    d = torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)
    if not (a.dtype.is_floating_point or a.dtype.is_complex):
        return d.sum(-1).to(torch.int32)
    return d.sum(-1)


def cholesky(a, upper: bool = False) -> torch.Tensor:
    """The lower Cholesky factor L (A = L L'), or U = L' where `upper`, of
    the symmetrized operand. A matrix that is not positive definite gives
    NaN in the factor's triangle and zeros outside it, as the JAX op does
    (torch.linalg.cholesky raises)."""
    (a,) = _inexact(a)
    _square(a, "cholesky")
    L, info = torch.linalg.cholesky_ex(_symmetrized(a))
    failed = (info != 0)[..., None, None]
    L = torch.where(failed, torch.tril(torch.full_like(L, float("nan"))), L)
    return L.mT.conj() if upper else L


def solve(a, b) -> torch.Tensor:
    """x with a x = b (an LU solve); b is a vector, or a stack of them,
    where b.ndim == a.ndim - 1. A singular a gives inf or NaN, as in the JAX
    op (torch.linalg.solve raises)."""
    a, b = _inexact(a, b)
    if a.ndim < 2:
        raise ValueError(f"left hand array must be at least two dimensional; got {tuple(a.shape)}")
    vector = b.ndim == a.ndim - 1
    x = torch.linalg.solve_ex(a, b[..., None] if vector else b)[0]
    return x[..., 0] if vector else x


def solve_triangular(a, b, lower: bool = True, trans: bool = False,
                     unit_diagonal: bool = False) -> torch.Tensor:
    """x with a x = b (a' x = b where `trans`) for a triangular a; b is a
    vector where b.ndim == a.ndim - 1."""
    a, b = _inexact(a, b)
    vector = a.ndim == b.ndim + 1
    if vector:
        b = b[..., None]
    if trans:
        a, lower = a.mT, not lower
    x = torch.linalg.solve_triangular(a, b, upper=not lower, unitriangular=unit_diagonal)
    return x[..., 0] if vector else x


def cho_solve(L, b, lower: bool = True) -> torch.Tensor:
    """x with A x = b, given A's Cholesky factor (lower: A = L L'; else
    A = U' U): two triangular solves, as jax.scipy.linalg.cho_solve."""
    L, b = _inexact(L, b)
    vector = L.ndim == b.ndim + 1
    if vector:
        b = b[..., None]
    if lower:
        y = torch.linalg.solve_triangular(L, b, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    else:
        y = torch.linalg.solve_triangular(L.mT, b, upper=False)
        x = torch.linalg.solve_triangular(L, y, upper=True)
    return x[..., 0] if vector else x


def inv(a) -> torch.Tensor:
    """The inverse (LU); a singular matrix gives inf or NaN, as in the JAX
    op (torch.linalg.inv raises)."""
    (a,) = _inexact(a)
    _square(a, "inv")
    return torch.linalg.inv_ex(a)[0]


def det(a) -> torch.Tensor:
    (a,) = _inexact(a)
    _square(a, "det")
    return torch.linalg.det(a)


def lu(a) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, L, U) with a = P L U, partial pivoting, L unit lower triangular
    (jax.scipy.linalg.lu's convention)."""
    (a,) = _inexact(a)
    P, L, U = torch.linalg.lu(a)
    return P, L, U


def qr(a, mode: str = "reduced"):
    """(Q, R) with a = Q R. Modes as jnp.linalg.qr: "reduced" (K = min(M, N)
    columns of Q), "complete" (M), "r" (R alone) and "raw" (geqrf's
    Householder vectors, transposed, and their scales)."""
    (a,) = _inexact(a)
    if mode == "raw":
        h, tau = torch.geqrf(a)
        return h.mT, tau
    if mode in ("reduced", "r", "full"):
        Q, R = torch.linalg.qr(a, mode="reduced")
    elif mode == "complete":
        Q, R = torch.linalg.qr(a, mode="complete")
    else:
        raise ValueError(f"Unsupported QR decomposition mode '{mode}'")
    return R if mode == "r" else (Q, R)


def svd(a, full_matrices: bool = True):
    """(U, S, Vt) with a = U diag(S) Vt, S descending."""
    (a,) = _inexact(a)
    return _svd(a, full_matrices)


def svdvals(a) -> torch.Tensor:
    (a,) = _inexact(a)
    return _svdvals(a)


def eig_complex(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """The complex eigenvalues w and eigenvectors v (columns) of a general
    matrix, complex64, on the operand's device; computed in double
    precision, as the JAX package's host geev."""
    a = asarray(a)
    _square(a, "eig")
    w, v = torch.linalg.eig(a.to(torch.complex128 if a.is_complex() else torch.float64))
    return w.to(torch.complex64), v.to(torch.complex64)


def eig(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """NumPower's NDArray_Eig: eig_complex's real parts in the operand's
    dtype (NumPower discards the imaginary parts)."""
    a = asarray(a)
    w, v = eig_complex(a)
    return w.real.to(a.dtype), v.real.to(a.dtype)


def eigh(a):
    """The eigenvalues (ascending) and eigenvectors of the symmetrized
    operand."""
    (a,) = _inexact(a)
    _square(a, "eigh")
    return torch.linalg.eigh(_symmetrized(a))


def eigvals(a) -> torch.Tensor:
    return eig(a)[0]


def _vector_norm(x: torch.Tensor, order) -> torch.Tensor:
    if isinstance(order, str):
        raise ValueError(f"Invalid order '{order}' for vector norm.")
    return torch.linalg.vector_norm(x, ord=order)


def _matrix_norm(x: torch.Tensor, order) -> torch.Tensor:
    if order not in ("fro", "f", "nuc", 1, -1, 2, -2, float("inf"), float("-inf")):
        raise ValueError(f"Invalid order '{order}' for matrix norm.")
    if order in (2, -2, "nuc"):
        s = _svdvals(x)
        return s[..., 0] if order == 2 else s[..., -1] if order == -2 else s.sum(-1)
    return torch.linalg.matrix_norm(x, ord="fro" if order == "f" else order)


def norm(a, order="l2") -> torch.Tensor:
    """NumPower's NDArray_Norm: "l1" is the largest absolute column sum of a
    matrix (a vector's absolute sum), "l2" the largest singular value of a
    matrix (a vector's Euclidean norm); NumPy's orders otherwise ("fro",
    "nuc", inf, integers). A vector takes a vector norm, a matrix a matrix
    norm, any other rank raises ValueError."""
    (a,) = _inexact(a)
    if order in ("l1", 1):
        order = 1
    elif order in ("l2", 2, None):
        order = 2
    if a.ndim == 1:
        return _vector_norm(a, order)
    if a.ndim == 2:
        return _matrix_norm(a, order)
    raise ValueError(f"Improper number of axes for norm: axis={tuple(range(a.ndim))}. Pass "
                     "one axis to compute a vector-norm, or two axes to compute a matrix-norm.")


def cond(a, p=2) -> torch.Tensor:
    """NumPower's NDArray_Cond: the ratio of the extreme singular values for
    p in (None, 2, -2), else ||a|| ||a^-1|| in the p-norm (NaN of a matrix
    without NaN read as inf), as jnp.linalg.cond."""
    (a,) = _inexact(a)
    if a.ndim < 2:
        raise ValueError(f"cond: input array must be at least 2D; got {tuple(a.shape)}")
    if p is None or p == 2:
        s = _svdvals(a)
        return s[..., 0] / s[..., -1]
    if p == -2:
        s = _svdvals(a)
        r = s[..., -1] / s[..., 0]
    else:
        _square(a, "cond")
        r = _matrix_norm(a, p) * _matrix_norm(inv(a), p)
    no_nan = ~torch.isnan(a).flatten(-2).any(-1)
    return torch.where(torch.isnan(r) & no_nan, torch.inf, r)


def matrix_rank(a, tol: Optional[float] = None) -> torch.Tensor:
    """The number of singular values above `tol` (an absolute cut, as in
    jnp.linalg.matrix_rank), by default the largest one times max(M, N)
    times float32's eps; int32. A vector's rank is 1 unless it is zero."""
    (a,) = _inexact(a)
    if a.ndim < 2:
        return (a != 0).any().to(torch.int32)
    s = _svdvals(a)
    eps = torch.finfo(s.dtype).eps
    cut = s.amax(-1) * max(a.shape[-2:]) * eps if tol is None else torch.as_tensor(
        tol, dtype=s.dtype, device=s.device)
    return (s > cut[..., None]).sum(-1).to(torch.int32)


def lstsq(a, b) -> torch.Tensor:
    """NumPower's NDArray_Lstsq: the minimum-norm least-squares solution x
    of a x = b (a is M x N, b has M rows), through the SVD with singular
    values below max(M, N) eps of the largest dropped, on every device (the
    card's torch.linalg.lstsq assumes a full-rank tall a)."""
    a, b = _inexact(a, b)
    if a.shape[0] != b.shape[0]:
        raise ValueError("Leading dimensions of input arrays must match")
    vector = b.ndim == 1
    if vector:
        b = b[:, None]
    if a.ndim != 2:
        raise TypeError(f"{a.ndim}-dimensional array given. Array must be two-dimensional")
    if b.ndim != 2:
        raise TypeError(f"{b.ndim}-dimensional array given. Array must be one or "
                        "two-dimensional")
    m, n = a.shape
    if a.numel() == 0:
        x = torch.zeros((n,) + tuple(b.shape[1:]), dtype=a.dtype, device=a.device)
    else:
        rcond = torch.finfo(a.dtype).eps * max(n, m)
        u, s, vt = _svd(a)
        mask = (s > 0) & (s >= rcond * s[0])
        s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0)[:, None]
        x = vt.mT.conj() @ (s_inv * (u.mT.conj() @ b))
    return x.reshape(-1) if vector else x


def pinv(a) -> torch.Tensor:
    """The pseudo-inverse through the SVD, singular values at or below
    10 max(M, N) eps of the largest dropped (jnp.linalg.pinv's default cut;
    torch's own default is ten times smaller)."""
    (a,) = _inexact(a)
    m, n = a.shape[-2:]
    if m == 0 or n == 0:
        return torch.zeros(a.shape[:-2] + (n, m), dtype=a.dtype, device=a.device)
    a = a.conj()
    rtol = 10.0 * max(m, n) * torch.finfo(a.dtype).eps
    u, s, vh = _svd(a)
    s = torch.where(s > rtol * s[..., 0:1], s, torch.inf).to(u.dtype)
    return vh.mT @ (u.mT / s[..., None])


def matrix_power(a, n: int) -> torch.Tensor:
    """a to the integer power n by jnp.linalg.matrix_power's products
    (square-and-multiply from the lowest bit; the inverse first for n < 0)."""
    a = asarray(a)
    if a.ndim < 2:
        raise TypeError(f"{a.ndim}-dimensional array given. Array must be at least "
                        "two-dimensional")
    if a.shape[-2] != a.shape[-1]:
        raise TypeError("Last 2 dimensions of the array must be square")
    n = int(n)
    if n == 0:
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        return torch.broadcast_to(eye, a.shape).clone()
    if n < 0:
        a, n = inv(a), -n
    mm = _matmul_in_dtype
    if n == 1:
        return a
    if n == 2:
        return mm(a, a)
    if n == 3:
        return mm(mm(a, a), a)
    z = result = None
    while n > 0:
        z = a if z is None else mm(z, z)
        n, bit = divmod(n, 2)
        if bit:
            result = z if result is None else mm(result, z)
    return result


def _matmul_in_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the operands' own dtype, as jnp's @ (integers exactly,
    wrapping as int32 does)."""
    if a.dtype.is_floating_point or a.dtype.is_complex:
        return a @ b
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2).to(a.dtype)


def kron(a, b) -> torch.Tensor:
    """The Kronecker product, in the promoted dtype."""
    a, b = as_operands(a, b)
    dt = _promoted_dtype(a, b)
    return torch.kron(a.to(dt), b.to(dt))


def einsum(subscripts: str, *operands) -> torch.Tensor:
    """Einstein summation accumulated in float32, with a float32 result (the
    JAX op's preferred element type; float64 stays float64)."""
    ts = as_operands(*operands)
    acc = accumulation_dtype(_promoted_dtype(*ts))
    return torch.einsum(subscripts, *(t.to(acc) for t in ts))
