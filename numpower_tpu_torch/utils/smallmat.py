"""Small-matrix linear algebra unrolled over the matrix indices (port of
numpower_tpu/utils/smallmat.py).

Every function loops over the (static, small) matrix dimension in Python and
indexes [..., i, j], so each generated operation is elementwise over the batch
dimensions: a batch of tiny factorizations costs O(n^2..n^3) batched tensor
ops and no per-matrix library call. These are the recurrences LAPACK runs
(and that the JAX package's Pallas kernels run in-register), so parity bounds
are those of fp32 LAPACK. Use them for n <= ~16: the op count grows as n^3/6.

On a CUDA tensor every line is a kernel launch, so these functions are bound by
launch overhead there; the batched hot paths have hand-written kernels instead
(kernels/cholesky.py, kernels/riccati.py), which use these functions as their
plain versions.
"""

from __future__ import annotations

import torch

__all__ = ["cholesky_unrolled", "psd_solve_unrolled", "solve_small",
           "lu_solve_unrolled", "lu_solve_nopivot", "tri_solve_unrolled"]


def _factor(M: torch.Tensor):
    """Lower Cholesky factor of SPD M (..., n, n) as scalars: L[i][j] (j <= i)
    and inv[j] = 1 / L[j][j]. Reads the lower triangle of M only. One rsqrt
    per pivot: L[j][j] = acc * rsqrt(acc); a non-PD pivot gives NaN from that
    column on."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    inv = [None] * n
    for j in range(n):
        acc = M[..., j, j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        inv[j] = torch.rsqrt(acc)
        L[j][j] = acc * inv[j]
        for i in range(j + 1, n):
            acc = M[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = acc * inv[j]
    return L, inv


def cholesky_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of SPD M (..., n, n) by the scalar recurrence, unrolled
    into elementwise ops over the batch dims; the strictly upper triangle of
    the result is exactly 0.

    Failure envelope: M must be SPD. A non-PD input hits the rsqrt of a
    negative pivot and the result is NaN from that column on, never an
    exception; test torch.isnan(L[..., -1, -1]) where the check is needed."""
    n = M.shape[-1]
    L, _ = _factor(M)
    zero = torch.zeros_like(M[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2)


def psd_solve_unrolled(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M X = rhs for SPD M (..., n, n); rhs (..., n, r) or (..., n).

    Cholesky factor (lower triangle of M only, inverse diagonal cached) and
    forward/backward substitution by multiplies, fully unrolled."""
    n = M.shape[-1]
    vec = rhs.ndim == M.ndim - 1
    if vec:
        rhs = rhs[..., None]
    L, inv = _factor(M)
    y = [None] * n
    for i in range(n):  # forward: L Y = rhs
        acc = rhs[..., i, :]
        for k in range(i):
            acc = acc - L[i][k][..., None] * y[k]
        y[i] = acc * inv[i][..., None]
    x = [None] * n
    for i in range(n - 1, -1, -1):  # backward: L' X = Y
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i][..., None] * x[k]
        x[i] = acc * inv[i][..., None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def tri_solve_unrolled(L: torch.Tensor, rhs: torch.Tensor, lower: bool = True) -> torch.Tensor:
    """Solve L X = rhs for triangular L (..., n, n); rhs (..., n, r) or
    (..., n). Forward/backward substitution unrolled; each row's reciprocal
    pivot is taken once and multiplies the r columns."""
    n = L.shape[-1]
    vec = rhs.ndim == L.ndim - 1
    if vec:
        rhs = rhs[..., None]
    x = [None] * n
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        acc = rhs[..., i, :]
        ks = range(i) if lower else range(i + 1, n)
        for k in ks:
            acc = acc - L[..., i, k][..., None] * x[k]
        x[i] = acc * (1.0 / L[..., i, i])[..., None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def lu_solve_unrolled(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M X = rhs for general invertible M (..., n, n) by Gauss-Jordan
    elimination with implicit partial pivoting, unrolled over the columns.

    Rows are never swapped: per column k the pivot is the largest-|.| row not
    yet pivoted (a masked argmax, which takes the FIRST maximum on ties and
    the first NaN, as jnp.argmax does), column k is eliminated from every
    other row by one rank-1 update of the [M | rhs] block, and the pivot's
    row is remembered as a one-hot; the solution is read out at the end.

    Failure envelope: a singular M divides by a zero pivot and gives inf/NaN,
    never an exception; a NaN anywhere in a column poisons its argmax, so
    NaNs spread to the whole solution; the forward error is that of fp32
    partial pivoting, ~c(n) * kappa(M) * 1.2e-7."""
    n = M.shape[-1]
    vec = rhs.ndim == M.ndim - 1
    if vec:
        rhs = rhs[..., None]
    W = torch.cat([M, rhs], dim=-1)  # (..., n, n + r)
    ridx = torch.arange(n, device=M.device)
    used = torch.zeros(W.shape[:-2] + (n,), dtype=torch.bool, device=M.device)
    onehots = []
    for k in range(n):
        col = torch.where(used, float("-inf"), torch.abs(W[..., :, k]))
        oh = ridx == torch.argmax(col, dim=-1)[..., None]  # (..., n)
        used = used | oh
        pivot_row = torch.sum(torch.where(oh[..., None], W, 0.0), dim=-2)
        factors = torch.where(oh, 0.0, W[..., :, k] / pivot_row[..., k][..., None])
        W = W - factors[..., None] * pivot_row[..., None, :]
        onehots.append(oh)
    x = []
    for k in range(n):
        prow = torch.sum(torch.where(onehots[k][..., None], W, 0.0), dim=-2)
        x.append(prow[..., n:] / prow[..., k][..., None])
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def lu_solve_nopivot(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M X = rhs WITHOUT pivoting: plain unrolled Gauss-Jordan.

    ONLY for matrices known to have stable unpivoted elimination, such as
    the associative-combine denominators I + C J of well-conditioned
    control and estimation problems. C, J PSD does not bound the pivots: a
    zero or tiny pivot silently gives inf/NaN or a large error (see the JAX
    package's docstring for the measured envelope). Use lu_solve_unrolled
    for anything not known to be well-conditioned."""
    n = M.shape[-1]
    vec = rhs.ndim == M.ndim - 1
    if vec:
        rhs = rhs[..., None]
    W = torch.cat([M, rhs], dim=-1)  # (..., n, n + r)
    for k in range(n):
        pivot_row = W[..., k, :]
        factors = W[..., :, k] * (1.0 / pivot_row[..., k])[..., None]
        others = (torch.arange(n, device=M.device) != k)[..., None]
        W = torch.where(others, W - factors[..., None] * pivot_row[..., None, :], W)
    x = W[..., :, n:] / torch.diagonal(W[..., :, :n], dim1=-2, dim2=-1)[..., None]
    return x[..., 0] if vec else x


def solve_small(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M X = rhs for general tiny M: adjugate closed form for n <= 3
    (elementwise over the batch dims), unrolled partial-pivot LU up to
    n = 16, torch.linalg.solve beyond. rhs may be (..., n, r) or a vector
    (..., n) in every regime, batched vectors included."""
    n = M.shape[-1]
    vec = rhs.ndim == M.ndim - 1
    if n > 16:
        if vec:
            return torch.linalg.solve(M, rhs[..., None])[..., 0]
        return torch.linalg.solve(M, rhs)
    if n > 3:
        return lu_solve_unrolled(M, rhs)
    if vec:
        rhs = rhs[..., None]
    if n == 1:
        x = rhs / M[..., 0:1, 0:1]
    elif n == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], dim=-1),
                           torch.stack([-c, a], dim=-1)], dim=-2) / det[..., None, None]
        x = inv @ rhs
    else:
        m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        c00 = m11 * m22 - m12 * m21
        c01 = m12 * m20 - m10 * m22
        c02 = m10 * m21 - m11 * m20
        det = m00 * c00 + m01 * c01 + m02 * c02
        adj = torch.stack([
            torch.stack([c00, m02 * m21 - m01 * m22, m01 * m12 - m02 * m11], dim=-1),
            torch.stack([c01, m00 * m22 - m02 * m20, m02 * m10 - m00 * m12], dim=-1),
            torch.stack([c02, m01 * m20 - m00 * m21, m00 * m11 - m01 * m10], dim=-1),
        ], dim=-2)
        x = (adj / det[..., None, None]) @ rhs
    return x[..., 0] if vec else x
