"""Moving-horizon estimation (MHE): constrained estimation as a QP (port of
numpower_tpu/models/mhe.py).

The optimization-based dual of the Kalman filter: over a window of M
measurements, estimate the state trajectory by minimizing

    J = ||x_0 - x_prior||^2_{P0^-1} + sum_k ||w_k||^2_{Q^-1}
        + sum_k ||y_k - C x_k||^2_{R^-1}
    s.t. x_{k+1} = A x_k + B u_k + w_k      (k = 0..M-1)
         x_lo <= x_k <= x_hi                (optional)

Condensed like the MPC QP (models/condensed.py): the states are eliminated
through the prediction matrices, the decision variable is
d = [x_0; w_0..w_{M-1}], and the problem becomes a dense QP whose
unconstrained optimum equals the RTS smoother, while state bounds go through
the OSQP splitting of state-constrained MPC (models/admm.solve_qp_osqp).

Leading batch dimensions of x_prior (..., n), ys (..., M, p) and us
(..., M, m) are independent windows sharing the model (the JAX package's
vmap): the window matrices are formed once, the unconstrained windows are
one Cholesky solve with a column per window, the constrained ones one
batched OSQP run. A numpy x_prior goes to the card as float32
(utils.state_tensor); every other operand follows its device and dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from numpower_tpu_torch.models.admm import OVER_RELAX, _osqp
from numpower_tpu_torch.models.admm import solve_qp_osqp  # noqa: F401  (the JAX module's name)
from numpower_tpu_torch.models.condensed import _power_iteration_lmax, prediction_matrices
from numpower_tpu_torch.utils.device import state_tensor


class MHEResult(NamedTuple):
    xs: torch.Tensor               # (..., M+1, n) estimated states x_0..x_M
    ws: torch.Tensor               # (..., M, n) estimated process noise
    objective: torch.Tensor        # (...) J at the solution
    primal_residual: torch.Tensor  # (...) OSQP residual (0.0 for unconstrained)


def _mhe_matrices(A, C, Q, R, P0, M: int):
    """Window matrices: G maps d = [x0; W] to the stacked predicted
    measurements; Hq and GtR build the condensed QP (formed once per window
    size, shared across windows)."""
    n = A.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Sx, Sn = prediction_matrices(A, eye, M)            # noise enters via I
    Md = torch.cat([Sx, Sn], dim=1)                    # (M n, n(M+1))
    Cb = torch.block_diag(*([C] * M))                  # (M p, M n)
    G = Cb @ Md                                        # (M p, n(M+1))
    P0inv = torch.linalg.inv(P0)
    Qinv = torch.linalg.inv(Q)
    Rinv = torch.linalg.inv(R)
    Pblk = torch.block_diag(P0inv, *([Qinv] * M))
    Rblk = torch.block_diag(*([Rinv] * M))
    GtR = G.T @ Rblk
    Hq = 2.0 * (Pblk + GtR @ G)
    Hq = 0.5 * (Hq + Hq.T)
    return Md, Cb, Pblk, Rblk, GtR, Hq, P0inv


def mhe_solve(
    A,
    C,
    Q,
    R,
    P0,
    x_prior,              # (..., n) arrival-cost mean for x_0
    ys,                   # (..., M, p) window measurements y_1..y_M
    B=None,
    us=None,              # (..., M, m) known inputs u_0..u_{M-1}
    x_lo=None,
    x_hi=None,
    iters: int = 100,
) -> MHEResult:
    """Solve MHE windows. Without bounds this is the exact linear-Gaussian
    smoother (one Cholesky solve); with bounds it runs the OSQP splitting."""
    x_prior = state_tensor(x_prior)
    dt, dev = x_prior.dtype, x_prior.device
    A, C, Q, R, P0, ys = (torch.as_tensor(a, dtype=dt, device=dev) for a in (A, C, Q, R, P0, ys))
    M, p = ys.shape[-2:]
    n = A.shape[0]
    Md, Cb, _, _, GtR, Hq, P0inv = _mhe_matrices(A, C, Q, R, P0, M)

    if us is None:
        c = torch.zeros(M * n, dtype=dt, device=dev)
    else:
        if B is None:
            raise ValueError("us requires B (the input matrix)")
        B, us = (torch.as_tensor(a, dtype=dt, device=dev) for a in (B, us))
        # known-input contribution to the stacked states: Su @ U
        _, Su = prediction_matrices(A, B, M)
        c = us.reshape(us.shape[:-2] + (-1,)) @ Su.T
    e = ys.reshape(ys.shape[:-2] + (M * p,)) - c @ Cb.T
    prior = torch.cat([x_prior @ P0inv.T, torch.zeros(x_prior.shape[:-1] + (M * n,), dtype=dt,
                                                      device=dev)], dim=-1)
    gq = -2.0 * (e @ GtR.T + prior)
    batch, D = gq.shape[:-1], Hq.shape[0]

    if x_lo is None and x_hi is None:
        L = torch.linalg.cholesky(Hq)
        flat = (-gq).reshape(-1, D)
        d = torch.cholesky_solve(flat.T, L).T.reshape(gq.shape)
        r_prim = torch.zeros(batch, dtype=dt, device=dev)
    else:
        lo = -float("inf") if x_lo is None else x_lo
        hi = float("inf") if x_hi is None else x_hi
        xl, xh = (torch.as_tensor(b, dtype=dt, device=dev).expand(n) for b in (lo, hi))
        # bounds on x_0 (the first n entries of d) and on x_1..x_M (= Md d + c)
        Ac = torch.cat([torch.cat([torch.eye(n, dtype=dt, device=dev),
                                   torch.zeros((n, M * n), dtype=dt, device=dev)], dim=1),
                        Md], dim=0)
        l = torch.cat([xl.expand(c.shape[:-1] + (n,)), xl.repeat(M) - c], dim=-1)
        u = torch.cat([xh.expand(c.shape[:-1] + (n,)), xh.repeat(M) - c], dim=-1)
        # geometric-mean rho: Hq = 2(Pblk + G'RinvG) >= 2 Pblk, so the
        # smallest block eigenvalue bounds lam_min; inverse-covariance
        # weights make lam_max large (1/Q scale)
        mu_bound = 2.0 * torch.minimum(torch.linalg.eigvalsh(P0inv)[0],
                                       torch.linalg.eigvalsh(torch.linalg.inv(Q))[0])
        rho = torch.sqrt(_power_iteration_lmax(Hq) * torch.clamp(mu_bound, min=1e-9))
        d, _, _, r_prim, _ = _osqp(Hq, gq, Ac, l, u, rho, 1e-6, iters, OVER_RELAX)

    x0 = d[..., :n]
    W = d[..., n:].reshape(batch + (M, n))
    X = (d @ Md.T + c).reshape(batch + (M, n))
    xs = torch.cat([x0[..., None, :], X], dim=-2)
    obj = 0.5 * torch.sum(d * (d @ Hq.T), dim=-1) + torch.sum(gq * d, dim=-1)
    return MHEResult(xs=xs, ws=W, objective=obj, primal_residual=r_prim)
