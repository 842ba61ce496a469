"""Dynamics rollouts and linearization (port of numpower_tpu/models/rollout.py).

A rollout is a Python loop over the horizon; each step is one batched tensor
operation over every leading batch dimension (scenarios, line-search
candidates), so a batch costs no more launches than one scenario. Nonlinear
plants follow the house style of models/plants.py: f(x, u) indexes the last
axis and takes any batch shape.

Jacobians come from ``torch.func.jacfwd`` (exact) or central finite
differences (BASELINE config #3 exercises the finite-difference path). Both
linearize a whole trajectory, and a batch of trajectories, in a fixed number
of launches: there is no loop over t.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from numpower_tpu_torch.utils.device import follow, state_tensor


def rollout_lti(A, B, x0, us):
    """x_{t+1} = A x_t + B u_t for a (..., T, m) control sequence.

    Returns xs (..., T+1, n) including x0. A numpy x0 goes to the card as
    float32 (utils.state_tensor); A, B and us follow x0's device and dtype."""
    x0 = state_tensor(x0)
    A, B, us = follow(x0, A, B, us)
    xs = [x0]
    for t in range(us.shape[-2]):
        xs.append(xs[-1] @ A.T + us[..., t, :] @ B.T)
    return torch.stack(xs, dim=-2)


def rollout_ltv(As, Bs, x0, us):
    """Time-varying x_{t+1} = A_t x_t + B_t u_t; As (..., T, n, n), Bs
    (..., T, n, m). Operands as in :func:`rollout_lti`, led by x0."""
    x0 = state_tensor(x0)
    As, Bs, us = follow(x0, As, Bs, us)
    xs = [x0]
    for t in range(us.shape[-2]):
        xs.append((As[..., t, :, :] @ xs[-1][..., None])[..., 0]
                  + (Bs[..., t, :, :] @ us[..., t, :, None])[..., 0])
    return torch.stack(xs, dim=-2)


def rollout_nonlinear(f: Callable, x0, us):
    """Nonlinear plant rollout: x0 (..., n), us (..., T, m) -> xs
    (..., T+1, n); f(x, u) -> x_next indexes the last axis. A numpy x0 goes
    to the card as float32 (utils.state_tensor); us follows x0."""
    x0 = state_tensor(x0)
    (us,) = follow(x0, us)
    xs = [x0]
    for t in range(us.shape[-2]):
        xs.append(f(xs[-1], us[..., t, :]))
    return torch.stack(xs, dim=-2)


def batched_rollout_lti(A, B, x0s, uss):
    """x0s (N, n); uss (N, T, m) -> (N, T+1, n). Operands as in
    :func:`rollout_lti`, led by x0s."""
    return rollout_lti(A, B, x0s, uss)


def linearize(f: Callable, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Jacobians (A, B) = (df/dx, df/du) at (x, u) via jacfwd. A numpy
    x goes to the card as float32 (utils.state_tensor); u follows x."""
    x = state_tensor(x)
    (u,) = follow(x, u)
    A = torch.func.jacfwd(f, argnums=0)(x, u)
    B = torch.func.jacfwd(f, argnums=1)(x, u)
    return A, B


def linearize_finite_diff(f: Callable, x, u, eps: float = 1e-4):
    """Central finite-difference Jacobians at (x, u), or at each point of a
    batch (..., n), (..., m): the 2(n + m) perturbed states and controls are
    stacked on a new axis and f runs once on all of them. Operands as in
    :func:`linearize`."""
    x = state_tensor(x)
    (u,) = follow(x, u)
    n, m = x.shape[-1], u.shape[-1]
    ex = torch.eye(n, dtype=x.dtype, device=x.device) * eps
    eu = torch.eye(m, dtype=u.dtype, device=u.device) * eps
    xb, ub = x[..., None, :], u[..., None, :]
    X = torch.cat([xb + ex, xb - ex, xb.expand(*x.shape[:-1], 2 * m, n)], dim=-2)
    U = torch.cat([ub.expand(*u.shape[:-1], 2 * n, m), ub + eu, ub - eu], dim=-2)
    F = f(X, U)  # (..., 2(n + m), n): rows f(x + eps e_i), f(x - eps e_i), ...
    A = (F[..., :n, :] - F[..., n:2 * n, :]).transpose(-1, -2) / (2 * eps)
    B = (F[..., 2 * n:2 * n + m, :] - F[..., 2 * n + m:, :]).transpose(-1, -2) / (2 * eps)
    return A, B


def linearize_trajectory(f: Callable, xs, us, use_fd: bool = False, eps: float = 1e-4):
    """Linearize along a trajectory: xs (..., T+1, n) or (..., T, n), us
    (..., T, m) -> As (..., T, n, n), Bs (..., T, n, m). All T steps, of every
    trajectory of the batch, at once. A numpy xs goes to the card as float32
    (utils.state_tensor); us follows xs."""
    xs = state_tensor(xs)
    (us,) = follow(xs, us)
    xs_t = xs[..., : us.shape[-2], :]
    if use_fd:
        return linearize_finite_diff(f, xs_t, us, eps)
    batch = us.shape[:-1]
    n, m = xs_t.shape[-1], us.shape[-1]
    jac = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1)))
    A, B = jac(xs_t.reshape(-1, n), us.reshape(-1, m))
    return A.reshape(*batch, n, n), B.reshape(*batch, n, m)


def quadratic_cost(Q, R, QF, x_ref=None):
    """Builds a trajectory cost function:
    cost = sum_t [(x_t-xref)'Q(x_t-xref) + u_t'R u_t] + terminal QF term.
    A numpy xs goes to the card as float32 (utils.state_tensor); us, the
    weights and x_ref follow xs's device and dtype."""

    def total(xs, us):
        xs = state_tensor(xs)
        us, Qt, Rt, QFt, xr = follow(xs, us, Q, R, QF, x_ref)
        if xr is None:
            xr = torch.zeros_like(xs[..., 0, :])
        dx = xs[..., :-1, :] - xr[..., None, :]
        dxf = xs[..., -1, :] - xr
        stage = (torch.einsum("...ti,ij,...tj->...", dx, Qt, dx)
                 + torch.einsum("...ti,ij,...tj->...", us, Rt, us))
        return stage + torch.einsum("...i,ij,...j->...", dxf, QFt, dxf)

    return total
