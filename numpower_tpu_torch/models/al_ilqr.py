"""AL-iLQR: box-constrained iLQR via the augmented Lagrangian method (port of
numpower_tpu/models/al_ilqr.py).

Nonlinear dynamics AND hard control box constraints, ALTRO-style:

  outer loop (al_iters, fixed):
      inner: iLQR on the augmented cost
          J_aug = J + sum_t [ lam' c(u_t) + 1/2 c(u_t)' I_mu c(u_t) ]
      with c(u) = [u - hi; lo - u] <= 0 and I_mu the active-set penalty
      (mu where c_i > 0 or lam_i > 0, else 0)
      dual update: lam <- max(0, lam + mu c);  mu <- beta * mu

The penalty derivatives are closed-form diagonal terms; multipliers and
penalty stay tensors on the device, so no iteration waits on the host. Every
function takes leading batch dimensions: al_ilqr_solve (one scenario) and the
"vmap" backend of al_ilqr_solve_batched share one implementation. The
"fused" backend runs the inner backward pass as one K7 launch with the
active-set Hessian as its per-step diagonal, and the line search as one K8
launch, adding the penalty to K8's quadratic costs outside the kernel.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from numpower_tpu_torch.models.ilqr import (
    ALPHAS, _as, _backward_pass as _ilqr_backward_pass, _forward_pass, _forward_route,
    _fused_backward, _init_controls, _line_search, _select, _total_cost,
)
from numpower_tpu_torch.models.rollout import linearize_trajectory, rollout_nonlinear
from numpower_tpu_torch.utils.device import state_tensor


class ALILQRResult(NamedTuple):
    us: torch.Tensor             # (..., T, m) controls (feasible up to max_violation)
    xs: torch.Tensor             # (..., T+1, n) trajectory
    cost: torch.Tensor           # (...) true (unaugmented) cost of (xs, us)
    max_violation: torch.Tensor  # (...) max box violation at the solution
    costs: torch.Tensor          # (..., al_iters) true cost after each outer iteration


def _al_terms(us, lam_hi, lam_lo, mu, u_lo, u_hi):
    """Penalty cost + its diagonal u-derivatives for the whole horizon.

    c_hi = u - hi, c_lo = lo - u (elementwise, (..., T, m)). Returns
    (cost_aug_total (...), lu_pen (..., T, m), luu_pen_diag (..., T, m))."""
    c_hi = us - u_hi
    c_lo = u_lo - us
    act_hi = ((c_hi > 0) | (lam_hi > 0)).to(us.dtype) * mu
    act_lo = ((c_lo > 0) | (lam_lo > 0)).to(us.dtype) * mu
    cost = torch.sum(lam_hi * c_hi + 0.5 * act_hi * c_hi * c_hi, dim=(-2, -1))
    cost = cost + torch.sum(lam_lo * c_lo + 0.5 * act_lo * c_lo * c_lo, dim=(-2, -1))
    # d/du [lam c + 1/2 I c^2]: +1 sign for c_hi, -1 for c_lo
    lu_pen = (lam_hi + act_hi * c_hi) - (lam_lo + act_lo * c_lo)
    luu_pen = act_hi + act_lo
    return cost, lu_pen, luu_pen


def _backward_pass_al(As, Bs, xs, us, Q, R, QF, x_goal, reg, lu_pen, luu_pen):
    """iLQR backward pass with additive penalty derivatives on u: the shared
    recursion of models/ilqr._backward_pass with its lu_pen/luu_pen terms."""
    return _ilqr_backward_pass(As, Bs, xs, us, Q, R, QF, x_goal, reg,
                               lu_pen=lu_pen, luu_pen=luu_pen)


def _solve(f, x0, Q, R, QF, x_goal, horizon, u_lo, u_hi, al_iters, ilqr_iters, mu0, mu_scale,
           reg, use_fd, fd_eps, us_init, alphas, fused: bool, forward: str) -> ALILQRResult:
    """AL-iLQR on x0 (..., n), every leading dimension an independent solve;
    fused: K7 for the backward pass and `forward` for the line search (a
    batch (N, n) only). A numpy x0 goes to the card as float32."""
    x0 = state_tensor(x0)
    Q, R, QF, x_goal = (_as(a, x0) for a in (Q, R, QF, x_goal))
    batch = x0.shape[:-1]
    us = torch.clamp(_init_controls(us_init, batch + (horizon, R.shape[0]), x0), u_lo, u_hi)
    alpha = _as(alphas, x0).reshape((-1,) + (1,) * (len(batch) + 1))
    terms = functools.partial(_al_terms, u_lo=u_lo, u_hi=u_hi)

    def aug_cost(xs, us, lam_hi, lam_lo, mu):
        return _total_cost(xs, us, Q, R, QF, x_goal) + terms(us, lam_hi, lam_lo, mu)[0]

    def inner_iteration(xs, us, cost, lam_hi, lam_lo, mu):
        As, Bs = linearize_trajectory(f, xs, us, use_fd=use_fd, eps=fd_eps)
        _, lu_pen, luu_pen = terms(us, lam_hi, lam_lo, mu)
        if fused:
            ks, Ks = _fused_backward(As, Bs, xs, us, Q, R, QF, x_goal, reg, lu_pen, luu_pen)
            us_all, xs_all, costs_q = _line_search(f, forward, x0, xs, us, ks, Ks, alpha,
                                                   Q, R, QF, x_goal)
            costs_a = costs_q + terms(us_all, lam_hi, lam_lo, mu)[0]
        else:
            ks, Ks = _backward_pass_al(As, Bs, xs, us, Q, R, QF, x_goal, reg, lu_pen, luu_pen)
            us_all, xs_all = _forward_pass(f, x0, xs, us, ks, Ks, alpha)
            costs_a = aug_cost(xs_all, us_all, lam_hi, lam_lo, mu)
        return _select(costs_a, us_all, xs_all, xs, us, cost)

    xs = rollout_nonlinear(f, x0, us)
    lam_hi = torch.zeros_like(us)
    lam_lo = torch.zeros_like(us)
    mu = torch.full((), mu0, dtype=x0.dtype, device=x0.device)
    costs = []
    for _ in range(al_iters):
        cost = aug_cost(xs, us, lam_hi, lam_lo, mu)
        for _ in range(ilqr_iters):
            xs, us, cost = inner_iteration(xs, us, cost, lam_hi, lam_lo, mu)
        lam_hi = torch.clamp(lam_hi + mu * (us - u_hi), min=0.0)
        lam_lo = torch.clamp(lam_lo + mu * (u_lo - us), min=0.0)
        mu = mu * mu_scale
        costs.append(_total_cost(xs, us, Q, R, QF, x_goal))
    viol = torch.maximum(torch.amax(us - u_hi, dim=(-2, -1)), torch.amax(u_lo - us, dim=(-2, -1)))
    viol = torch.clamp(viol, min=0.0)
    us_proj = torch.clamp(us, u_lo, u_hi)
    xs_proj = rollout_nonlinear(f, x0, us_proj)
    return ALILQRResult(us=us_proj, xs=xs_proj,
                        cost=_total_cost(xs_proj, us_proj, Q, R, QF, x_goal),
                        max_violation=viol, costs=torch.stack(costs, dim=-1))


def al_ilqr_solve(
    f: Callable,
    x0: torch.Tensor,
    Q,
    R,
    QF,
    x_goal,
    horizon: int,
    u_lo: float,
    u_hi: float,
    al_iters: int = 6,
    ilqr_iters: int = 8,
    mu0: float = 1.0,
    mu_scale: float = 8.0,
    reg: float = 1e-3,
    use_fd: bool = False,
    fd_eps: float = 1e-4,
    us_init: Optional[torch.Tensor] = None,
    alphas: Tuple[float, ...] = ALPHAS,
) -> ALILQRResult:
    """Box-constrained iLQR solve of one scenario x0 (n,).

    Returns controls satisfying u_lo <= u <= u_hi to within max_violation:
    the final iterate is projected onto the box, so the returned plan is
    strictly feasible, and the projection's size is reported."""
    return _solve(f, x0, Q, R, QF, x_goal, horizon, u_lo, u_hi, al_iters, ilqr_iters, mu0,
                  mu_scale, reg, use_fd, fd_eps, us_init, alphas, fused=False, forward="plain")


def al_ilqr_solve_batched(f, x0s, *args, backend: str = "vmap", **kwargs) -> ALILQRResult:
    """Batched AL-iLQR over scenario initial states x0s (N, n).

    backend="vmap": the per-scenario solve of al_ilqr_solve on the whole
    batch. backend="fused": the inner backward pass runs as one K7 launch
    over the batch, with the active-set penalty Hessian as its per-step
    diagonal, and the line search as one K8 launch (forward="kernel", the
    default) or as the plain batched rollout (forward="plain"); the penalty
    is added to K8's quadratic costs outside the kernel. Same numerics per
    backward pass; line-search branch selection may differ in marginal
    scenarios (see models/ilqr.ilqr_solve_batched)."""
    if backend == "vmap":
        kwargs.pop("forward", None)  # fused-backend-only knob
        return al_ilqr_solve(f, x0s, *args, **kwargs)
    if backend != "fused":
        raise ValueError(f"unknown backend {backend!r} (vmap|fused)")
    return _al_ilqr_solve_batched_fused(f, x0s, *args, **kwargs)


def _al_ilqr_solve_batched_fused(
    f, x0s, Q, R, QF, x_goal, horizon: int, u_lo, u_hi,
    al_iters: int = 6, ilqr_iters: int = 8, mu0: float = 1.0,
    mu_scale: float = 8.0, reg: float = 1e-3, use_fd: bool = False,
    fd_eps: float = 1e-4, us_init=None, alphas: Tuple[float, ...] = ALPHAS,
    forward: str = "kernel",
) -> ALILQRResult:
    """The fused backend (see al_ilqr_solve_batched)."""
    forward = _forward_route(forward)
    return _solve(f, x0s, Q, R, QF, x_goal, horizon, u_lo, u_hi, al_iters, ilqr_iters, mu0,
                  mu_scale, reg, use_fd, fd_eps, us_init, alphas, fused=True, forward=forward)
