"""iLQR (iterative LQR) for nonlinear plants (port of
numpower_tpu/models/ilqr.py).

BASELINE config #3: cartpole iLQR with finite-difference Jacobians, and its
batched form (#3b). Structure:

 - linearization: all T steps of every scenario at once (models/rollout.py)
 - backward pass: the Riccati recursion with Levenberg regularization on
   Q_uu, a Python loop over T of batched ops; or, on backend="fused", one
   launch of the K7 kernel (kernels/ilqr_backward.py) for the whole batch
 - forward pass: ALL line-search step sizes rolled out together as one
   more batch dimension; or one launch of the K8 kernel
   (kernels/ilqr_forward.py), the plant in the kernel
 - selection: the best-cost candidate by torch.argmin and torch.where on
   the device, per scenario, so no iteration waits on the host
 - outer loop: a Python loop of fixed length

Every function here takes leading batch dimensions: one implementation
serves ilqr_solve (one scenario) and the "vmap" backend of
ilqr_solve_batched (a batch of independent solves).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from numpower_tpu_torch.kernels.ilqr_backward import ilqr_backward_fused
from numpower_tpu_torch.kernels.ilqr_forward import ilqr_forward_fused
from numpower_tpu_torch.models.lqr import _psd_solve
from numpower_tpu_torch.models.rollout import linearize_trajectory, rollout_nonlinear
from numpower_tpu_torch.utils.device import state_tensor

ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03, 0.01)


class ILQRResult(NamedTuple):
    us: torch.Tensor     # (..., T, m) optimal controls
    xs: torch.Tensor     # (..., T+1, n) trajectory
    cost: torch.Tensor   # (...) final cost
    costs: torch.Tensor  # (..., iters) cost per outer iteration


def _mv(M, v):
    """M v over leading batch dimensions."""
    return (M @ v[..., None])[..., 0]


def _total_cost(xs, us, Q, R, QF, x_goal):
    dx = xs[..., :-1, :] - x_goal
    dxf = xs[..., -1, :] - x_goal
    return (torch.einsum("...ti,ij,...tj->...", dx, Q, dx)
            + torch.einsum("...ti,ij,...tj->...", us, R, us)
            + torch.einsum("...i,ij,...j->...", dxf, QF, dxf))


def _backward_pass(As, Bs, xs, us, Q, R, QF, x_goal, reg, lu_pen=None, luu_pen=None):
    """LQ backward pass on the linearized system with quadratic tracking
    cost. Returns feedforward ks (..., T, m) and feedback Ks (..., T, m, n).

    lu_pen/luu_pen ((..., T, m) each, optional) add per-timestep gradient and
    DIAGONAL Hessian terms on u: the augmented-Lagrangian active-set penalty
    (models/al_ilqr._al_terms). One recursion serves both plain iLQR and
    AL-iLQR."""
    T, m = us.shape[-2:]
    eye_m = torch.eye(m, dtype=us.dtype, device=us.device)
    Vx = 2.0 * _mv(QF, xs[..., -1, :] - x_goal)
    Vxx = 2.0 * QF
    ks, Ks = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        A, B = As[..., t, :, :], Bs[..., t, :, :]
        At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
        lx = 2.0 * _mv(Q, xs[..., t, :] - x_goal)
        lu = 2.0 * _mv(R, us[..., t, :])
        luu = 2.0 * R
        if lu_pen is not None:
            lu = lu + lu_pen[..., t, :]
        if luu_pen is not None:
            luu = luu + torch.diag_embed(luu_pen[..., t, :])
        Qx = lx + _mv(At, Vx)
        Qu = lu + _mv(Bt, Vx)
        Qxx = 2.0 * Q + At @ Vxx @ A
        Quu = luu + Bt @ Vxx @ B + reg * eye_m
        Qux = Bt @ Vxx @ A
        sol = _psd_solve(0.5 * (Quu + Quu.transpose(-1, -2)),
                         torch.cat([Qu[..., None], Qux], dim=-1))
        k, K = -sol[..., 0], -sol[..., 1:]
        Kt = K.transpose(-1, -2)
        Vx = Qx + _mv(Kt @ Quu, k) + _mv(Kt, Qu) + _mv(Qux.transpose(-1, -2), k)
        Vxx = Qxx + Kt @ Quu @ K + Kt @ Qux + Qux.transpose(-1, -2) @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        ks[t], Ks[t] = k, K
    return torch.stack(ks, dim=-2), torch.stack(Ks, dim=-3)


def _forward_pass(f, x0, xs_nom, us_nom, ks, Ks, alpha):
    """Closed-loop rollout u = u_nom + alpha*k + K(x - x_nom).

    alpha is a float or a tensor that broadcasts against the controls
    (..., m): shape (A, 1, ..., 1) rolls out A step sizes at once, as a new
    leading batch dimension of the results us (A, ..., T, m) and
    xs (A, ..., T+1, n)."""
    us, xs = [], [x0]
    x = x0
    for t in range(us_nom.shape[-2]):
        u = (us_nom[..., t, :] + alpha * ks[..., t, :]
             + _mv(Ks[..., t, :, :], x - xs_nom[..., t, :]))
        x = f(x, u)
        us.append(u)
        xs.append(x)
    xs[0] = x0.expand(xs[-1].shape if len(xs) > 1 else x0.shape)
    return torch.stack(us, dim=-2), torch.stack(xs, dim=-2)


def _select(costs_a, us_all, xs_all, xs, us, cost):
    """Per scenario, the best line-search candidate if it lowers the cost;
    on the device, with no wait on the host."""
    best = torch.argmin(costs_a, dim=0)
    cand = torch.gather(costs_a, 0, best[None])[0]
    improved = cand < cost

    def pick(arr):
        idx = best[None, ..., None, None].expand((1,) + arr.shape[1:])
        return torch.gather(arr, 0, idx)[0]

    keep = improved[..., None, None]
    return (torch.where(keep, pick(xs_all), xs), torch.where(keep, pick(us_all), us),
            torch.where(improved, cand, cost))


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _init_controls(us_init, shape, like):
    if us_init is None:
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(_as(us_init, like), shape).clone()


def _solve_plain(f, x0, Q, R, QF, x_goal, horizon, iters, reg, use_fd, fd_eps, us_init,
                 alphas) -> ILQRResult:
    """iLQR on x0 (..., n): every leading dimension is an independent solve."""
    Q, R, QF, x_goal = (_as(a, x0) for a in (Q, R, QF, x_goal))
    batch = x0.shape[:-1]
    us = _init_controls(us_init, batch + (horizon, R.shape[0]), x0)
    xs = rollout_nonlinear(f, x0, us)
    cost = _total_cost(xs, us, Q, R, QF, x_goal)
    alpha = _as(alphas, x0).reshape((-1,) + (1,) * (len(batch) + 1))
    costs = []
    for _ in range(iters):
        As, Bs = linearize_trajectory(f, xs, us, use_fd=use_fd, eps=fd_eps)
        ks, Ks = _backward_pass(As, Bs, xs, us, Q, R, QF, x_goal, reg)
        us_all, xs_all = _forward_pass(f, x0, xs, us, ks, Ks, alpha)
        costs_a = _total_cost(xs_all, us_all, Q, R, QF, x_goal)
        xs, us, cost = _select(costs_a, us_all, xs_all, xs, us, cost)
        costs.append(cost)
    return ILQRResult(us=us, xs=xs, cost=cost, costs=torch.stack(costs, dim=-1))


def ilqr_solve(
    f: Callable,
    x0: torch.Tensor,
    Q,
    R,
    QF,
    x_goal,
    horizon: int,
    iters: int = 20,
    reg: float = 1e-3,
    use_fd: bool = False,
    fd_eps: float = 1e-4,
    us_init: Optional[torch.Tensor] = None,
    alphas: Tuple[float, ...] = ALPHAS,
    unroll_scans: bool = False,
) -> ILQRResult:
    """Full iLQR solve of one scenario x0 (n,); on x0's device and dtype
    (Q, R, QF, x_goal are copied there once). A numpy x0 goes to the card
    as float32 (utils.state_tensor).

    unroll_scans is accepted and has no effect: it was the JAX package's
    loop-overhead knob for its TPU scans, and the loops here are Python
    loops of batched operations."""
    del unroll_scans
    return _solve_plain(f, state_tensor(x0), Q, R, QF, x_goal, horizon, iters, reg, use_fd,
                        fd_eps, us_init, alphas)


def ilqr_solve_batched(f, x0s, Q, R, QF, x_goal, horizon, backend: str = "vmap", **kwargs):
    """Batched iLQR over scenarios x0s (N, n).

    backend="vmap": the per-scenario solve of ilqr_solve on the whole batch
    (its backward pass the full-form recursion of _backward_pass).
    backend="fused": the backward pass runs as ONE launch of the K7 kernel
    over the whole batch, and the line search as one launch of K8 (forward=
    "kernel", the default, the JAX package's "pallas") or as the plain
    batched rollout (forward="plain", its "xla"). On a CPU tensor the
    kernels' wrappers run their plain versions.

    The two backends agree per backward pass up to rounding (~1e-6
    relative) but may select different line-search branches in marginal
    scenarios, so final trajectories can differ on chaotic landscapes; both
    monotonically descend the cost. A numpy x0s goes to the card as float32."""
    x0s = state_tensor(x0s)
    if backend == "vmap":
        kwargs.pop("forward", None)  # fused-backend-only knob
        return ilqr_solve(f, x0s, Q, R, QF, x_goal, horizon, **kwargs)
    if backend != "fused":
        raise ValueError(f"unknown backend {backend!r} (vmap|fused)")
    kwargs.pop("unroll_scans", None)
    return _ilqr_solve_batched_fused(f, x0s, Q, R, QF, x_goal, horizon, **kwargs)


def _fused_backward(As, Bs, xs, us, Q, R, QF, x_goal, reg, lu_pen=None, luu_pen=None):
    """K7 on the batch: the affine terms formed here, as the JAX package
    forms them (ilqr.py:236-242)."""
    T = us.shape[-2]
    lxs = 2.0 * (xs[:, :T] - x_goal) @ Q.T
    lus = 2.0 * us @ R.T
    if lu_pen is not None:
        lus = lus + lu_pen
    lxT = 2.0 * (xs[:, T] - x_goal) @ QF.T
    return ilqr_backward_fused(As, Bs, lxs, lus, 2.0 * Q, 2.0 * R, lxT, 2.0 * QF, reg=reg,
                               luu_diags=luu_pen)


def _line_search(f, forward: str, x0s, xs, us, ks, Ks, alpha, Q, R, QF, x_goal):
    """(us_all, xs_all, quadratic costs_a) of every alpha: K8 or the plain
    batched rollout."""
    if forward == "kernel":
        return ilqr_forward_fused(f, Q, R, QF, x_goal, alpha.reshape(-1), x0s, xs, us, ks, Ks)
    us_all, xs_all = _forward_pass(f, x0s, xs, us, ks, Ks, alpha)
    return us_all, xs_all, _total_cost(xs_all, us_all, Q, R, QF, x_goal)


def _forward_route(forward: str) -> str:
    """The line search's route, "kernel" or "plain"; the JAX package's
    "pallas" is "kernel" and its "xla" "plain" (ilqr.py:207-245)."""
    forward = {"pallas": "kernel", "xla": "plain"}.get(forward, forward)
    if forward not in ("kernel", "plain"):
        raise ValueError(f"unknown forward {forward!r} (kernel|plain|pallas|xla)")
    return forward


def _ilqr_solve_batched_fused(
    f, x0s, Q, R, QF, x_goal, horizon: int, iters: int = 20, reg: float = 1e-3,
    use_fd: bool = False, fd_eps: float = 1e-4, us_init=None,
    alphas: Tuple[float, ...] = ALPHAS, forward: str = "kernel",
) -> ILQRResult:
    """The fused backend: K7 for the backward pass; forward="kernel" rolls
    out ALL line-search alphas for all scenarios in one K8 launch (the plant
    must be registered, models/plants.kernel_plant), "plain" in batched
    PyTorch. Assumes symmetric Q/QF, as K8's cost does."""
    forward = _forward_route(forward)
    Q, R, QF, x_goal = (_as(a, x0s) for a in (Q, R, QF, x_goal))
    N, m, T = x0s.shape[0], R.shape[0], horizon
    us = _init_controls(us_init, (N, T, m), x0s)
    xs = rollout_nonlinear(f, x0s, us)
    cost = _total_cost(xs, us, Q, R, QF, x_goal)
    alpha = _as(alphas, x0s).reshape(-1, 1, 1)
    backward = functools.partial(_fused_backward, Q=Q, R=R, QF=QF, x_goal=x_goal, reg=reg)
    costs = []
    for _ in range(iters):
        As, Bs = linearize_trajectory(f, xs, us, use_fd=use_fd, eps=fd_eps)
        ks, Ks = backward(As, Bs, xs, us)
        us_all, xs_all, costs_a = _line_search(f, forward, x0s, xs, us, ks, Ks, alpha,
                                               Q, R, QF, x_goal)
        xs, us, cost = _select(costs_a, us_all, xs_all, xs, us, cost)
        costs.append(cost)
    return ILQRResult(us=us, xs=xs, cost=cost, costs=torch.stack(costs, dim=-1))
