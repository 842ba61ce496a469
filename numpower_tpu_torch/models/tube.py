"""Tube MPC scenario sweep (port of numpower_tpu/models/tube.py, one
device).

BASELINE config #5: tube MPC = a nominal trajectory from the condensed box-QP
plus an ancillary LQR feedback K holding each disturbed scenario inside a
tube around the nominal. The steps:
 1. nominal box-QP solve for the nominal x0 (plain FISTA, one vector)
 2. ancillary infinite-horizon LQR gain K (computed once)
 3. per-scenario disturbed closed-loop rollouts (one batch dimension)
 4. tube statistics (max deviation per stage, bound violation)

The multi-GPU split of the sweep waits for the port of numpower_tpu/parallel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from numpower_tpu_torch.models.boxqp import solve_boxqp_fista
from numpower_tpu_torch.models.condensed import CondensedQP, gradient_offset
from numpower_tpu_torch.models.lqr import lqr_infinite_gain


class TubeMPCResult(NamedTuple):
    U_nominal: torch.Tensor      # (T*m,) nominal optimal controls
    xs_nominal: torch.Tensor     # (T+1, n) nominal trajectory
    xs_scenarios: torch.Tensor   # (N, T+1, n) disturbed closed-loop trajectories
    tube_radius: torch.Tensor    # (T+1,) max cross-scenario deviation per stage
    max_violation: torch.Tensor  # scalar: max control-bound violation after feedback clip


def tube_mpc_solve(
    qp: CondensedQP,
    A,
    B,
    Q,
    R,
    x0_nominal: torch.Tensor,
    disturbances: torch.Tensor,  # (N, T, n) additive per-scenario disturbances
    u_lo: float,
    u_hi: float,
    x_ref: Optional[torch.Tensor] = None,
    qp_iters: int = 40,
) -> TubeMPCResult:
    """A, B, Q, R, x0_nominal and disturbances may be numpy arrays or
    tensors; they are taken in the QP's dtype on its device."""
    T, m = qp.T, qp.m
    A, B, Q, R, x0_nominal, disturbances = (
        torch.as_tensor(x, dtype=qp.H.dtype, device=qp.H.device)
        for x in (A, B, Q, R, x0_nominal, disturbances))

    # 1. nominal solve (single-scenario condensed QP) and rollout
    g = gradient_offset(qp, x0_nominal, x_ref)
    U_nom = solve_boxqp_fista(qp.H, g, u_lo, u_hi, L=qp.lipschitz, iters=qp_iters).U
    us_nom = U_nom.reshape(T, m)
    xs = [x0_nominal]
    for t in range(T):
        xs.append(A @ xs[-1] + B @ us_nom[t])
    xs_nom = torch.stack(xs)

    # 2. ancillary feedback gain (disturbance rejection around the tube)
    K_anc, _ = lqr_infinite_gain(A, B, Q, R)

    # 3. disturbed closed-loop rollouts, all scenarios at once
    N = disturbances.shape[0]
    x = x0_nominal.expand(N, -1)
    xs_all, us_all = [x], []
    for t in range(T):
        u = torch.clamp(us_nom[t] - (x - xs_nom[t]) @ K_anc.T, u_lo, u_hi)
        x = x @ A.T + u @ B.T + disturbances[:, t]
        xs_all.append(x)
        us_all.append(u)
    xs_all = torch.stack(xs_all, dim=1)  # (N, T+1, n)
    us_all = torch.stack(us_all, dim=1)  # (N, T, m)

    # 4. tube statistics: cross-scenario reductions
    dev = torch.linalg.vector_norm(xs_all - xs_nom[None], dim=-1)  # (N, T+1)
    tube_radius = dev.max(dim=0).values
    max_violation = torch.maximum(us_all.max() - u_hi, u_lo - us_all.min())
    return TubeMPCResult(U_nominal=U_nom, xs_nominal=xs_nom, xs_scenarios=xs_all,
                         tube_radius=tube_radius, max_violation=max_violation)
