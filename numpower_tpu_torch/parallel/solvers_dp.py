"""Data-parallel AL-iLQR and MHE on torch.distributed (port of
numpower_tpu/parallel/solvers_dp.py).

Both families are scenario (window) parallel with no coupling between
blocks, so what a rank runs is the single-device batched solver on its block,
and the only collective is the sweep statistic every rank returns: the
global worst constraint violation or residual, an all_reduce MAX over the
data axis (JAX's ``pmax``). The convention is parallel/sharding.py's: a rank
takes its block of the scenarios or windows with the model replicated and
returns its block of the result and the replicated global worst value.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from numpower_tpu_torch.models.al_ilqr import al_ilqr_solve_batched
from numpower_tpu_torch.models.mhe import mhe_solve
from numpower_tpu_torch.parallel.mesh import Mesh
from numpower_tpu_torch.parallel.sharding import _all_reduce
from numpower_tpu_torch.utils.device import state_tensor


def al_ilqr_solve_dp(f, x0s, Q, R, QF, x_goal, horizon: int, u_lo, u_hi,
                     mesh: Mesh, backend: str = "vmap", **kwargs):
    """Scenario-DP AL-iLQR: this rank's block x0s (N_local, n) of the
    scenarios over the data axis through models/al_ilqr.al_ilqr_solve_batched
    (backend="fused": one K7 launch per backward pass and one K8 launch per
    line search on the rank's card). Returns (this rank's ALILQRResult, the
    global worst constraint violation, MAX over the data axis)."""
    res = al_ilqr_solve_batched(f, state_tensor(x0s), Q, R, QF, x_goal, horizon, u_lo, u_hi,
                                backend=backend, **kwargs)
    worst = _all_reduce(res.max_violation.max().clone(), dist.ReduceOp.MAX, mesh,
                        mesh.axis_names[0])
    return res, worst


def mhe_solve_dp(A, C, Q, R, P0, x_priors, yss, mesh: Mesh, B=None, uss=None, x_lo=None,
                 x_hi=None, iters: int = 100):
    """Window-DP moving-horizon estimation: this rank's block of the windows
    (x_priors (N_local, n), yss (N_local, M, p)[, uss (N_local, M, m)])
    through the batched models/mhe.mhe_solve. Returns (this rank's MHEResult,
    the global max primal residual, MAX over the data axis: the sweep's
    convergence certificate).

    Without uss the inputs are zeros of B's width (one column, with a zero
    B, where B is None too), as the JAX package fabricates them."""
    x_priors = state_tensor(x_priors)
    dt, dev = x_priors.dtype, x_priors.device
    yss = torch.as_tensor(yss, dtype=dt, device=dev)
    if uss is None:
        m = 1 if B is None else torch.as_tensor(B).shape[1]
        uss = torch.zeros(yss.shape[:2] + (m,), dtype=dt, device=dev)
        if B is None:
            B = torch.zeros((torch.as_tensor(A).shape[0], 1), dtype=dt, device=dev)
    res = mhe_solve(A, C, Q, R, P0, x_priors, yss, B=B, us=uss, x_lo=x_lo, x_hi=x_hi,
                    iters=iters)
    worst = _all_reduce(res.primal_residual.max().clone(), dist.ReduceOp.MAX, mesh,
                        mesh.axis_names[0])
    return res, worst
