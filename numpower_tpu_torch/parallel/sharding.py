"""Sharded MPC solvers on torch.distributed (port of
numpower_tpu/parallel/sharding.py).

Each function is what one rank runs: the body that every device runs under
the JAX package's ``shard_map``. It takes this rank's block of the scenario
batch (parallel/mesh.shard_batch: x0s, U0, measurements) with the QP or the
model replicated, and returns this rank's block of the solution together
with the GLOBAL residuals and sums, which every rank holds after an
all_reduce over the mesh's axis groups (JAX's ``pmax``/``psum`` are
all_reduce MAX/SUM here):

 - DP (data axis): scenarios sharded; each rank solves its block with the
   replicated condensed H. Collectives only for the residuals and sweep
   statistics.
 - TP (model axis): solve_mpc_boxqp_dp_tp's plain route shards H by columns;
   every iteration sums the partial products over the model group.

method follows the port's names (models/boxqp.route_mpc_boxqp): "kernel" is
the JAX package's "pallas", the fused box-QP kernel per rank (K2 FISTA, K1
ADMM), and "plain" its "xla" scan; either name is taken. "auto" takes the kernel for a mesh of
CUDA devices with d <= MAX_D = 1024, the JAX package's rule on a TPU mesh
(sharding.py:41-50), and the plain scan otherwise; on a CUDA tensor the kernel route launches its kernel
or raises. On a CPU mesh the kernel route runs the kernel's plain version,
as the JAX package runs its kernel in interpret mode there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
from numpower_tpu_torch.kernels._build import MAX_D
from numpower_tpu_torch.models.admm import OVER_RELAX, ADMMResult
from numpower_tpu_torch.models.boxqp import BoxQPResult
from numpower_tpu_torch.models.condensed import (
    CondensedQP, admm_coarse_iters, default_coarse_iters,
)
from numpower_tpu_torch.models.estimation import (
    KalmanResult, kalman_filter_batched, kalman_smoother_batched,
)
from numpower_tpu_torch.parallel.mesh import Mesh
from numpower_tpu_torch.utils.device import follow, state_tensor


def _all_reduce(t: torch.Tensor, op, mesh: Mesh, axes) -> torch.Tensor:
    """t reduced by ``op`` over the ranks along ``axes``, in place."""
    dist.all_reduce(t, op=op, group=mesh.group(axes))
    return t


def _pick_method(qp: CondensedQP, mesh: Mesh, method: str) -> str:
    """The route of a DP solver: "kernel" or "plain" (see the module note);
    the JAX package's "pallas" is "kernel", its "xla" "plain"
    (sharding.py:41-49, 186-193). "auto" takes the kernels (K2', K1' on each
    rank) on a CUDA mesh for d <= MAX_D and any state dimension n, as the
    JAX rule does."""
    method = {"pallas": "kernel", "xla": "plain"}.get(method, method)
    if method == "auto":
        return "kernel" if mesh.device.type == "cuda" and qp.H.shape[0] <= MAX_D else "plain"
    if method not in ("kernel", "plain"):
        raise ValueError(f"unknown method {method!r} (auto|kernel|plain|pallas|xla)")
    return method


def _block_operands(qp: CondensedQP, x0s, U0):
    """x0s and U0 (None stays None: the kernels start cold from a null U0),
    a numpy block taken in the QP's dtype on its device."""
    x0s = state_tensor(x0s, qp.H)
    (U0,) = follow(qp.H, U0)
    return x0s, U0


def _zeros_if_none(U0, x0s, d: int):
    return torch.zeros((x0s.shape[0], d), dtype=x0s.dtype, device=x0s.device) if U0 is None else U0


def _fista_restart(H, g, step, u_lo, u_hi, U, iters: int, grad_of=None):
    """The plain DP scan: FISTA with the per-scenario uphill restart of the
    JAX package's scan body (sharding.py:88-109), t never reset. grad_of(Y)
    is Y @ H' + g unless given (the TP route's summed partial products).
    Returns (U, the local max projected-gradient residual)."""
    if grad_of is None:
        def grad_of(Y):
            return Y @ H.T + g
    Y = U
    t = torch.ones((), dtype=g.dtype, device=g.device)
    for _ in range(iters):
        grad = grad_of(Y)
        U_new = torch.clamp(Y - step * grad, u_lo, u_hi)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        beta = (t - 1.0) / t_new
        dU = U_new - U
        uphill = torch.sum(grad * dU, dim=-1, keepdim=True) > 0
        Y = U_new + torch.where(uphill, 0.0, beta) * dU
        U, t = U_new, t_new
    grad = grad_of(U)
    return U, torch.abs(U - torch.clamp(U - step * grad, u_lo, u_hi)).max()


def solve_mpc_boxqp_dp(qp: CondensedQP, x0s, u_lo: float, u_hi: float, mesh: Mesh,
                       iters: int = 40, method: str = "auto", coarse_iters=None,
                       U0=None) -> BoxQPResult:
    """Data-parallel batched box-QP: this rank's block x0s (N_local, n) of
    the scenarios over the data axis, H/Sx/SuTQ replicated, U0 the block of
    the warm start (zeros when None). Returns this rank's block of U and the
    global residual (MAX over the data axis).

    "kernel" runs the fused FISTA kernel K2 (kernels/boxqp_fista.fista_mpc_res,
    g formed in the kernel, the default bf16 + fp32 schedule unless
    coarse_iters is given) once on the block; "plain" the all-fp32 scan of
    FISTA with the per-scenario uphill restart."""
    x0s, U0 = _block_operands(qp, x0s, U0)
    if _pick_method(qp, mesh, method) == "kernel":
        return _dp_kernel(qp, x0s, u_lo, u_hi, mesh, iters, coarse_iters, U0,
                          (mesh.axis_names[0],))
    g = x0s @ qp.Sx.T @ qp.SuTQ.T
    U, resid = _fista_restart(qp.H, g, 1.0 / qp.lipschitz, u_lo, u_hi,
                              _zeros_if_none(U0, x0s, qp.H.shape[0]), iters)
    resid = _all_reduce(resid, dist.ReduceOp.MAX, mesh, mesh.axis_names[0])
    return BoxQPResult(U=U, iterations=iters, residual=resid)


def _dp_kernel(qp, x0s, u_lo, u_hi, mesh, iters, coarse_iters, U0, axes) -> BoxQPResult:
    """K2 on this rank's block, the residual reduced over ``axes``."""
    if coarse_iters is None:
        coarse_iters = default_coarse_iters(qp, iters)
    U, resid = boxqp_fista.fista_mpc_res(qp.H, qp.Sx.T, qp.SuTQ.T, x0s, u_lo, u_hi,
                                         qp.lipschitz, iters=iters, coarse_iters=coarse_iters,
                                         U0=None if U0 is None else U0.contiguous())
    resid = _all_reduce(resid, dist.ReduceOp.MAX, mesh, axes)
    return BoxQPResult(U=U, iterations=iters, residual=resid)


def solve_mpc_boxqp_dp_tp(qp: CondensedQP, x0s, u_lo: float, u_hi: float, mesh: Mesh,
                          iters: int = 40, method: str = "auto",
                          coarse_iters=None) -> BoxQPResult:
    """2-D sharded box-QP from a cold start: this rank's block x0s of the
    scenarios over the data axis (the same on every rank of its model
    group); returns this rank's data block of U and the global residual.

    "plain" shards H by column blocks over the model axis: each iteration
    forms the partial product Y[:, cols] @ H[:, cols]' of this rank's block
    of columns and sums it over the model group (the QP block reduction of
    BASELINE config #5). d must divide by the model axis.

    "kernel" keeps H whole and shards the scenarios over BOTH axes, as the
    JAX package does when H fits the kernel: each rank of the model group
    solves its contiguous part of the data block with K2, and the parts are
    gathered over the model group, so every rank returns its data block."""
    x0s = state_tensor(x0s, qp.H)
    data_ax, model_ax = mesh.axis_names
    if _pick_method(qp, mesh, method) == "kernel":
        parts = mesh.size(model_ax)
        if x0s.shape[0] % parts:
            raise ValueError(f"a data block of {x0s.shape[0]} scenarios does not split into "
                             f"{parts} parts over the model axis")
        rows = x0s.shape[0] // parts
        mine = slice(mesh.coords[1] * rows, (mesh.coords[1] + 1) * rows)
        res = _dp_kernel(qp, x0s[mine].contiguous(), u_lo, u_hi, mesh, iters, coarse_iters,
                         None, mesh.axis_names)
        blocks = [torch.empty_like(res.U) for _ in range(parts)]
        dist.all_gather(blocks, res.U, group=mesh.group(model_ax))
        return BoxQPResult(U=torch.cat(blocks), iterations=iters, residual=res.residual)
    d, parts = qp.H.shape[0], mesh.size(model_ax)
    if d % parts:
        raise ValueError(f"d = {d} does not split into {parts} column blocks")
    cols = slice(mesh.coords[1] * (d // parts), (mesh.coords[1] + 1) * (d // parts))
    H_cols = qp.H[:, cols]
    g = x0s @ qp.Sx.T @ qp.SuTQ.T

    def grad_of(Y):
        partial = Y[:, cols] @ H_cols.T
        return _all_reduce(partial, dist.ReduceOp.SUM, mesh, model_ax) + g

    U, resid = _fista_restart(qp.H, g, 1.0 / qp.lipschitz, u_lo, u_hi, torch.zeros_like(g),
                              iters, grad_of)
    resid = _all_reduce(resid, dist.ReduceOp.MAX, mesh, data_ax)
    return BoxQPResult(U=U, iterations=iters, residual=resid)


def sweep_statistics_dp(xs_scenarios, mesh: Mesh):
    """Cross-scenario tube statistics with data-axis collectives: this
    rank's block (N_local, T, n) -> (mean trajectory (T, n), max deviation
    (T,)), both global and held by every rank."""
    xs = torch.as_tensor(xs_scenarios, device=mesh.device,
                         dtype=None if isinstance(xs_scenarios, torch.Tensor) else torch.float32)
    data_ax = mesh.axis_names[0]
    n_total = _all_reduce(torch.tensor(float(xs.shape[0]), dtype=xs.dtype, device=xs.device),
                          dist.ReduceOp.SUM, mesh, data_ax)
    mean = _all_reduce(xs.sum(dim=0), dist.ReduceOp.SUM, mesh, data_ax) / n_total
    dev = torch.linalg.vector_norm(xs - mean[None], dim=-1).amax(dim=0)
    return mean, _all_reduce(dev, dist.ReduceOp.MAX, mesh, data_ax)


def solve_mpc_boxqp_admm_dp(qp: CondensedQP, x0s, u_lo: float, u_hi: float, mesh: Mesh,
                            rho=None, iters: int = 40, method: str = "auto",
                            coarse_iters=None, U0=None) -> ADMMResult:
    """Data-parallel ADMM box-QP: this rank's block x0s of the scenarios over
    the data axis, U0 the block of the warm start of z (clipped; zeros when
    None). The factorization Minv = (H + rho I)^{-1} is formed once per rank
    and shared by the block's scenarios and iterations. Returns this rank's
    block of z and the global residuals (MAX over the data axis).

    "kernel" runs the fused ADMM kernel K1 (kernels/boxqp_admm.admm_mpc_res,
    the default schedule of models/condensed.admm_coarse_iters unless
    coarse_iters is given) once on the block; "plain" the all-fp32 (z, y)
    scan of models/admm.solve_boxqp_admm."""
    x0s, U0 = _block_operands(qp, x0s, U0)
    data_ax = mesh.axis_names[0]
    if rho is None:
        rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    Minv = boxqp_admm.minv_factor(qp.H, rho)
    if _pick_method(qp, mesh, method) == "kernel":
        if coarse_iters is None:
            coarse_iters = admm_coarse_iters(qp, iters)
        z, rp, rd = boxqp_admm.admm_mpc_res(qp.H, qp.Sx.T, qp.SuTQ.T, x0s, u_lo, u_hi, rho,
                                            iters=iters, coarse_iters=coarse_iters,
                                            over_relax=OVER_RELAX, Minv=Minv,
                                            U0=None if U0 is None else U0.contiguous())
    else:
        g = x0s @ qp.Sx.T @ qp.SuTQ.T
        z = torch.clamp(_zeros_if_none(U0, x0s, qp.H.shape[0]), u_lo, u_hi)
        y = torch.zeros_like(g)
        for _ in range(iters):
            x = (rho * (z - y) - g) @ Minv.T
            x_r = OVER_RELAX * x + (1.0 - OVER_RELAX) * z
            z_new = torch.clamp(x_r + y, u_lo, u_hi)
            y = y + x_r - z_new
            z = z_new
        x = (rho * (z - y) - g) @ Minv.T
        rp = torch.abs(x - z).max()
        z_next = torch.clamp(OVER_RELAX * x + (1.0 - OVER_RELAX) * z + y, u_lo, u_hi)
        rd = rho * torch.abs(z_next - z).max()
    rp, rd = _all_reduce(torch.stack([rp, rd]), dist.ReduceOp.MAX, mesh, data_ax)  # one collective
    return ADMMResult(U=z, iterations=iters, primal_residual=rp, dual_residual=rd)


def kalman_filter_batched_dp(A, C, Q, R, x0s, P0, yss, mesh: Mesh):
    """Data-parallel batched Kalman filtering: this rank's block of the
    trajectories (x0s (N_local, n), yss (N_local, T, p)) through
    models/estimation.kalman_filter_batched (its route_batched: the K9 kernel
    for float32 on the card). Returns this rank's KalmanResult and the
    GLOBAL summed log-likelihood (SUM over the data axis), the quantity a
    sweep maximizes."""
    res = kalman_filter_batched(A, C, Q, R, x0s, P0, yss)
    total_ll = _all_reduce(res.log_likelihood.sum(), dist.ReduceOp.SUM, mesh,
                           mesh.axis_names[0])
    return res, total_ll


def kalman_smoother_batched_dp(A, filt: KalmanResult, mesh: Mesh):
    """Data-parallel batched RTS smoother over kalman_filter_batched_dp's
    block: the backward mean pass is local to the block
    (models/estimation.kalman_smoother_batched: the K10 kernel for float32 on
    the card), so no collective is needed."""
    del mesh  # the block's pass needs no collective
    return kalman_smoother_batched(A, filt)
