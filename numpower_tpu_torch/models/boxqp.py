"""Box-constrained QP solvers: projected gradient and FISTA (port of
numpower_tpu/models/boxqp.py).

BASELINE config #4: quadrotor 12-state trajopt, 4096 scenarios,
box-constrained QP:

    U <- clip(U - (1/L) (U H' + g), lo, hi)        [PG]
    plus Nesterov momentum with adaptive restart    [FISTA]

solve_boxqp_pg and solve_boxqp_fista are plain PyTorch, the counterpart of the
JAX package's XLA scan path. solve_mpc_boxqp routes a solve on a CUDA tensor
to the FISTA kernels (kernels/boxqp_fista.py): the fused one for a batch of
regulation problems, the two-step one for an x_ref or a single x0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from numpower_tpu_torch.kernels import boxqp_fista
from numpower_tpu_torch.kernels.precision import bf16_round
from numpower_tpu_torch.models.condensed import (
    CondensedQP, default_coarse_iters, gradient_offset,
)
from numpower_tpu_torch.utils.device import follow, state_tensor

class BoxQPResult(NamedTuple):
    U: torch.Tensor         # (N, Tm) or (Tm,) solutions
    iterations: int         # iterations executed
    residual: torch.Tensor  # max projected-gradient residual across batch


def _product(U: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """U H' for a batch (N, d) of rows, H U for one vector (d,)."""
    return U @ H.T if U.ndim == 2 else H @ U


def _step_size(H: torch.Tensor, L):
    return 1.0 / (torch.linalg.matrix_norm(H, ord=2) if L is None else L)


def solve_boxqp_pg(H, g, lo, hi, L=None, iters: int = 60, U0=None) -> BoxQPResult:
    """Plain projected gradient with fixed step 1/L. g may be batched (N, d);
    a numpy g goes to the card as float32 (utils.state_tensor), and H and U0
    follow g's device and dtype."""
    g = state_tensor(g)
    H, U0 = follow(g, H, U0)
    step = _step_size(H, L)
    U = torch.zeros_like(g) if U0 is None else U0
    for _ in range(iters):
        U = torch.clamp(U - step * (_product(U, H) + g), lo, hi)
    grad = _product(U, H) + g
    resid = torch.abs(U - torch.clamp(U - step * grad, lo, hi)).max()
    return BoxQPResult(U=U, iterations=iters, residual=resid)


def solve_boxqp_fista(H, g, lo, hi, L=None, iters: int = 40, U0=None,
                      coarse_iters: int = 0) -> BoxQPResult:
    """FISTA (accelerated PG) with gradient-based adaptive restart.

    coarse_iters > 0 runs that many leading iterations with both operands of
    the product rounded to bf16 (accumulating in fp32); the remaining
    iterations run in fp32 and contract to the same fixed point, after a
    momentum restart at the switch. A numpy g goes to the card as float32
    (utils.state_tensor); H and U0 follow g's device and dtype.
    """
    g = state_tensor(g)
    H, U0 = follow(g, H, U0)
    step = _step_size(H, L)
    H_coarse = bf16_round(H)
    U = torch.zeros_like(g) if U0 is None else U0
    Y = U
    t = torch.ones((), dtype=g.dtype, device=g.device)
    coarse_iters = min(coarse_iters, iters)
    for k in range(iters):
        if k == coarse_iters and k > 0:
            # restart momentum at the precision switch
            Y, t = U, torch.ones_like(t)
        coarse = k < coarse_iters
        gemm = _product(bf16_round(Y), H_coarse) if coarse else _product(Y, H)
        grad = gemm + g
        U_new = torch.clamp(Y - step * grad, lo, hi)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        beta = (t - 1.0) / t_new
        # Adaptive restart (per scenario): if momentum points uphill, reset.
        dU = U_new - U
        uphill = torch.sum(grad * dU, dim=-1, keepdim=True) > 0
        Y = U_new + torch.where(uphill, 0.0, beta) * dU
        t = torch.where(uphill.any(), 1.0, t_new)
        U = U_new
    grad = _product(U, H) + g
    resid = torch.abs(U - torch.clamp(U - step * grad, lo, hi)).max()
    return BoxQPResult(U=U, iterations=iters, residual=resid)


def route_mpc_boxqp(device_type: str, d: int, has_x_ref: bool, x0_ndim: int,
                    method: str = "auto") -> str:
    """The solver solve_mpc_boxqp runs: "kernel", "fista" or "pg".

    "auto" takes the fused FISTA kernel for a tensor on a CUDA device with
    d <= boxqp_fista.MAX_D = 1024, the JAX package's rule on the TPU
    ("pallas" if on_tpu and d <= 1024, boxqp.py:156-161; up to d = 128 one
    block a scenario tile, past it a cluster of blocks, csrc/boxqp_tile.cuh),
    and plain FISTA otherwise: on the CPU, as the JAX package does off the
    TPU, and above d = 1024, as it does above its VMEM bound. The rule does
    not look at the state dimension n, and need not: the fused kernels form
    g from x0 for any n, as the JAX kernels do (csrc/boxqp_tile.cuh sums the
    fold in chunks of 32 rows). On the kernel route, solve_mpc_boxqp takes
    the fused kernel for a batch of regulation problems and the two-step one
    (g given) for an x_ref or a single x0, as the JAX package does
    (boxqp.py:162-197); has_x_ref and x0_ndim choose between the two there,
    not here.

    The JAX package's names are taken too: "pallas" is "kernel", and "xla"
    is "pg", as its solve_mpc_boxqp runs projected gradient for every name
    but "pallas" and "fista" (boxqp.py:198-203)."""
    del has_x_ref, x0_ndim  # both kernel routes take every x_ref and x0 rank
    method = {"pallas": "kernel", "xla": "pg"}.get(method, method)
    if method == "auto":
        method = "kernel" if device_type == "cuda" and d <= boxqp_fista.MAX_D else "fista"
    if method not in ("kernel", "fista", "pg"):
        raise ValueError(f"unknown method {method!r} (auto|kernel|fista|pg|pallas|xla)")
    return method


def solve_mpc_boxqp(
    qp: CondensedQP,
    x0s: torch.Tensor,
    u_lo: float,
    u_hi: float,
    x_ref: Optional[torch.Tensor] = None,
    iters: int = 40,
    method: str = "auto",
    U0: Optional[torch.Tensor] = None,
    coarse_iters: Optional[int] = None,
) -> BoxQPResult:
    """Batched-scenario MPC solve on a condensed QP.

    x0s (N, n) initial states -> controls (N, T*m) clipped to [u_lo, u_hi].
    H is shared; only g varies per scenario. U0 warm-starts the iterate
    (shifted previous solution in receding-horizon use).

    method (see route_mpc_boxqp): "kernel" (the JAX package's "pallas") is
    static-beta FISTA in a kernel: for a batch x0s (N, n) with no x_ref the
    fused kernel, with g formed from x0 and the residual reduced in the
    kernel; otherwise g is formed here, the two-step kernel solves it (a
    single x0 as a batch of one) and the residual is formed outside. "fista"
    is plain FISTA with adaptive restart, "pg" plain projected gradient.

    Precision: the leading coarse_iters iterations round the product's
    operands to bf16; the fp32 tail of ceil(6.5 sqrt(kappa)) iterations
    (condensed.default_coarse_iters) contracts to the fp32 fixed point. Pass
    coarse_iters=0 for all-fp32.

    x0s, x_ref and U0 may be numpy arrays: they are taken in the QP's dtype
    on its device.
    """
    return _solve_mpc_boxqp(qp, x0s, u_lo, u_hi, x_ref, iters, method, U0, coarse_iters)


def _solve_mpc_boxqp(qp: CondensedQP, x0s, u_lo: float, u_hi: float, x_ref, iters: int,
                     method: str, U0, coarse_iters: Optional[int],
                     folds: Optional[tuple] = None) -> BoxQPResult:
    """solve_mpc_boxqp with the kernels' QP-only operands given: ``folds``
    from kernels/boxqp_fista._fista_folds (formed per call when None). The
    serving tick (models/mpc.MPCController) forms them once."""
    x0s = state_tensor(x0s, qp.H)
    x_ref, U0 = follow(qp.H, x_ref, U0)
    if coarse_iters is None:
        coarse_iters = default_coarse_iters(qp, iters)
    method = route_mpc_boxqp(x0s.device.type, qp.H.shape[0], x_ref is not None,
                             x0s.ndim, method)
    if method == "kernel" and x_ref is None and x0s.ndim == 2:
        U, resid = boxqp_fista._fista_mpc_res(
            qp.H, qp.Sx.T, qp.SuTQ.T, x0s, u_lo, u_hi, qp.lipschitz, iters, coarse_iters, U0,
            "highest", "highest", folds)
        return BoxQPResult(U=U, iterations=iters, residual=resid)
    g = gradient_offset(qp, x0s, x_ref)
    if method == "kernel":
        squeeze = g.ndim == 1
        U = boxqp_fista._fista_boxqp(
            qp.H, g[None] if squeeze else g, u_lo, u_hi, qp.lipschitz, iters, coarse_iters,
            None if U0 is None else (U0[None] if squeeze else U0), folds)
        if squeeze:
            U = U[0]
        step = 1.0 / qp.lipschitz
        resid = torch.abs(U - torch.clamp(U - step * (_product(U, qp.H) + g), u_lo, u_hi)).max()
        return BoxQPResult(U=U, iterations=iters, residual=resid)
    if method == "fista":
        return solve_boxqp_fista(qp.H, g, u_lo, u_hi, L=qp.lipschitz, iters=iters,
                                 U0=U0, coarse_iters=coarse_iters)
    return solve_boxqp_pg(qp.H, g, u_lo, u_hi, L=qp.lipschitz, iters=iters, U0=U0)
