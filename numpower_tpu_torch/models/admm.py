"""ADMM box-QP solver (port of numpower_tpu/models/admm.py, box part).

ADMM's x-update is an EXACT linear solve against the prefactored matrix
(H + rho I), so its convergence rate is condition-number independent:

    x^{k+1} = (H + rho I)^{-1} (rho (z^k - y^k) - g)     [prefactored solve]
    z^{k+1} = clip(x^{k+1} + y^k, lo, hi)                [projection]
    y^{k+1} = y^k + x^{k+1} - z^{k+1}                    [dual ascent]

One factorization of (H + rho I) is shared across the scenario batch and all
iterations (H is scenario-independent for condensed MPC), and each x-update
is a dense product against the precomputed inverse. Both residuals (primal
||x - z||_inf, dual rho*||z - z_prev||_inf) are returned. solve_boxqp_admm is
plain PyTorch; solve_mpc_boxqp_admm routes a batched solve on a CUDA tensor to
the ADMM kernels (kernels/boxqp_admm.py): the fused one for regulation
problems, the two-step one for an x_ref. The general-constraint OSQP
solver of the JAX module is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from numpower_tpu_torch.kernels import boxqp_admm
from numpower_tpu_torch.models.condensed import (
    CondensedQP, admm_coarse_iters, gradient_offset,
)

OVER_RELAX = 1.6


class ADMMResult(NamedTuple):
    U: torch.Tensor                # (N, d) or (d,) solutions (the feasible z iterate)
    iterations: int                # iterations executed
    primal_residual: torch.Tensor  # max ||x - z||_inf across batch
    dual_residual: torch.Tensor    # max rho*||z - z_prev||_inf across batch


def solve_boxqp_admm(
    H: torch.Tensor,
    g: torch.Tensor,
    lo,
    hi,
    rho=1.0,
    iters: int = 30,
    U0: Optional[torch.Tensor] = None,
    over_relax: float = OVER_RELAX,
) -> ADMMResult:
    """min 1/2 U'HU + g'U  s.t. lo <= U <= hi, via ADMM splitting.

    g may be batched (N, d): the factorization is shared, the solves are
    batched products. over_relax in [1, 1.8] is the standard alpha
    relaxation (1.6 per the OSQP recommendation). Cold start z0 = clip(0).
    """
    Minv = boxqp_admm.minv_factor(H, rho)

    def x_update(z, y):
        rhs = rho * (z - y) - g
        return rhs @ Minv.T if g.ndim == 2 else Minv @ rhs

    z = torch.clamp(torch.zeros_like(g) if U0 is None else U0, lo, hi)
    y = torch.zeros_like(g)
    for _ in range(iters):
        x_r = over_relax * x_update(z, y) + (1.0 - over_relax) * z
        z_new = torch.clamp(x_r + y, lo, hi)
        y = y + x_r - z_new
        z = z_new
    # one extra x-update to measure residuals at the final iterate
    x = x_update(z, y)
    r_prim = torch.abs(x - z).max()
    z_next = torch.clamp(over_relax * x + (1.0 - over_relax) * z + y, lo, hi)
    r_dual = rho * torch.abs(z_next - z).max()
    return ADMMResult(U=z, iterations=iters, primal_residual=r_prim,
                      dual_residual=r_dual)


def route_mpc_boxqp_admm(device_type: str, d: int, has_x_ref: bool, x0_ndim: int,
                         method: str = "auto") -> str:
    """The solver solve_mpc_boxqp_admm runs: "kernel" or "plain".

    "auto" takes the fused ADMM kernel for a batch of x0 on a CUDA device
    whose d fits the kernel's shared-memory envelope
    (d <= boxqp_admm.MAX_D = 128), and plain ADMM otherwise, as the JAX
    package's auto rule does off the TPU or above its VMEM bound
    (admm.py:134-136); with or without an x_ref. On the kernel route,
    solve_mpc_boxqp_admm takes the fused kernel for a batch of regulation
    problems and the two-step one (g given) for an x_ref, or for a single x0
    asked for by method="kernel", as the JAX package does (admm.py:149-179)."""
    del has_x_ref  # both kernel routes take an x_ref
    if method == "auto":
        on_cuda = device_type == "cuda"
        method = "kernel" if on_cuda and d <= boxqp_admm.MAX_D and x0_ndim == 2 else "plain"
    if method not in ("kernel", "plain"):
        raise ValueError(f"unknown method {method!r} (auto|kernel|plain)")
    return method


def solve_mpc_boxqp_admm(
    qp: CondensedQP,
    x0s: torch.Tensor,
    u_lo: float,
    u_hi: float,
    x_ref: Optional[torch.Tensor] = None,
    rho=None,
    iters: int = 30,
    U0: Optional[torch.Tensor] = None,
    method: str = "auto",
    coarse_iters: Optional[int] = None,
) -> ADMMResult:
    """Batched-scenario condensed-MPC solve via ADMM (drop-in alternative to
    models/boxqp.solve_mpc_boxqp). rho defaults to sqrt(lipschitz * max(mu,
    1e-12)), the geometric mean of the eigenvalue bounds.

    method (see route_mpc_boxqp_admm): "kernel" (the JAX package's "pallas")
    is the s-form iteration in a kernel: for a batch x0s (N, n) with no x_ref
    the fused kernel, with c formed from x0 and both residuals reduced in the
    kernel; otherwise g is formed here, the two-step kernel returns (z, y)
    (a single x0 as a batch of one) and the residuals come from one more
    x-update outside. "plain" is the PyTorch iteration (its "xla").
    On the kernel route coarse_iters defaults to condensed.admm_coarse_iters
    (fp32 tail max(8, ceil(3 sqrt(kappa)))): leading x-update products round
    their operands to bf16 and the tail washes the perturbation out. The
    plain route runs all-fp32, as the JAX scan path does."""
    if rho is None:
        rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    method = route_mpc_boxqp_admm(x0s.device.type, qp.H.shape[0], x_ref is not None,
                                  x0s.ndim, method)
    if method == "kernel":
        if coarse_iters is None:
            coarse_iters = admm_coarse_iters(qp, iters)
        # one factorization, shared by the kernel and the residuals
        Minv = boxqp_admm.minv_factor(qp.H, rho)
        if x_ref is None and x0s.ndim == 2:
            z, r_prim, r_dual = boxqp_admm.admm_mpc_res(
                qp.H, qp.Sx.T, qp.SuTQ.T, x0s, u_lo, u_hi, rho, iters=iters,
                coarse_iters=coarse_iters, over_relax=OVER_RELAX, Minv=Minv, U0=U0)
            return ADMMResult(U=z, iterations=iters, primal_residual=r_prim,
                              dual_residual=r_dual)
        g = gradient_offset(qp, x0s, x_ref)
        squeeze = g.ndim == 1
        z, y = boxqp_admm.admm_boxqp(
            qp.H, g[None] if squeeze else g, u_lo, u_hi, rho, iters=iters,
            coarse_iters=coarse_iters, over_relax=OVER_RELAX,
            U0=None if U0 is None else (U0[None] if squeeze else U0), Minv=Minv)
        if squeeze:
            z, y = z[0], y[0]
        # exact residuals from one more x-update at the final (z, y), the
        # over-relaxed formulas of solve_boxqp_admm
        rhs = rho * (z - y) - g
        x = rhs @ Minv.T if g.ndim == 2 else Minv @ rhs
        r_prim = torch.abs(x - z).max()
        z_next = torch.clamp(OVER_RELAX * x + (1.0 - OVER_RELAX) * z + y, u_lo, u_hi)
        r_dual = rho * torch.abs(z_next - z).max()
        return ADMMResult(U=z, iterations=iters, primal_residual=r_prim,
                          dual_residual=r_dual)
    g = gradient_offset(qp, x0s, x_ref)
    return solve_boxqp_admm(qp.H, g, u_lo, u_hi, rho=rho, iters=iters, U0=U0)
