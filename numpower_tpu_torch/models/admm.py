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
problems, the two-step one for an x_ref.

The general-constraint OSQP solver (solve_qp_osqp) and condensed MPC with
state bounds on top of it (solve_mpc_state_constrained) are plain PyTorch,
as the JAX package computes them outside any kernel: one dense factorization
shared across the batch and all iterations, and per iteration three dense
products.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from numpower_tpu_torch.kernels import boxqp_admm
from numpower_tpu_torch.models.condensed import (
    CondensedQP, admm_coarse_iters, gradient_offset,
)
from numpower_tpu_torch.utils.device import follow, state_tensor

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
    A numpy g goes to the card as float32 (utils.state_tensor); H and U0
    follow g's device and dtype.
    """
    g = state_tensor(g)
    H, U0 = follow(g, H, U0)
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
    with d <= boxqp_admm.MAX_D = 1024, the JAX package's rule on the TPU
    ("pallas" if on_tpu and d <= 1024 and x0s.ndim == 2, admm.py:134-136),
    and plain ADMM otherwise, as that rule does off the TPU or above d =
    1024; with or without an x_ref, and for any state dimension n (the fused
    kernel forms c from x0 for any n, as the JAX kernel does). On the kernel
    route,
    solve_mpc_boxqp_admm takes the fused kernel for a batch of regulation
    problems and the two-step one (g given) for an x_ref, or for a single x0
    asked for by method="kernel", as the JAX package does (admm.py:149-179).
    The JAX package's names are taken too: "pallas" is "kernel", "xla"
    "plain" (admm.py:134-137)."""
    del has_x_ref  # both kernel routes take an x_ref
    method = {"pallas": "kernel", "xla": "plain"}.get(method, method)
    if method == "auto":
        on_cuda = device_type == "cuda"
        method = "kernel" if on_cuda and d <= boxqp_admm.MAX_D and x0_ndim == 2 else "plain"
    if method not in ("kernel", "plain"):
        raise ValueError(f"unknown method {method!r} (auto|kernel|plain|pallas|xla)")
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
    plain route runs all-fp32, as the JAX scan path does. x0s, x_ref and U0
    may be numpy arrays: they are taken in the QP's dtype on its device."""
    return _solve_mpc_boxqp_admm(qp, x0s, u_lo, u_hi, x_ref, rho, iters, U0, method,
                                 coarse_iters)


def _default_rho(qp: CondensedQP) -> torch.Tensor:
    """sqrt(lipschitz * max(mu, 1e-12)), the geometric mean of the QP's
    eigenvalue bounds: the ADMM solvers' rho where none is given."""
    return torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))


def _kernel_folds(qp: CondensedQP, rho) -> tuple:
    """(Minv, folds) of the ADMM kernel route for one QP and rho, as
    solve_mpc_boxqp_admm forms them on every call: Minv = (H + rho I)^{-1}
    and the fused kernel's ((rho Minv)', Wc) (kernels/boxqp_admm._admm_folds).
    The serving tick (models/mpc.MPCController) forms them once."""
    Minv = boxqp_admm.minv_factor(qp.H, rho)
    return Minv, boxqp_admm._admm_folds(qp.H, qp.Sx.T, qp.SuTQ.T, rho, Minv)


def _solve_mpc_boxqp_admm(qp: CondensedQP, x0s, u_lo: float, u_hi: float, x_ref, rho,
                          iters: int, U0, method: str, coarse_iters: Optional[int],
                          prepared: Optional[tuple] = None) -> ADMMResult:
    """solve_mpc_boxqp_admm with the kernel route's QP-only operands given:
    ``prepared`` = (Minv, folds) of :func:`_kernel_folds` for this rho (formed
    per call when None)."""
    x0s = state_tensor(x0s, qp.H)
    x_ref, U0 = follow(qp.H, x_ref, U0)
    if rho is None:
        rho = _default_rho(qp)
    method = route_mpc_boxqp_admm(x0s.device.type, qp.H.shape[0], x_ref is not None,
                                  x0s.ndim, method)
    if method == "kernel":
        if coarse_iters is None:
            coarse_iters = admm_coarse_iters(qp, iters)
        # one factorization, shared by the kernel and the residuals
        Minv, folds = (boxqp_admm.minv_factor(qp.H, rho), None) if prepared is None else prepared
        if x_ref is None and x0s.ndim == 2:
            z, r_prim, r_dual = boxqp_admm._admm_mpc_res(
                qp.H, qp.Sx.T, qp.SuTQ.T, x0s, u_lo, u_hi, rho, iters, coarse_iters, OVER_RELAX,
                Minv, U0, "s", "highest", folds)
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


class OSQPResult(NamedTuple):
    U: torch.Tensor                # (N, d) or (d,) primal solutions
    Z: torch.Tensor                # (N, m_c) or (m_c,) constraint-space iterate (feasible)
    iterations: int
    primal_residual: torch.Tensor  # max ||A x - z||_inf across batch
    dual_residual: torch.Tensor    # max ||H x + g + A'y||_inf (stationarity)


def _osqp(H, g, A, l, u, rho, sigma: float, iters: int, over_relax: float):
    """The OSQP iterations on g (..., d) and bounds l, u broadcasting against
    (..., m_c). Returns x, z, y and the per-problem residuals (...)."""
    d = H.shape[0]
    eye = torch.eye(d, dtype=g.dtype, device=g.device)
    K = H + sigma * eye + rho * (A.T @ A)
    Lc = torch.linalg.cholesky(0.5 * (K + K.T))
    Linv = torch.linalg.solve_triangular(Lc, eye, upper=False)
    Kinv = Linv.T @ Linv  # explicit, as the JAX package forms it
    shape_z = g.shape[:-1] + (A.shape[0],)
    z = torch.clamp(torch.zeros(shape_z, dtype=g.dtype, device=g.device), l, u)
    y = torch.zeros(shape_z, dtype=g.dtype, device=g.device)
    x = torch.zeros_like(g)
    for _ in range(iters):
        rhs = sigma * x - g + (rho * z - y) @ A
        x = rhs @ Kinv.T
        ax = x @ A.T
        ax_r = over_relax * ax + (1.0 - over_relax) * z
        z_new = torch.clamp(ax_r + y / rho, l, u)
        y = y + rho * (ax_r - z_new)
        z = z_new
    r_prim = torch.amax(torch.abs(x @ A.T - z), dim=-1)
    r_dual = torch.amax(torch.abs(x @ H.T + g + y @ A), dim=-1)
    return x, z, y, r_prim, r_dual


def _bound(b, like):
    """A bound (a float, an array or a tensor) as a tensor of like's dtype on
    its device."""
    return torch.as_tensor(b, dtype=like.dtype, device=like.device)


def solve_qp_osqp(
    H,
    g,
    A,
    l,
    u,
    rho=1.0,
    sigma: float = 1e-6,
    iters: int = 50,
    over_relax: float = OVER_RELAX,
) -> OSQPResult:
    """General-constraint QP via the OSQP splitting:

        min 1/2 U'HU + g'U   s.t.  l <= A U <= u

    x-update solves (H + sigma I + rho A'A) x = sigma x - g + A'(rho z - y):
    one dense factorization shared across the batch and all iterations; per
    iteration three dense products ((N, d) x (d, d), (N, d) x (d, m_c),
    (N, m_c) x (m_c, d)). z projects onto [l, u] in constraint space; y is
    the constraint-space dual. l/u/g may be batched (N, .). g may be a numpy
    array (then float32 on the card, utils.state_tensor); H, A and the bounds
    follow g's device and dtype."""
    g = state_tensor(g)
    H, A = (torch.as_tensor(M, dtype=g.dtype, device=g.device) for M in (H, A))
    x, z, _, r_prim, r_dual = _osqp(H, g, A, _bound(l, g), _bound(u, g), rho, sigma, iters,
                                    over_relax)
    return OSQPResult(U=x, Z=z, iterations=iters, primal_residual=r_prim.max(),
                      dual_residual=r_dual.max())


def solve_mpc_state_constrained(
    qp: CondensedQP,
    x0s,
    u_lo: float,
    u_hi: float,
    x_lo,
    x_hi,
    x_ref: Optional[torch.Tensor] = None,
    rho=None,
    iters: int = 60,
) -> OSQPResult:
    """Condensed MPC with BOTH control and state box constraints:

        u_lo <= u_t <= u_hi,   x_lo <= x_t <= x_hi  (t = 1..T)

    Stacked as l <= [I; Su] U <= u with the state rows shifted per scenario
    by Sx x0 (X = Sx x0 + Su U). x_lo/x_hi may be scalars or (n,) per-state
    vectors. x0s (N, n) or (n,) is taken in the QP's dtype on its device.
    Returns the OSQP iterate; check primal_residual before trusting tight
    state constraints (they can be infeasible for aggressive x0)."""
    x0s = torch.as_tensor(x0s, dtype=qp.H.dtype, device=qp.H.device)
    g = gradient_offset(qp, x0s, x_ref)
    if rho is None:
        rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    d = qp.H.shape[0]
    A = torch.cat([torch.eye(d, dtype=qp.H.dtype, device=qp.H.device), qp.Su], dim=0)
    sx_x0 = x0s @ qp.Sx.T  # (N, T n) or (T n,)
    xl, xh = (torch.as_tensor(b, dtype=qp.H.dtype, device=qp.H.device).expand(qp.n).repeat(qp.T)
              for b in (x_lo, x_hi))
    shape_u = g.shape[:-1] + (d,)
    l = torch.cat([torch.full(shape_u, u_lo, dtype=qp.H.dtype, device=qp.H.device),
                   xl - sx_x0], dim=-1)
    u = torch.cat([torch.full(shape_u, u_hi, dtype=qp.H.dtype, device=qp.H.device),
                   xh - sx_x0], dim=-1)
    return solve_qp_osqp(qp.H, g, A, l, u, rho=rho, iters=iters)
