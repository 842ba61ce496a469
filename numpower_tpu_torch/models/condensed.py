"""Condensed QP formation for linear MPC (port of
numpower_tpu/models/condensed.py).

Eliminates states to produce a dense QP over the stacked control sequence
U = [u_0; ...; u_{T-1}] (dimension T*m):

    X = Sx x0 + Su U
    J(U) = 1/2 U' H U + (g(x0))' U + const
    H = Su' Qbar Su + Rbar          (shared across scenarios for LTI plants)
    g(x0) = Su' Qbar (Sx x0 - Xref)

H is scenario-independent, so a 4096-scenario solve is iterations whose core
op is one (N, T*m) x (T*m, T*m) product; for the quadrotor at T=30 that is
(4096, 120) @ (120, 120).
"""

from __future__ import annotations

import math
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from numpower_tpu_torch.utils.device import default_device, follow, state_tensor


@dataclass(frozen=True)
class CondensedQP:
    """Dense condensed QP data. H (Tm, Tm); Sx (Tn, n); Su (Tn, Tm);
    SuTQ (Tm, Tn) caches Su' Qbar for fast g(x0) formation; lipschitz and mu
    are 0-d tensors on the same device. Frozen, as the JAX package's
    flax.struct.dataclass: a changed QP is a new one, made by
    :meth:`replace`.

    kappa = lipschitz / mu is read back to a Python float once, at condense()
    time, so the mixed-precision schedules below are plain integers and the
    solve path never waits on the device for them."""

    H: torch.Tensor
    Sx: torch.Tensor
    Su: torch.Tensor
    SuTQ: torch.Tensor
    lipschitz: torch.Tensor  # largest eigenvalue of H (PG step size 1/L)
    mu: torch.Tensor  # strong-convexity lower bound: lam_min(R) <= lam_min(H)
    T: int
    n: int
    m: int
    kappa: Optional[float] = None

    def replace(self, **changes) -> "CondensedQP":
        """A copy with the named fields changed (dataclasses.replace)."""
        return dataclasses.replace(self, **changes)


def prediction_matrices(A: torch.Tensor, B: torch.Tensor, horizon: int):
    """Sx = [A; A^2; ...; A^T], Su lower-block-triangular with blocks
    A^{i-j-1} B. A numpy A goes to the card as float32 (utils.state_tensor);
    B follows A's device and dtype."""
    A = state_tensor(A)
    (B,) = follow(A, B)
    n, m = A.shape[0], B.shape[1]
    T = horizon
    A_pows = [torch.eye(n, dtype=A.dtype, device=A.device)]  # A_pows[k] = A^k
    for _ in range(T):
        A_pows.append(A @ A_pows[-1])
    Sx = torch.cat(A_pows[1:], dim=0)  # (T n, n)
    AB = [Ak @ B for Ak in A_pows]  # AB[k] = A^k B
    zeros = torch.zeros((n, m), dtype=A.dtype, device=A.device)
    rows = [torch.cat([AB[i - j] if i >= j else zeros for j in range(T)], dim=1)
            for i in range(T)]
    Su = torch.cat(rows, dim=0)  # (T n, T m)
    return Sx, Su


def _power_iteration_lmax(H: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Largest eigenvalue of symmetric PSD H by power iteration (fixed step
    count, in H's dtype)."""
    d = H.shape[0]
    v = torch.ones(d, dtype=H.dtype, device=H.device) / math.sqrt(d)
    for _ in range(iters):
        w = H @ v
        v = w / (torch.linalg.vector_norm(w) + 1e-30)
    return v @ (H @ v)


def _as_float32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=device)


def condense(A, B, Q, R, QF, horizon: int, *, device=None) -> CondensedQP:
    """Form the condensed QP for an LTI plant with stage costs
    sum_{t=1..T} x_t' Qt x_t + sum_t u_t' R u_t (Qt = Q for t<T, QF at T).

    Inputs may be numpy arrays or tensors; they become fp32 tensors on
    ``device`` (default: A's device if A is a tensor, else the card,
    utils.default_device)."""
    if device is None:
        device = A.device if isinstance(A, torch.Tensor) else default_device()
    A, B, Q, R, QF = (_as_float32(x, device) for x in (A, B, Q, R, QF))
    n, m = A.shape[0], B.shape[1]
    T = horizon
    Sx, Su = prediction_matrices(A, B, T)
    Qbar = torch.block_diag(*([Q] * (T - 1) + [QF]))
    Rbar = torch.block_diag(*([R] * T))
    SuTQ = Su.T @ Qbar
    H = SuTQ @ Su + Rbar
    H = 0.5 * (H + H.T)
    lmax = _power_iteration_lmax(H)
    # H = Su' Qbar Su + Rbar >= Rbar, so lam_min(H) >= lam_min(R): a cheap,
    # usually-tight strong-convexity bound (m is tiny).
    mu = torch.linalg.eigvalsh(0.5 * (R + R.T))[0].to(H.dtype)
    kappa = max(float(lmax) / max(float(mu), 1e-12), 1.0)
    return CondensedQP(H=H, Sx=Sx, Su=Su, SuTQ=SuTQ, lipschitz=lmax, mu=mu,
                       T=T, n=n, m=m, kappa=kappa)


def condensed_from_jax(arrays: dict, *, T: int, n: int, m: int,
                       kappa: Optional[float], device) -> CondensedQP:
    """The port's CondensedQP from the JAX CondensedQP's fields read out as
    numpy (keys H, Sx, Su, SuTQ, lipschitz, mu), value for value, so that both
    packages can solve the identical QP."""
    fields = {k: torch.as_tensor(np.array(arrays[k]), device=device)
              for k in ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")}
    return CondensedQP(**fields, T=T, n=n, m=m, kappa=kappa)


def _resolve_kappa(qp: CondensedQP) -> float:
    if qp.kappa is not None:
        return qp.kappa
    return max(float(qp.lipschitz) / max(float(qp.mu), 1e-12), 1.0)


def default_coarse_iters(qp: CondensedQP, iters: int) -> int:
    """Static bf16-coarse iteration count for mixed-precision FISTA.

    The fp32 tail must contract the bf16 fixed-point offset (~bf16_eps *
    kappa relative) below the 1e-4 parity bound; with FISTA's linear rate
    (1 - 1/sqrt(kappa)) that takes O(sqrt(kappa)) iterations:
    tail = max(12, ceil(6.5 sqrt(kappa))), the calibration of the JAX
    package (13 on the quadrotor flagship, kappa ~3.6).
    """
    tail = max(12, math.ceil(6.5 * math.sqrt(_resolve_kappa(qp))))
    return max(0, iters - tail)


def admm_coarse_iters(qp: CondensedQP, iters: int) -> int:
    """Static bf16-coarse iteration count for mixed-precision ADMM.

    Exact-solve over-relaxed ADMM contracts at ~(sqrt(kappa)-1)/(sqrt(kappa)+1)
    per iteration, so the fp32 tail that washes out the bf16 offset grows as
    O(sqrt(kappa)): tail = max(8, ceil(3 sqrt(kappa))), the calibration of the
    JAX package (8 on the flagship).
    """
    tail = max(8, math.ceil(3.0 * math.sqrt(_resolve_kappa(qp))))
    return max(0, iters - tail)


def gradient_offset(qp: CondensedQP, x0: torch.Tensor,
                    x_ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g(x0) = Su' Qbar (Sx x0 - Xref); x0 (n,) or batched (N, n). x_ref is
    one state (n,), held over the horizon, or a (T, n) trajectory. A numpy x0
    or x_ref is taken in the QP's dtype on its device."""
    x0 = state_tensor(x0, qp.H)
    (x_ref,) = follow(qp.H, x_ref)
    xref_stack = None
    if x_ref is not None:
        xref_stack = x_ref.repeat(qp.T) if x_ref.ndim == 1 else x_ref.reshape(-1)
    if x0.ndim == 2:
        target = x0 @ qp.Sx.T  # (N, Tn)
        if xref_stack is not None:
            target = target - xref_stack
        return target @ qp.SuTQ.T  # (N, Tm)
    target = qp.Sx @ x0
    if xref_stack is not None:
        target = target - xref_stack
    return qp.SuTQ @ target
