"""Finite-horizon LQR via Riccati recursion (port of
numpower_tpu/models/lqr.py).

BASELINE configs #1 (double-integrator LQR) and #2 (batched 256-scenario LTI
Riccati), and the per-scenario Riccati of tube/robust MPC. Two horizon
engines:
 - ``riccati_scan``          sequential O(T) loop (default; T = 30 is cheap)
 - ``riccati_associative``   parallel-in-time O(log T) depth, an associative
                             scan over conditional-value-function elements

Inputs may be tensors or numpy arrays; every function computes in the dtype
and on the device of its first matrix argument (A, or As), a numpy one on the
card (utils.default_device), so pass CPU tensors to run on the CPU. The small SPD
solves run unrolled (utils/smallmat.py); on a CUDA device each of their
lines is a kernel launch, so the sequential engines here are bound by launch
overhead. ``riccati_scan_per_scenario`` routes its batched backward pass to
the fused Riccati kernel (kernels/riccati.py) on a CUDA device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from numpower_tpu_torch.kernels import cholesky, riccati
from numpower_tpu_torch.utils.associative_scan import associative_scan
from numpower_tpu_torch.utils.device import default_device, follow, state_tensor
from numpower_tpu_torch.utils.smallmat import lu_solve_nopivot, psd_solve_unrolled, solve_small


def _tensors(first, *rest):
    """``first`` as a tensor (a numpy one on the card, utils.default_device)
    and ``rest`` as tensors of its dtype on its device."""
    if not isinstance(first, torch.Tensor):
        first = torch.as_tensor(np.asarray(first), device=default_device())
    return (first,) + tuple(torch.as_tensor(x, dtype=first.dtype, device=first.device)
                            for x in rest)


def _psd_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve M x = rhs with M symmetric PD via Cholesky and two triangular
    solves: unrolled (utils/smallmat.psd_solve_unrolled) for n <= 16,
    torch.linalg.cholesky + torch.cholesky_solve above that."""
    if M.shape[-1] <= 16:
        return psd_solve_unrolled(M, rhs)
    L = torch.linalg.cholesky(M)
    if rhs.ndim == M.ndim - 1:
        return torch.cholesky_solve(rhs[..., None], L)[..., 0]
    return torch.cholesky_solve(rhs, L)


def _stack(seq, like: torch.Tensor, empty_shape, dim: int = 0) -> torch.Tensor:
    """torch.stack(seq, dim), or for an empty seq (a zero-length horizon) an
    empty tensor of `empty_shape` in like's dtype and device, as the JAX
    package's scans return."""
    if seq:
        return torch.stack(seq, dim=dim)
    return like.new_empty(empty_shape)


def riccati_scan(A, B, Q, R, QF, horizon: int):
    """Backward Riccati recursion.

    Returns (Ks, Ps): Ks (T, m, n) feedback gains u_t = -K_t x_t;
    Ps (T+1, n, n) cost-to-go Hessians with Ps[0] = P_0, Ps[T] = QF.
    """
    A, B, Q, R, QF = _tensors(A, B, Q, R, QF)
    Ks, Ps = [None] * horizon, [None] * horizon + [QF]
    P = QF
    for t in range(horizon - 1, -1, -1):
        BtP = B.T @ P
        K = _psd_solve(R + BtP @ B, BtP @ A)
        AtP = A.T @ P
        P = Q + AtP @ A - (BtP @ A).T @ K
        P = 0.5 * (P + P.T)  # keep symmetric under fp32 accumulation
        Ks[t], Ps[t] = K, P
    return _stack(Ks, A, (0,) + B.T.shape), torch.stack(Ps)


class _RiccatiElement(NamedTuple):
    """Conditional value-function element (F, C, J): the suffix Bellman map
    P -> J + F' P (I + C P)^{-1} F, closed under composition."""

    F: torch.Tensor
    C: torch.Tensor
    J: torch.Tensor


def _combine(ei: _RiccatiElement, ej: _RiccatiElement, solve=None) -> _RiccatiElement:
    """Associative combine of element i (earlier stage) with element j (later
    stage block), the regulation case of the parallel LQT elements.

    solve: small-matrix solver for the (I + C_i J_j) denominator; default the
    implicit-pivot unrolled LU (utils/smallmat.solve_small). Pass
    lu_solve_nopivot only for a combine chain known to be well-conditioned
    (see its docstring)."""
    n = ei.F.shape[-1]
    eye = torch.eye(n, dtype=ei.F.dtype, device=ei.F.device)
    if solve is None:
        solve = solve_small
    M = solve(eye + ei.C @ ej.J, torch.cat([ei.F, ei.C], dim=-1))
    MF, MC = M[..., :n], M[..., n:]
    F = ej.F @ MF
    C = ej.F @ MC @ ej.F.transpose(-1, -2) + ej.C
    # (I + J_j C_i)^{-1} J_j F_i == J_j (I + C_i J_j)^{-1} F_i = J_j @ MF
    J = ei.F.transpose(-1, -2) @ ej.J @ MF + ei.J
    J = 0.5 * (J + J.transpose(-1, -2))
    C = 0.5 * (C + C.transpose(-1, -2))
    return _RiccatiElement(F, C, J)


def riccati_associative(A, B, Q, R, QF, horizon: int, nopivot: bool = False):
    """Parallel-in-time Riccati: O(log T) depth associative scan.

    Produces the same (Ks, Ps) as riccati_scan (fp32 tolerance). nopivot=True
    solves the combine denominators with the unpivoted unrolled LU
    (utils/smallmat.lu_solve_nopivot): an opt-in for well-conditioned
    problems, such as the quadrotor; the default is the pivoted solver, which
    handles any invertible denominator."""
    A, B, Q, R, QF = _tensors(A, B, Q, R, QF)
    n = A.shape[-1]
    solve = lu_solve_nopivot if nopivot else None
    # Stage element: F = A, C = B R^{-1} B', J = Q. Terminal element: (0, 0, QF).
    C_stage = B @ _psd_solve(R, B.T)
    zero = torch.zeros((1, n, n), dtype=A.dtype, device=A.device)
    elems = (torch.cat([A.expand(horizon, n, n), zero]),
             torch.cat([C_stage.expand(horizon, n, n), zero]),
             torch.cat([Q.expand(horizon, n, n), QF[None]]))
    # Reverse scan: suffix composition from each stage to T. As in JAX, with
    # reverse=True the combine is called as fn(later, earlier).
    _, _, Ps = associative_scan(
        lambda later, earlier: _combine(_RiccatiElement(*earlier), _RiccatiElement(*later),
                                        solve=solve),
        elems, reverse=True)
    BtP = B.T @ Ps[1:]  # (T, m, n); Ps[t] = cost-to-go from stage t
    Ks = _psd_solve(R + BtP @ B, BtP @ A)
    return Ks, Ps


def lqt_solve(A, B, Q, R, QF, x0, x_refs, horizon: int):
    """Finite-horizon LQ TRACKING (affine Riccati): drive the state along
    x_refs ((T+1, n): stage references r_1..r_T at indices 1..T; index 0
    unused) minimizing
        sum_t (x_t - r_t)' Q (x_t - r_t) + u_t' R u_t  +  (x_T - r_T)' QF (x_T - r_T).

    Backward pass carries (P_t, p_t) with u* = -K_t x - k_t:
        S   = R + B' P B
        K   = S^{-1} B' P A,     k = S^{-1} B' p
        P'  = Q + A'PA - (B'PA)' K
        p'  = -Q r_t + (A - BK)' (p - P B k) + K' R k

    Returns (us (T, m), xs (T+1, n))."""
    A, B, Q, R, QF, x0, x_refs = _tensors(A, B, Q, R, QF, x0, x_refs)
    P, p = QF, -(QF @ x_refs[-1])
    Ks, ks = [None] * horizon, [None] * horizon
    # step t computes the gains (K_t, k_t) from the carried (P, p), THEN folds
    # in the stage cost at t with r_t (r_0 only shifts V_0 by a constant)
    for t in range(horizon - 1, -1, -1):
        BtP = B.T @ P
        S = R + BtP @ B
        L = torch.linalg.cholesky(0.5 * (S + S.T))
        K = torch.cholesky_solve(BtP @ A, L)
        k = torch.cholesky_solve((B.T @ p)[:, None], L)[:, 0]
        Acl = A - B @ K
        P_new = Q + A.T @ P @ A - (BtP @ A).T @ K
        p = -(Q @ x_refs[t]) + Acl.T @ (p - P @ (B @ k)) + K.T @ (R @ k)
        P = 0.5 * (P_new + P_new.T)
        Ks[t], ks[t] = K, k
    us, xs = [], [x0]
    for K, k in zip(Ks, ks):
        u = -(K @ xs[-1]) - k
        us.append(u)
        xs.append(A @ xs[-1] + B @ u)
    return _stack(us, x0, (0, B.shape[1])), torch.stack(xs)


def lqr_infinite_gain(A, B, Q, R, iters: int = 200):
    """Infinite-horizon discrete LQR gain by Riccati fixed-point iteration
    (a fixed iteration count). Returns (K (m, n), P (n, n))."""
    A, B, Q, R = _tensors(A, B, Q, R)
    P = Q
    for _ in range(iters):
        BtP = B.T @ P
        K = _psd_solve(R + BtP @ B, BtP @ A)
        P_new = Q + A.T @ P @ (A - B @ K)
        P = 0.5 * (P_new + P_new.T)
    BtP = B.T @ P
    K = _psd_solve(R + BtP @ B, BtP @ A)
    return K, P


def lqr_solve(A, B, Q, R, QF, x0, horizon: int, parallel: bool = False):
    """Full LQR solve: backward Riccati + forward rollout.

    Returns (us, xs): optimal controls (T, m) and trajectory (T+1, n).
    BASELINE config #1 is this on the double integrator at horizon 30.
    """
    A, B, Q, R, QF, x0 = _tensors(A, B, Q, R, QF, x0)
    Ks, _ = (riccati_associative if parallel else riccati_scan)(A, B, Q, R, QF, horizon)
    us, xs = [], [x0]
    for K in Ks:
        u = -(K @ xs[-1])
        us.append(u)
        xs.append(A @ xs[-1] + B @ u)
    return _stack(us, x0, (0, B.shape[1])), torch.stack(xs)


def route_riccati_per_scenario(device_type: str, n: int, m: int, method: str = "auto") -> str:
    """The route riccati_scan_per_scenario takes: "fused", "psd" or "plain".

    "auto" takes the fused Riccati kernel (the JAX package's "fused") for a
    tensor on a CUDA device whose (n, m) lies inside its envelope
    (n <= riccati.MAX_N = 48, m <= riccati.MAX_M = 48: the narrow form to
    n = 16, m = 8, the wide form past it), and "plain" otherwise, as the JAX
    package takes "fused" on the TPU for n <= 48 and "xla" elsewhere
    (lqr.py:261-265). "psd" (the JAX package's "pallas") keeps the batched
    products plain and sends each step's (m, m) SPD solve against n columns
    to the batched-solve kernel (m <= cholesky.MAX_DIM = 48, n <=
    cholesky.MAX_RHS = 48). An explicit "fused" or "psd" outside its kernel's
    envelope raises ValueError, as does any other name. The JAX package's
    names are taken too: "pallas" is "psd", "xla" "plain" (lqr.py:261-276)."""
    fused_ok = n <= riccati.MAX_N and m <= riccati.MAX_M
    method = {"pallas": "psd", "xla": "plain"}.get(method, method)
    if method == "auto":
        return "fused" if device_type == "cuda" and fused_ok else "plain"
    if method not in ("fused", "psd", "plain"):
        raise ValueError(f"unknown method {method!r} (auto|fused|psd|plain|pallas|xla)")
    if method == "fused" and not fused_ok:
        raise ValueError(f"(n, m) = ({n}, {m}) is outside the fused kernel's envelope "
                         f"(n <= {riccati.MAX_N}, m <= {riccati.MAX_M})")
    if method == "psd" and not (m <= cholesky.MAX_DIM and n <= cholesky.MAX_RHS):
        raise ValueError(f"(n, m) = ({n}, {m}) is outside the batched-solve kernel's envelope "
                         f"(m <= {cholesky.MAX_DIM}, n <= {cholesky.MAX_RHS})")
    return method


def riccati_scan_per_scenario(As, Bs, Q, R, QF, horizon: int, method: str = "auto"):
    """Backward Riccati for a BATCH of scenario-specific LTI systems:
    As (N, n, n), Bs (N, n, m) -> Ks (N, T, m, n), P0 (N, n, n).

    The per-scenario path of tube/robust MPC with per-scenario models. Routes
    (route_riccati_per_scenario): "fused" is one launch of the fused Riccati
    kernel for the whole backward pass; "psd" runs the batched products in
    plain PyTorch and each step's (N, m, m) SPD solve as one launch of the
    batched-solve kernel; "plain" is plain PyTorch throughout (unrolled
    solves). On a CPU tensor each kernel wrapper runs its plain version.
    Numpy As go to the card as float32 (utils.state_tensor); Bs, Q, R and QF
    follow As's device and dtype."""
    As = state_tensor(As)
    Bs, Q, R, QF = follow(As, Bs, Q, R, QF)
    N, n, _ = As.shape
    m = Bs.shape[-1]
    method = route_riccati_per_scenario(As.device.type, n, m, method)
    if method == "fused":
        return riccati.riccati_batched_fused(As, Bs, Q, R, QF, horizon)
    spd_solve = cholesky.psd_solve_batched if method == "psd" else _psd_solve
    return riccati.riccati_batched_reference(As, Bs, Q, R, QF, horizon, spd_solve=spd_solve)


def lqr_solve_batched(A, B, Q, R, QF, x0s, horizon: int):
    """BASELINE config #2: batched scenarios share one backward pass (K_t is
    scenario-independent for LTI plants), so the backward Riccati runs ONCE
    and the forward rollout is batched over the scenarios.

    x0s (N, n) -> (us (N, T, m), xs (N, T+1, n))."""
    A, B, Q, R, QF, x0s = _tensors(A, B, Q, R, QF, x0s)
    Ks, _ = riccati_scan(A, B, Q, R, QF, horizon)
    us, xs = [], [x0s]
    for K in Ks:
        u = -(xs[-1] @ K.T)
        us.append(u)
        xs.append(xs[-1] @ A.T + u @ B.T)
    return _stack(us, x0s, (x0s.shape[0], 0, B.shape[1]), dim=1), torch.stack(xs, dim=1)
