"""State estimation: Kalman filter, RTS smoother, square-root, EKF and UKF
(port of numpower_tpu/models/estimation.py).

The estimation side of the MPC loop (measure -> estimate -> solve -> act).
Every filter is a Python loop over the horizon whose steps are batched tensor
operations; innovations are whitened with a Cholesky solve (no explicit
inverse), covariances are symmetrized each step, and the log-likelihood
accumulates per trajectory.

Batch shapes. The single-trajectory filters (kalman_filter, kalman_smoother,
kalman_filter_sqrt, ekf_filter, ukf_filter) also take leading batch
dimensions on the state and the data (x0 (..., n), ys (..., T, p), us
(..., T, m); A, C, Q, R, P0 shared): that is the JAX package's vmap, and the
plain ("xla") route of the batched filters.

Devices. Every function computes in the dtype and on the device of its
state argument (x0 or x0s); the matrices are moved there. A numpy state is
put on the card (utils.default_device), so pass CPU tensors to run on the CPU.

Kernels. The batched filters route their batched recurrences to the
hand-written kernels (route_batched below): the shared-gain mean passes to K9
(kernels/kalman_mean.py) and K10 (kernels/rts_mean.py), the whole EKF and UKF
to K11 (kernels/ekf.py) and K12 (kernels/ukf.py). On a CPU tensor each
wrapper runs its plain PyTorch version. The kernels take float32: "auto"
routes any other dtype to the plain ("xla") route.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from numpower_tpu_torch.kernels import ekf as ekf_kernel
from numpower_tpu_torch.kernels import kalman_mean, rts_mean
from numpower_tpu_torch.kernels import ukf as ukf_kernel
from numpower_tpu_torch.models.rollout import linearize  # noqa: F401  (the JAX module's name)
from numpower_tpu_torch.utils.associative_scan import associative_scan
from numpower_tpu_torch.utils.device import default_device
from numpower_tpu_torch.utils.smallmat import (
    cholesky_unrolled, lu_solve_nopivot, solve_small, tri_solve_unrolled,
)

LOG_2PI = math.log(2.0 * math.pi)


class KalmanResult(NamedTuple):
    means: torch.Tensor           # (..., T, n) filtered means x_{t|t}
    covs: torch.Tensor            # (..., T, n, n) filtered covariances P_{t|t}
    pred_means: torch.Tensor      # (..., T, n) one-step predictions x_{t|t-1}
    pred_covs: torch.Tensor       # (..., T, n, n) prediction covariances P_{t|t-1}
    log_likelihood: torch.Tensor  # (...) sum of innovation log-densities


class SmootherResult(NamedTuple):
    means: torch.Tensor  # (..., T, n) smoothed means x_{t|T}
    covs: torch.Tensor   # (..., T, n, n) smoothed covariances


class SqrtKalmanResult(NamedTuple):
    means: torch.Tensor            # (..., T, n) filtered means
    chol_covs: torch.Tensor        # (..., T, n, n) lower-triangular S with P = S S'
    pred_means: torch.Tensor       # (..., T, n) one-step predictions
    pred_chol_covs: torch.Tensor   # (..., T, n, n) lower S_p with P_p = S_p S_p'
    log_likelihood: torch.Tensor   # (...)


def _tensors(state, *rest):
    """``state`` as a tensor (a numpy one on the card) and ``rest`` as tensors
    of its dtype on its device; None stays None."""
    if not isinstance(state, torch.Tensor):
        state = torch.as_tensor(np.asarray(state), device=default_device())
    return (state,) + tuple(
        None if x is None else torch.as_tensor(x, dtype=state.dtype, device=state.device)
        for x in rest)


def _mT(M):
    return M.transpose(-1, -2)


def _sym(M):
    return 0.5 * (M + _mT(M))


def _mv(M, v):
    """Batch-safe matrix-vector product M (..., r, c) v (..., c) -> (..., r)."""
    return (M @ v[..., None])[..., 0]


def _chol(S):
    """Cholesky: the unrolled recurrence (utils/smallmat.py) for n <= 16,
    torch.linalg.cholesky above."""
    if S.shape[-1] <= 16:
        return cholesky_unrolled(S)
    return torch.linalg.cholesky(S)


def _trisolve(L, rhs, lower=True):
    if L.shape[-1] <= 16:
        return tri_solve_unrolled(L, rhs, lower=lower)
    if rhs.ndim == L.ndim - 1:
        return torch.linalg.solve_triangular(L, rhs[..., None], upper=not lower)[..., 0]
    return torch.linalg.solve_triangular(L, rhs, upper=not lower)


def _chosolve(L, rhs):
    """(L L')^{-1} rhs given the lower Cholesky factor L."""
    if L.shape[-1] <= 16:
        return _trisolve(_mT(L), _trisolve(L, rhs, lower=True), lower=False)
    if rhs.ndim == L.ndim - 1:
        return torch.cholesky_solve(rhs[..., None], L)[..., 0]
    return torch.cholesky_solve(rhs, L)


def _log_density(alpha, L):
    """Innovation log-density -1/2 (|alpha|^2 + p log 2pi) - log det L."""
    p = alpha.shape[-1]
    return (-0.5 * ((alpha * alpha).sum(-1) + p * LOG_2PI)
            - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))


def _filter_step(A, C, Q, R, x, P, y, u_term):
    """One predict+update, batched over the leading dims of x (..., n), P
    (..., n, n), y (..., p), u_term (..., n). Returns (x_f, P_f, x_p, P_p, ll)."""
    x_p = x @ A.T + u_term
    P_p = _sym(A @ P @ A.T + Q)
    v = y - x_p @ C.T
    S = _sym(C @ P_p @ C.T + R)
    L = _chol(S)
    # K = P_p C' S^{-1} via two triangular solves
    CP = C @ P_p                                    # (..., p, n)
    W = _chosolve(L, CP)                            # S^{-1} C P_p
    x_f = x_p + _mv(_mT(W), v)
    P_f = _sym(P_p - _mT(W) @ CP)
    return x_f, P_f, x_p, P_p, _log_density(_trisolve(L, v), L)


def _stack_time(outs, x0, P0):
    """Per-step (mean, cov, ...) tuples -> time-stacked (..., T, n) means and
    (..., T, n, n) covariances, alternating as in the tuples. With no step
    (T = 0) each is empty, (..., 0, n) and (..., 0, n, n) after x0 (..., n)
    and P0 (..., n, n), as the JAX package's scans return."""
    if not outs:
        mean, cov = x0[..., None, :][..., :0, :], P0[..., None, :, :][..., :0, :, :]
        return (mean, cov, mean, cov)
    return tuple(torch.stack(seq, dim=-2 if k % 2 == 0 else -3)
                 for k, seq in enumerate(zip(*outs)))


def _u_terms(x, T, B, us):
    """(..., T, n) known-input terms us @ B' (zeros without inputs)."""
    if us is None:
        return torch.zeros(x.shape[:-1] + (T, x.shape[-1]), dtype=x.dtype, device=x.device)
    if B is None:
        raise ValueError("us requires B (the input matrix)")
    return us @ B.T


def kalman_filter(A, C, Q, R, x0, P0, ys, B=None, us=None) -> KalmanResult:
    """LTI Kalman filter over the horizon: x0 (..., n), ys (..., T, p), us
    (..., T, m) known inputs with B (n, m). Leading dims of x0/ys/us are
    independent trajectories sharing A, C, Q, R, P0."""
    x0, A, C, Q, R, P0, ys, B, us = _tensors(x0, A, C, Q, R, P0, ys, B, us)
    T = ys.shape[-2]
    u_terms = _u_terms(x0, T, B, us)
    x, P = x0, P0.expand(x0.shape[:-1] + P0.shape)
    ll = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    outs = []
    for t in range(T):
        x, P, x_p, P_p, l = _filter_step(A, C, Q, R, x, P, ys[..., t, :], u_terms[..., t, :])
        ll = ll + l
        outs.append((x, P, x_p, P_p))
    xs_f, Ps_f, xs_p, Ps_p = _stack_time(outs, x, P)
    return KalmanResult(means=xs_f, covs=Ps_f, pred_means=xs_p, pred_covs=Ps_p,
                        log_likelihood=ll)


# The kernel of each batched filter and its envelopes, the largest state (n),
# measurement (p) and input (m) widths: ENVELOPES those the kernel takes (an
# explicit "pallas" past them raises), AUTO_ENVELOPES those "auto" sends to it
# on the card; a width not named is not bounded. K9 serves kalman_filter_batched
# and kalman_filter_sqrt_batched and K10 kalman_smoother_batched, for any
# width in both envelopes, as the JAX package's routes (its kernels hold no
# size check). K11/K12 serve the EKF/UKF: the kernels take n <= 8, m <= 4 and
# p <= n (ENVELOPES_P_LE_N); "auto" holds to the JAX package's ok_dims,
# n <= 8, p <= 4, m <= 4 (estimation.py:955-958, 997-1000).
ENVELOPES = {
    "K9": {},
    "K10": {},
    "K11": {"n": ekf_kernel.MAX_N, "p": ekf_kernel.MAX_P, "m": ekf_kernel.MAX_M},
    "K12": {"n": ekf_kernel.MAX_N, "p": ekf_kernel.MAX_P, "m": ekf_kernel.MAX_M},
}
AUTO_ENVELOPES = {
    "K9": {},
    "K10": {},
    "K11": {"n": 8, "p": 4, "m": 4},
    "K12": {"n": 8, "p": 4, "m": 4},
}
ENVELOPES_P_LE_N = ("K11", "K12")


def route_batched(kernel: str, device_type: str, dtype: torch.dtype, dims: dict,
                  method: str = "auto") -> str:
    """The route of a batched filter's batched pass: "pallas" (its kernel,
    ``kernel`` a key of ENVELOPES) or "xla" (for K9/K10 the kernel's plain
    version, for K11/K12 the single-trajectory filter on the batch).

    "auto" takes the kernel for a float32 tensor on a CUDA device whose
    ``dims`` lie inside AUTO_ENVELOPES, and "xla" otherwise: a stated route,
    as the kernels take float32 only. An explicit "pallas" outside the
    kernel's envelope (ENVELOPES; for K11/K12 also p <= n) raises ValueError,
    as does any other name. On the kernel route the EKF and UKF need a
    registered plant and measurement (models/plants kernel_plant,
    kernel_measurement): for a CUDA tensor the kernel's wrapper raises
    ValueError otherwise, so a caller with its own f or h passes
    method="xla"."""
    if method not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown method {method!r} (auto|pallas|xla)")
    if method == "auto":
        ok = all(dims[k] <= v for k, v in AUTO_ENVELOPES[kernel].items())
        return "pallas" if device_type == "cuda" and dtype == torch.float32 and ok else "xla"
    envelope = ENVELOPES[kernel]
    ok = (all(dims[k] <= v for k, v in envelope.items())
          and (kernel not in ENVELOPES_P_LE_N or dims["p"] <= dims["n"]))
    if method == "pallas" and not ok:
        bound = dict(envelope, **({"p": "n"} if kernel in ENVELOPES_P_LE_N else {}))
        raise ValueError(f"{dims} is outside the {kernel} kernel's envelope {bound}")
    return method


def _mean_pass(route, A, C, Ws, invLs, logdets, x0s, ys_t, us_t, mean_chunk):
    """The batched mean pass by its route: the K9 kernel, its plain version
    ("xla") or the chunked recovery. Returns xs_f, xs_p (T, N, n), ll (N,)."""
    if route == "pallas":
        return kalman_mean.kalman_mean_pass(A, C, Ws, invLs, logdets, x0s, ys_t, us_t)
    if route == "xla":
        return kalman_mean.kalman_mean_pass_reference(A, C, Ws, invLs, logdets, x0s, ys_t, us_t)
    # route == "chunked": the inverse prefix products inside a chunk grow
    # geometrically (4e-2 mean deviation at L = T = 50 in the JAX package):
    # refuse silently wrong results outside the supported envelope
    if mean_chunk > 16:
        raise ValueError(
            f"mean_chunk={mean_chunk} exceeds the supported envelope (<= 16): fp32 "
            f"inverse prefix products blow up with chunk length (measured 4e-2 "
            f"deviation at L=50)")
    if us_t is None:
        us_t = torch.zeros(ys_t.shape[:2] + (x0s.shape[1],), dtype=x0s.dtype,
                           device=x0s.device)
    return _mean_pass_chunked(A, C, x0s, ys_t, us_t, Ws, invLs, logdets,
                              ys_t.shape[-1] * LOG_2PI, int(mean_chunk))


def shared_gains(A, C, Q, R, P0, T: int):
    """The data-independent covariance pass of kalman_filter_batched, once
    over T on the (tensor) matrices: Ws (T, p, n) with K_t = W_t', the
    predicted and filtered covariances P_ps, P_fs (T, n, n), the whitening
    invLs (T, p, p) = chol(S_t)^-1 and logdets (T,) = log det chol(S_t)."""
    eye_p = torch.eye(C.shape[0], dtype=A.dtype, device=A.device)
    Ws, P_ps, P_fs, invLs, logdets = [], [], [], [], []
    P = P0
    for _ in range(T):
        P_p = _sym(A @ P @ A.T + Q)
        L = _chol(_sym(C @ P_p @ C.T + R))
        CP = C @ P_p                               # (p, n)
        W = _chosolve(L, CP)                       # (p, n); K = W'
        P = _sym(P_p - W.T @ CP)
        Ws.append(W)
        P_ps.append(P_p)
        P_fs.append(P)
        invLs.append(_trisolve(L, eye_p))
        logdets.append(torch.log(torch.diagonal(L)).sum())
    return tuple(torch.stack(a) for a in (Ws, P_ps, P_fs, invLs, logdets))


def kalman_filter_batched(A, C, Q, R, x0s, P0, yss, B=None, uss=None, mean_chunk: int = 0,
                          method: str = "auto") -> KalmanResult:
    """Batched LTI Kalman filter: x0s (N, n), yss (N, T, p), uss (N, T, m).

    Shared-covariance fast path: with A, C, Q, R, P0 shared, the covariance
    and gain recursion does not depend on the data, so it runs ONCE over T
    (plain tensor operations on tiny matrices) and only the MEAN recurrence
    is batched. That pass takes the route of :func:`route_batched` for K9:
    "pallas" is one launch of the K9 kernel for the whole horizon, "xla" its
    plain version (the kernel's algebra in batched tensor operations).
    mean_chunk=L (opt-in, L <= 16) takes the chunk-parallel prefix-product
    recovery of :func:`_mean_pass_chunked` instead, whatever the method, as
    in the JAX package. The shared covariances are broadcast to the
    (N, T, n, n) result."""
    x0s, A, C, Q, R, P0, yss, B, uss = _tensors(x0s, A, C, Q, R, P0, yss, B, uss)
    N, T, p = yss.shape
    n = x0s.shape[1]
    route = ("chunked" if mean_chunk and mean_chunk > 1 else
             route_batched("K9", x0s.device.type, x0s.dtype, {"n": n, "p": p}, method))
    Ws, P_ps, P_fs, invLs, logdets = shared_gains(A, C, Q, R, P0, T)
    us_t = None if uss is None else _u_terms(x0s, T, B, uss).transpose(0, 1)
    xs_f, xs_p, ll = _mean_pass(route, A, C, Ws, invLs, logdets, x0s,
                                yss.transpose(0, 1), us_t, mean_chunk)
    return KalmanResult(means=xs_f.transpose(0, 1), covs=P_fs.expand(N, T, n, n),
                        pred_means=xs_p.transpose(0, 1), pred_covs=P_ps.expand(N, T, n, n),
                        log_likelihood=ll)


def _mean_pass_chunked(A, C, x0s, ys_t, us_t, Ws, invLs, logdets, c0, L: int):
    """Chunk-parallel batched mean recurrence (kalman_filter_batched
    mean_chunk=L).

    The filtered mean obeys the shared-gain affine recurrence
        x_t = x_{t-1} @ G_t' + c_t,   G_t' = A'(I - C'W_t),
        c_t = u_t (I - C'W_t) + y_t @ W_t,
    so within a chunk of L steps every mean follows from the chunk's anchor
    through small shared prefix products:
        x_{s+k} = (x_s + sum_{j<=k} c_{s+j} @ P_j^{-1}) @ P_k,
        P_k = G_{s+1}' ... G_{s+k}'.
    The inverse prefix products grow like (1/spectral_radius)^L, so L stays
    small (<= 16). Predictions and the log-likelihood are recovered
    batch-parallel from the filtered sequence afterwards."""
    N, n = x0s.shape
    T = ys_t.shape[0]
    eye_n = torch.eye(n, dtype=x0s.dtype, device=x0s.device)
    Es = eye_n - torch.einsum("pi,tpj->tij", C, Ws)           # (T, n, n)
    Gts = torch.einsum("ij,tjk->tik", A.T, Es)                # G_t' stacks
    cs = torch.einsum("tni,tij->tnj", us_t, Es) + torch.einsum("tnp,tpj->tnj", ys_t, Ws)
    invGts = solve_small(Gts, eye_n.expand(Gts.shape))
    chunks = []
    x = x0s
    for s in range(0, T, L):
        e = min(s + L, T)
        P, iP = eye_n, eye_n
        Ps, iPs = [], []
        for t in range(s, e):
            P = P @ Gts[t]
            iP = invGts[t] @ iP
            Ps.append(P)
            iPs.append(iP)
        d = torch.einsum("kni,kij->knj", cs[s:e], torch.stack(iPs))
        xs_c = torch.einsum("kni,kij->knj", x[None] + torch.cumsum(d, dim=0), torch.stack(Ps))
        chunks.append(xs_c)
        x = xs_c[-1]
    xs_f = torch.cat(chunks, dim=0)                           # (T, N, n)
    x_prev = torch.cat([x0s[None], xs_f[:-1]], dim=0)
    xs_p = torch.einsum("tni,ji->tnj", x_prev, A) + us_t
    v = ys_t - torch.einsum("tni,pi->tnp", xs_p, C)
    alpha = torch.einsum("tnp,tqp->tnq", v, invLs)
    ll = -0.5 * ((alpha * alpha).sum(dim=(0, 2)) + T * c0) - logdets.sum()
    return xs_f, xs_p, ll


def kalman_smoother(A, filt: KalmanResult) -> SmootherResult:
    """RTS backward smoother over the filter output (any leading batch dims):
    gain G = P_f A' P_p^{-1} via a PSD Cholesky solve, backward over t."""
    xs_f, A = _tensors(filt.means, A)
    Ps_f, xs_p, Ps_p = filt.covs, filt.pred_means, filt.pred_covs
    T = xs_f.shape[-2]
    x_s, P_s = xs_f[..., -1, :], Ps_f[..., -1, :, :]
    means, covs = [x_s], [P_s]
    for t in range(T - 2, -1, -1):
        P_f = Ps_f[..., t, :, :]
        P_p_next = Ps_p[..., t + 1, :, :]
        G_T = _chosolve(_chol(P_p_next), A @ P_f)           # G' = P_p^{-1} (A P_f)
        x_s = xs_f[..., t, :] + _mv(_mT(G_T), x_s - xs_p[..., t + 1, :])
        P_s = _sym(P_f + _mT(G_T) @ (P_s - P_p_next) @ G_T)
        means.append(x_s)
        covs.append(P_s)
    return SmootherResult(means=torch.stack(means[::-1], dim=-2),
                          covs=torch.stack(covs[::-1], dim=-3))


def kalman_smoother_batched(A, filt: KalmanResult, method: str = "auto") -> SmootherResult:
    """Batched RTS smoother over kalman_filter_batched output: filt.means
    (N, T, n), filt.covs (N, T, n, n) SHARED across the batch.

    The gains G_t = P_f[t] A' P_p[t+1]^-1 and the smoothed covariances depend
    only on the shared covariances, so both run once on tiny matrices; only
    the backward mean recurrence

        x_s[t] = x_s[t+1] @ G_t' + e_t,  e_t = x_f[t] - x_p[t+1] @ G_t'

    is batched, e_t batch-parallel in one einsum. That pass takes the route
    of :func:`route_batched` for K10 (the kernel, or the plain recurrence)."""
    xs_f, A = _tensors(filt.means, A)
    xs_p = filt.pred_means
    P_fs, P_ps = filt.covs[0], filt.pred_covs[0]          # (T, n, n) shared
    N, T, n = xs_f.shape
    if T == 1:
        return SmootherResult(means=xs_f, covs=filt.covs)
    route = route_batched("K10", xs_f.device.type, xs_f.dtype, {"n": n}, method)
    G_Ts = _chosolve(_chol(P_ps[1:]), A @ P_fs[:-1])       # (T-1, n, n) = G_t'
    P_s = P_fs[-1]
    Ps_s = [P_s]
    for t in range(T - 2, -1, -1):
        P_s = _sym(P_fs[t] + G_Ts[t].T @ (P_s - P_ps[t + 1]) @ G_Ts[t])
        Ps_s.append(P_s)
    Ps_s = torch.stack(Ps_s[::-1])
    xs_p_t, xs_f_t = xs_p.transpose(0, 1), xs_f.transpose(0, 1)      # (T, N, n)
    es_t = xs_f_t[:-1] - torch.einsum("tnj,tjk->tnk", xs_p_t[1:], G_Ts)
    if route == "pallas":
        xs_s = rts_mean.rts_mean_pass(G_Ts, es_t, xs_f_t[-1])
    else:
        xs_s = rts_mean.rts_mean_pass_reference(G_Ts, es_t, xs_f_t[-1])
    return SmootherResult(means=xs_s.transpose(0, 1), covs=Ps_s.expand(N, T, n, n))


def kalman_smoother_associative(A, filt: KalmanResult) -> SmootherResult:
    """Parallel-in-time RTS smoother, O(log T) depth (one trajectory: means
    (T, n)). Each step is an affine element (G, e, D),
        x_s[k] = G_k x_s[k+1] + e_k,  P_s[k] = G_k P_s[k+1] G_k' + D_k,
    composed by (G_i, e_i, D_i) o (G_j, e_j, D_j) = (G_i G_j, G_i e_j + e_i,
    G_i D_j G_i' + D_i) in one associative scan over the reversed horizon
    (Sarkka & Garcia-Fernandez, IEEE TAC 2021)."""
    xs_f, A = _tensors(filt.means, A)
    Ps_f, xs_p, Ps_p = filt.covs, filt.pred_means, filt.pred_covs
    n = xs_f.shape[-1]
    # elements k = 0..T-2: G = P_f A' P_p^-1 (P_p is PD: the adjugate/LU solve)
    P_p_next = Ps_p[1:]
    G = _mT(solve_small(P_p_next, A @ Ps_f[:-1]))
    e = xs_f[:-1] - _mv(G, xs_p[1:])
    D = _sym(Ps_f[:-1] - G @ P_p_next @ _mT(G))
    # the boundary element G = 0 absorbs x_s[T-1]
    Gs = torch.cat([G, torch.zeros((1, n, n), dtype=xs_f.dtype, device=xs_f.device)])
    es = torch.cat([e, xs_f[-1:]])
    Ds = torch.cat([D, Ps_f[-1:]])

    def combine(earlier, later):
        Gi, ei, Di = earlier
        Gj, ej, Dj = later
        return Gi @ Gj, _mv(Gi, ej) + ei, _sym(Gi @ Dj @ _mT(Gi) + Di)

    # reversed: prefix r spans the original indices T-1-r..T-1, and the scan
    # hands (later-in-time segment, earlier element), so the arguments swap
    rev = lambda x: torch.flip(x, dims=(0,))  # noqa: E731
    _, es_s, Ds_s = associative_scan(lambda a, b: combine(b, a), (rev(Gs), rev(es), rev(Ds)))
    return SmootherResult(means=rev(es_s), covs=rev(Ds_s))


def _jac_x(fn, x, *args):
    """d fn / d x at x (..., n): linearize's jacfwd, batched over the leading
    dims of x (and of args) with torch.func.vmap."""
    if x.ndim == 1:
        return torch.func.jacfwd(fn)(x, *args)
    batch = x.shape[:-1]
    flat = [a.reshape((-1,) + a.shape[len(batch):]) for a in (x,) + args]
    J = torch.func.vmap(torch.func.jacfwd(fn))(*flat)
    return J.reshape(batch + J.shape[1:])


def ekf_filter(f: Callable, h: Callable, Q, R, x0, P0, ys, us) -> KalmanResult:
    """Extended Kalman filter: per-step Jacobians of f (at the filtered
    state) and of h (at the prediction) by torch.func.jacfwd, as
    models/rollout.linearize takes them,
    then the standard predict/update. f(x, u) and h(x) index the last axis
    (models/plants.py house style); x0 (..., n), ys (..., T, p), us
    (..., T, m)."""
    x0, Q, R, P0, ys, us = _tensors(x0, Q, R, P0, ys, us)
    T = ys.shape[-2]
    x, P = x0, P0.expand(x0.shape[:-1] + P0.shape)
    ll = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    outs = []
    for t in range(T):
        u, y = us[..., t, :], ys[..., t, :]
        A = _jac_x(f, x, u)
        x_p = f(x, u)
        P_p = _sym(A @ P @ _mT(A) + Q)
        C = _jac_x(h, x_p)
        v = y - h(x_p)
        L = _chol(_sym(C @ P_p @ _mT(C) + R))
        CP = C @ P_p
        W = _chosolve(L, CP)
        x = x_p + _mv(_mT(W), v)
        P = _sym(P_p - _mT(W) @ CP)
        ll = ll + _log_density(_trisolve(L, v), L)
        outs.append((x, P, x_p, P_p))
    xs_f, Ps_f, xs_p, Ps_p = _stack_time(outs, x, P)
    return KalmanResult(means=xs_f, covs=Ps_f, pred_means=xs_p, pred_covs=Ps_p,
                        log_likelihood=ll)


def _positive_diag(L):
    """Flip column signs of a (block-)triangular factor so its diagonal is
    positive: QR is unique only up to column signs, and the innovation log-det
    needs log(diag) > 0. Preserves L @ L'."""
    s = torch.sign(torch.diagonal(L, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return L * s[..., None, :]


def _psd_sqrt(M):
    """Square root S with M = S S' for merely-PSD M (eigh-based: Cholesky
    gives NaN on singular inputs, such as a process noise that drives only
    some states). S is not triangular; the array algorithm's QR
    re-triangularizes every pre-array, so any square root works."""
    w, V = torch.linalg.eigh(_sym(M))
    return V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]


def _qr_lower(pre):
    """The lower-triangular factor L = R' of pre = Q R, diagonal positive."""
    return _positive_diag(_mT(torch.linalg.qr(pre, mode="r")[1]))


def _sqrt_step(A, C, Sq, Sr, S):
    """One covariance step of the array algorithm: S (..., n, n) ->
    (S_p, S_y, Kbar, S_f). Predict: qr([S' A'; Sq']) -> S_p. Update: one
    (n+p, p+n) QR of [[S_p'C', S_p'], [Sr', 0]] -> [[S_y, 0], [Kbar, S_f]]
    (the Kaminski/Grewal condensed array algorithm)."""
    n, p = A.shape[0], C.shape[0]
    batch = S.shape[:-2]
    S_p = _qr_lower(torch.cat([_mT(S) @ A.T, Sq.T.expand(batch + (n, n))], dim=-2))
    zeros = torch.zeros(batch + (p, n), dtype=S.dtype, device=S.device)
    pre_u = torch.cat([torch.cat([_mT(S_p) @ C.T, _mT(S_p)], dim=-1),
                       torch.cat([Sr.T.expand(batch + (p, p)), zeros], dim=-1)], dim=-2)
    L = _qr_lower(pre_u)
    return S_p, L[..., :p, :p], L[..., p:, :p], L[..., p:, p:]


def kalman_filter_sqrt(A, C, Q, R, x0, P0, ys, B=None, us=None) -> SqrtKalmanResult:
    """Square-root (array) Kalman filter: propagates S = chol(P) through QR
    triangularization instead of P, so P = S S' is PSD by construction at any
    precision (the fp32-robust form). Same means and likelihood as
    kalman_filter to fp32 tolerance; x0 (..., n), ys (..., T, p).

    R must make the innovation covariance C P_p C' + R positive definite (R
    PD is sufficient), as for kalman_filter; Q, R and P0 may be PSD-singular."""
    x0, A, C, Q, R, P0, ys, B, us = _tensors(x0, A, C, Q, R, P0, ys, B, us)
    T = ys.shape[-2]
    u_terms = _u_terms(x0, T, B, us)
    Sq, Sr = _psd_sqrt(Q), _psd_sqrt(R)
    x, S = x0, _psd_sqrt(P0).expand(x0.shape[:-1] + P0.shape)
    ll = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    outs = []
    for t in range(T):
        x_p = x @ A.T + u_terms[..., t, :]
        S_p, S_y, Kbar, S = _sqrt_step(A, C, Sq, Sr, S)
        alpha = _trisolve(S_y, ys[..., t, :] - x_p @ C.T)
        x = x_p + _mv(Kbar, alpha)
        ll = ll + _log_density(alpha, S_y)
        outs.append((x, S, x_p, S_p))
    xs_f, Ss_f, xs_p, Ss_p = _stack_time(outs, x, S)
    return SqrtKalmanResult(means=xs_f, chol_covs=Ss_f, pred_means=xs_p, pred_chol_covs=Ss_p,
                            log_likelihood=ll)


def kalman_filter_sqrt_batched(A, C, Q, R, x0s, P0, yss, B=None, uss=None,
                               method: str = "auto") -> SqrtKalmanResult:
    """Batched square-root filter with SHARED A, C, Q, R, P0: the S = chol(P)
    array recursion is data-independent, so it runs ONCE (T small QRs) and
    only the mean and likelihood recurrence is batched. Its gains feed the
    same affine mean recurrence as kalman_filter_batched (x_f = x_p + v @ W
    with W = (Kbar S_y^{-1})', whitening invL = S_y^{-1}), so the batched pass
    takes the same route (:func:`route_batched` for K9: the kernel or the
    plain recurrence)."""
    x0s, A, C, Q, R, P0, yss, B, uss = _tensors(x0s, A, C, Q, R, P0, yss, B, uss)
    N, T, p = yss.shape
    n = x0s.shape[1]
    route = route_batched("K9", x0s.device.type, x0s.dtype, {"n": n, "p": p}, method)
    Sq, Sr = _psd_sqrt(Q), _psd_sqrt(R)
    eye_p = torch.eye(p, dtype=x0s.dtype, device=x0s.device)
    S = _psd_sqrt(P0)
    Ws, invLs, logdets, Ss_f, Ss_p = [], [], [], [], []
    for _ in range(T):
        S_p, S_y, Kbar, S = _sqrt_step(A, C, Sq, Sr, S)
        invSy = _trisolve(S_y, eye_p)              # S_y^{-1} (p, p)
        Ws.append((Kbar @ invSy).T)                # (p, n)
        invLs.append(invSy)
        logdets.append(torch.log(torch.diagonal(S_y)).sum())
        Ss_f.append(S)
        Ss_p.append(S_p)
    Ws, invLs, logdets, Ss_f, Ss_p = (torch.stack(a) for a in (Ws, invLs, logdets, Ss_f, Ss_p))
    us_t = None if uss is None else _u_terms(x0s, T, B, uss).transpose(0, 1)
    xs_f, xs_p, ll = _mean_pass(route, A, C, Ws, invLs, logdets, x0s, yss.transpose(0, 1),
                                us_t, 0)
    return SqrtKalmanResult(means=xs_f.transpose(0, 1), chol_covs=Ss_f.expand(N, T, n, n),
                            pred_means=xs_p.transpose(0, 1),
                            pred_chol_covs=Ss_p.expand(N, T, n, n), log_likelihood=ll)


class _KFElement(NamedTuple):
    """Parallel-filter element (Sarkka & Garcia-Fernandez, IEEE TAC 2021):
    p(x_k | y_..., x_{k-1}) ~ N(A x_{k-1} + b, C), with information terms
    (eta, J) carrying the likelihood backward."""
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _kf_combine(ei: _KFElement, ej: _KFElement, solve=None) -> _KFElement:
    """Combine earlier element i with later element j (associative).

    solve: the denominators' solver (default utils/smallmat.solve_small);
    lu_solve_nopivot only for well-conditioned chains (I + C_i J_j has PSD
    factors, which bound its eigenvalues but not its unpivoted pivots)."""
    if solve is None:
        solve = solve_small
    n = ei.A.shape[-1]
    eye = torch.eye(n, dtype=ei.A.dtype, device=ei.A.device)
    # denom = I + C_i J_j; one solve serves the A, b and C updates
    rhs = torch.cat([ei.A, ei.C, (ei.b + _mv(ei.C, ej.eta))[..., None]], dim=-1)
    M = solve(eye + ei.C @ ej.J, rhs)
    MA, MC, Mb = M[..., :n], M[..., n:2 * n], M[..., 2 * n]
    A = ej.A @ MA
    b = _mv(ej.A, Mb) + ej.b
    C = ej.A @ MC @ _mT(ej.A) + ej.C
    # (I + J_j C_i)^{-1} applied to [eta_j - J_j b_i, J_j A_i]
    rhs2 = torch.cat([(ej.eta - _mv(ej.J, ei.b))[..., None], ej.J @ ei.A], dim=-1)
    M2 = solve(eye + ej.J @ ei.C, rhs2)
    AiT = _mT(ei.A)
    eta = _mv(AiT, M2[..., 0]) + ei.eta
    J = AiT @ M2[..., 1:] + ei.J
    return _KFElement(A, b, _sym(C), eta, _sym(J))


def _kf_build_elements(A, C, Q, R, x0, P0, ys, cs) -> _KFElement:
    """The associative filter's per-stage elements, stacked over T: generic
    elements update against the process-noise prior; the FIRST element
    absorbs the (x0, P0) prior."""
    n, T = x0.shape[0], ys.shape[0]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    zeros = torch.zeros((1, n, n), dtype=x0.dtype, device=x0.device)
    # generic element (k >= 2): update against the PROCESS noise prior
    Ls = _chol(_sym(C @ Q @ C.T + R))
    K = _chosolve(Ls, C @ Q).T                    # Q C' S^-1  (n, p)
    IKC = eye - K @ C
    HtSinv = _chosolve(Ls, C).T                   # C' S^-1  (n, p)
    b = ys @ K.T + cs @ IKC.T
    eta = ((ys - cs @ C.T) @ HtSinv.T) @ A        # A' HtSinv (y - C c), as rows
    # the first element: predict from (x0, P0), update on y_1
    x1p = A @ x0 + cs[0]
    P1p = A @ P0 @ A.T + Q
    K1 = _chosolve(_chol(_sym(C @ P1p @ C.T + R)), C @ P1p).T
    rest = lambda M: M.expand((T - 1,) + M.shape)  # noqa: E731
    return _KFElement(
        A=torch.cat([zeros, rest(IKC @ A)]),
        b=torch.cat([(x1p + K1 @ (ys[0] - C @ x1p))[None], b[1:]]),
        C=torch.cat([_sym((eye - K1 @ C) @ P1p)[None], rest(_sym(IKC @ Q))]),
        eta=torch.cat([torch.zeros_like(x0)[None], eta[1:]]),
        J=torch.cat([zeros, rest(_sym(A.T @ HtSinv @ C @ A))]),
    )


def _kf_predict_ll(A, C, Q, R, x_prev, P_prev, y, c):
    """One-step predictions and innovation log-densities from the filtered
    previous states (the associative filter's trailing recovery pass),
    batched over the leading dim."""
    x_p = x_prev @ A.T + c
    P_p = _sym(A @ P_prev @ A.T + Q)
    Lk = _chol(_sym(C @ P_p @ C.T + R))
    return x_p, P_p, _log_density(_trisolve(Lk, y - x_p @ C.T), Lk)


def kalman_filter_associative(A, C, Q, R, x0, P0, ys, B=None, us=None,
                              nopivot: bool = False) -> KalmanResult:
    """Parallel-in-time Kalman filter: O(log T) depth associative scan (one
    trajectory: x0 (n,), ys (T, p)). Same outputs as kalman_filter to fp32
    tolerance, for long horizons. nopivot=True solves the combine
    denominators with the unpivoted unrolled LU, an opt-in for
    well-conditioned chains only; the default is the pivoted solver."""
    x0, A, C, Q, R, P0, ys, B, us = _tensors(x0, A, C, Q, R, P0, ys, B, us)
    cs = _u_terms(x0, ys.shape[0], B, us)
    elems = _kf_build_elements(A, C, Q, R, x0, P0, ys, cs)
    solve = lu_solve_nopivot if nopivot else None
    combined = associative_scan(
        lambda earlier, later: tuple(_kf_combine(_KFElement(*earlier), _KFElement(*later),
                                                 solve=solve)),
        tuple(elems))
    xs_f, Ps_f = combined[1], combined[2]         # b and C of the prefixes
    xs_prev = torch.cat([x0[None], xs_f[:-1]])
    Ps_prev = torch.cat([P0[None], Ps_f[:-1]])
    xs_p, Ps_p, lls = _kf_predict_ll(A, C, Q, R, xs_prev, Ps_prev, ys, cs)
    return KalmanResult(means=xs_f, covs=Ps_f, pred_means=xs_p, pred_covs=Ps_p,
                        log_likelihood=lls.sum())


def ukf_filter(f: Callable, h: Callable, Q, R, x0, P0, ys, us, alpha: float = 1.0,
               beta: float = 2.0, kappa: float = 0.0) -> KalmanResult:
    """Unscented Kalman filter (Wan-Merwe sigma points): 2n+1 sigma points
    go through f and h exactly (one batched plant call per step), means and
    covariances are weighted sums. alpha = 1, kappa = 0 (the cubature-style
    spread) are fp32-robust; on an LTI plant this reproduces kalman_filter.
    f and h index the last axis; x0 (..., n), ys (..., T, p), us (..., T, m)."""
    x0, Q, R, P0, ys, us = _tensors(x0, Q, R, P0, ys, us)
    n = x0.shape[-1]
    lam = alpha * alpha * (n + kappa) - n
    c = n + lam
    wm = torch.tensor([lam / c] + [0.5 / c] * (2 * n), dtype=x0.dtype, device=x0.device)
    wc = wm.clone()
    wc[0] = wc[0] + (1.0 - alpha * alpha + beta)
    jitter = 1e-9 * torch.eye(n, dtype=x0.dtype, device=x0.device)

    def sigma_points(x, P):                      # (..., 2n+1, n)
        S_T = _mT(_chol(c * _sym(P) + jitter))
        xb = x[..., None, :]
        return torch.cat([xb, xb + S_T, xb - S_T], dim=-2)

    x, P = x0, P0.expand(x0.shape[:-1] + P0.shape)
    ll = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    outs = []
    for t in range(ys.shape[-2]):
        u, y = us[..., t, :], ys[..., t, :]
        # predict: every sigma point through f
        pts = sigma_points(x, P)
        pts_f = f(pts, u[..., None, :].expand(pts.shape[:-1] + u.shape[-1:]))
        x_p = wm @ pts_f
        dX = pts_f - x_p[..., None, :]
        P_p = _sym(_mT(wc[:, None] * dX) @ dX + Q)
        # update: sigma points redrawn from the predicted density
        pts2 = sigma_points(x_p, P_p)
        pts_h = h(pts2)
        y_p = wm @ pts_h
        dY = pts_h - y_p[..., None, :]
        S = _sym(_mT(wc[:, None] * dY) @ dY + R)
        Pxy = _mT(wc[:, None] * (pts2 - x_p[..., None, :])) @ dY     # (..., n, p)
        L = _chol(S)
        K_T = _chosolve(L, _mT(Pxy))              # K' = S^{-1} Pxy'
        v = y - y_p
        x = x_p + _mv(_mT(K_T), v)
        P = _sym(P_p - _mT(K_T) @ S @ K_T)
        ll = ll + _log_density(_trisolve(L, v), L)
        outs.append((x, P, x_p, P_p))
    xs_f, Ps_f, xs_p, Ps_p = _stack_time(outs, x, P)
    return KalmanResult(means=xs_f, covs=Ps_f, pred_means=xs_p, pred_covs=Ps_p,
                        log_likelihood=ll)


def _whole_filter_dims(x0s, yss, uss) -> dict:
    return {"n": x0s.shape[1], "p": yss.shape[2], "m": uss.shape[2]}


def ekf_filter_batched(f: Callable, h: Callable, Q, R, x0s, P0, yss, uss,
                       method: str = "auto") -> KalmanResult:
    """Batched EKF over B trajectories: x0s (B, n), P0 (n, n) shared, yss
    (B, T, p), uss (B, T, m). The route (:func:`route_batched` for K11):
    "pallas" runs the whole filter in one launch of K11 (kernels/ekf.py:
    Jacobians by forward-mode dual numbers of the registered plant in the
    kernel; an unregistered f or h raises ValueError on the card), "xla"
    runs ekf_filter on the batch."""
    x0s, Q, R, P0, yss, uss = _tensors(x0s, Q, R, P0, yss, uss)
    route = route_batched("K11", x0s.device.type, x0s.dtype, _whole_filter_dims(x0s, yss, uss),
                          method)
    if route == "pallas":
        return KalmanResult(*ekf_kernel.ekf_batched(f, h, Q, R, x0s, P0, yss, uss))
    return ekf_filter(f, h, Q, R, x0s, P0, yss, uss)


def ukf_filter_batched(f: Callable, h: Callable, Q, R, x0s, P0, yss, uss, alpha: float = 1.0,
                       beta: float = 2.0, kappa: float = 0.0,
                       method: str = "auto") -> KalmanResult:
    """Batched UKF over B trajectories (shapes as ekf_filter_batched). The
    route (:func:`route_batched` for K12): "pallas" runs the whole filter in
    one launch of K12 (kernels/ukf.py: the registered plant once per sigma
    point in the kernel; an unregistered f or h raises ValueError on the
    card), "xla" runs ukf_filter on the batch."""
    x0s, Q, R, P0, yss, uss = _tensors(x0s, Q, R, P0, yss, uss)
    route = route_batched("K12", x0s.device.type, x0s.dtype, _whole_filter_dims(x0s, yss, uss),
                          method)
    if route == "pallas":
        return KalmanResult(*ukf_kernel.ukf_batched(f, h, Q, R, x0s, P0, yss, uss, alpha=alpha,
                                                    beta=beta, kappa=kappa))
    return ukf_filter(f, h, Q, R, x0s, P0, yss, uss, alpha=alpha, beta=beta, kappa=kappa)
