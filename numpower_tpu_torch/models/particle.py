"""Particle filter (sequential Monte Carlo), the non-Gaussian member of the
estimation family (port of numpower_tpu/models/particle.py).

  - the whole filter is a Python loop over T whose steps are batched tensor
    operations: the particle cloud (..., N, n) propagates as one plant
    evaluation per step
  - systematic resampling: one uniform offset, N evenly spaced positions
    through the CDF, as integer slot boundaries (_resample_slots); the
    resampled cloud comes from K14 (kernels/pf_resample.py) on the card, or
    from the plain constructions of the JAX package ("gather", "onehot")
  - resampling triggers on the effective sample size (ESS): the JAX
    package's lax.cond becomes a torch.where between the resampled and the
    kept cloud, which is what its vmap lowers the cond to; no step waits on
    the host, and the resample runs at every step
  - the log-likelihood accumulates as logsumexp increments

Noise model: x' = f(x, u) + w, w ~ N(0, Q); y = h(x) + v, v ~ N(0, R), the
(f, h, Q, R) signature of ekf_filter/ukf_filter. Where the JAX package takes
a key, the port takes a ``torch.Generator`` (default: one seeded 0 on the
states' device); the draws are made before the loop and handed to a private
core, which tests can hand the JAX package's own draws. A numpy state goes to
the card as float32 (utils.state_tensor); every other operand follows the
state's device and dtype.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from numpower_tpu_torch.kernels import pf_resample
from numpower_tpu_torch.models.estimation import _psd_sqrt
from numpower_tpu_torch.utils.device import seeded_generator, state_tensor


class ParticleFilterResult(NamedTuple):
    means: torch.Tensor           # (..., T, n) posterior means E[x_t | y_1..t]
    covs: torch.Tensor            # (..., T, n, n) posterior covariances
    ess: torch.Tensor             # (..., T) effective sample size per step
    log_likelihood: torch.Tensor  # (...) log p(y_1..T)
    particles: torch.Tensor       # (..., N, n) final particle cloud
    log_weights: torch.Tensor     # (..., N) final normalized log-weights


def _cumsum_rows(w: torch.Tensor) -> torch.Tensor:
    """torch.cumsum(w, dim=-1), the same sums on every call. On the card
    torch scans a tensor that is one row (numel equal to the last axis) with
    CUB's single-pass scan, whose float sums depend on the timing of its
    look-back between tiles, so the same weights give slot boundaries that
    differ from run to run once N exceeds a tile; such a row is scanned as
    the first of two, which takes torch's row-per-block scan."""
    if w.device.type == "cuda" and w.numel() == w.shape[-1]:
        row = w.reshape(1, -1)
        return torch.cumsum(torch.cat([row, row]), dim=-1)[0].reshape(w.shape)
    return torch.cumsum(w, dim=-1)


def _resample_slots(u0, logw, N: int):
    """Integer slot boundaries of systematic resampling, u0 (...) uniform
    offsets, logw (..., N): particle j owns output slots [m_{j-1}, m_j) with
    m_j = clip(floor(N cum_j - u0) + 1, 0, N), the searchsorted(cum,
    (i + u0)/N) assignment. Returns m (..., N) int32."""
    w = torch.exp(logw - torch.logsumexp(logw, dim=-1, keepdim=True))
    cum = _cumsum_rows(w)
    cum = cum / cum[..., -1:]  # exact 1.0 endpoint
    return torch.clamp(torch.floor(N * cum - u0[..., None]).to(torch.int32) + 1, 0, N)


def _neg_log(N: int, dtype) -> float:
    """-log N as the JAX package forms it, log of N in the working dtype."""
    return -torch.log(torch.tensor(float(N), dtype=dtype)).item()


def route_resample(device_type: str, dtype: torch.dtype, method: str = "auto") -> str:
    """The resampling construction: "pallas" (K14), "gather" or "onehot" (the
    JAX package's plain constructions). "auto" takes K14 for float32 on a CUDA
    device and "gather" elsewhere (the JAX package's one-hot N <= 8192 rule
    was measured on a TPU and is not carried over)."""
    if method not in ("auto", "onehot", "gather", "pallas"):
        raise ValueError(f"unknown resample_method {method!r} (auto|onehot|gather|pallas)")
    if method == "auto":
        return "pallas" if device_type == "cuda" and dtype == torch.float32 else "gather"
    return method


def _systematic_resample(u0, parts, logw, method: str = "auto"):
    """Systematic resampling of parts (..., N, n) with log-weights (..., N)
    and offsets u0 (...): the resampled cloud and uniform log-weights.

    "pallas": K14 on the slot boundaries (its plain version on the CPU);
    "gather": scatter a 1 at each particle's first output slot (particles
    with no slot collapse onto the next start and accumulate), cumsum - 1 is
    the source index, one gather; "onehot": out[i] = sum_j 1[m_{j-1} <= i <
    m_j] p[j], an (N, N) mask times the cloud. All three give the same cloud."""
    N, n = parts.shape[-2:]
    batch = parts.shape[:-2]
    m = _resample_slots(u0, logw, N)
    method = route_resample(parts.device.type, parts.dtype, method)
    uniform = torch.full_like(logw, _neg_log(N, logw.dtype))
    if method == "pallas":
        out = pf_resample.resample_systematic(parts.reshape(-1, N, n).contiguous(),
                                              m.reshape(-1, N).contiguous())
        return out.reshape(parts.shape), uniform
    m_prev = torch.cat([torch.zeros(batch + (1,), dtype=m.dtype, device=m.device),
                        m[..., :-1]], dim=-1)
    if method == "gather":
        hits = torch.zeros(batch + (N + 1,), dtype=torch.int32, device=m.device)
        hits.scatter_add_(-1, m_prev.long(), torch.ones_like(m_prev))  # slot N drops out below
        idx = torch.cumsum(hits[..., :N], dim=-1) - 1
        return torch.gather(parts, -2, idx[..., None].expand(parts.shape)), uniform
    i_idx = torch.arange(N, device=m.device)[:, None]
    oh = (i_idx >= m_prev[..., None, :]) & (i_idx < m[..., None, :])
    return oh.to(parts.dtype) @ parts, uniform


def _particle_filter_core(f, h, Q, R, x0, P0, ys, us, noise0, prop_noise, u0s,
                          resample_threshold: float, resample_method: str) -> ParticleFilterResult:
    """The filter on x0 (..., n), ys (..., T, p), us (..., T, m) with its
    draws: noise0 (..., N, n) and prop_noise (T, ..., N, n) standard
    normals, u0s (T, ...) uniforms on [0, 1). Every leading dimension is an
    independent filter."""
    N, n = noise0.shape[-2:]
    p = ys.shape[-1]
    dt = x0.dtype
    # Q/P0 only scale noise draws: any square root works, and the eigh-based
    # one tolerates PSD-singular inputs (noise driving only some states).
    # R must be strictly PD: the observation density whitens with chol(R).
    L0, Lq = _psd_sqrt(P0), _psd_sqrt(Q)
    Lr = torch.linalg.cholesky(0.5 * (R + R.T))
    log_norm = -torch.sum(torch.log(torch.diagonal(Lr))) - 0.5 * p * math.log(2.0 * math.pi)
    thr = resample_threshold * N

    parts = x0[..., None, :] + noise0 @ L0.T
    logw = torch.full(noise0.shape[:-1], _neg_log(N, dt), dtype=dt, device=x0.device)
    ll = torch.zeros(x0.shape[:-1], dtype=dt, device=x0.device)
    means, covs, esss = [], [], []
    for t in range(ys.shape[-2]):
        y, u = ys[..., t, :], us[..., t, :]
        # propagate through the plant + process noise (one batched evaluation)
        parts = f(parts, u[..., None, :].expand(parts.shape[:-1] + u.shape[-1:])) \
            + prop_noise[t] @ Lq.T
        # Gaussian observation log-density, Cholesky-whitened
        v = y[..., None, :] - h(parts)                                     # (..., N, p)
        alpha = torch.linalg.solve_triangular(Lr, v.transpose(-1, -2), upper=False)
        logp = log_norm - 0.5 * torch.sum(alpha * alpha, dim=-2)          # (..., N)
        # likelihood increment log sum_i w_i p(y | x_i), then renormalize
        inc = torch.logsumexp(logw + logp, dim=-1)
        logw = logw + logp - inc[..., None]
        w = torch.exp(logw)
        ess = 1.0 / torch.sum(w * w, dim=-1)
        mean = (w[..., None, :] @ parts)[..., 0, :]
        d = parts - mean[..., None, :]
        cov = (w[..., None] * d).transpose(-1, -2) @ d
        new_parts, new_logw = _systematic_resample(u0s[t], parts, logw, resample_method)
        resample = ess < thr
        parts = torch.where(resample[..., None, None], new_parts, parts)
        logw = torch.where(resample[..., None], new_logw, logw)
        ll = ll + inc
        means.append(mean)
        covs.append(cov)
        esss.append(ess)
    return ParticleFilterResult(means=torch.stack(means, dim=-2), covs=torch.stack(covs, dim=-3),
                                ess=torch.stack(esss, dim=-1), log_likelihood=ll,
                                particles=parts, log_weights=logw)


def _operands(x0, Q, R, P0, ys, us):
    x0 = state_tensor(x0)
    return (x0,) + tuple(torch.as_tensor(a, dtype=x0.dtype, device=x0.device)
                         for a in (Q, R, P0, ys, us))


def _draws(generator, batch: tuple, N: int, n: int, T: int, x0):
    """noise0 (*batch, N, n), prop_noise (T, *batch, N, n), u0s (T, *batch)
    from the generator (default: seeded 0 on x0's device)."""
    kw = dict(generator=seeded_generator(generator, x0.device), dtype=x0.dtype, device=x0.device)
    return (torch.randn(batch + (N, n), **kw), torch.randn((T,) + batch + (N, n), **kw),
            torch.rand((T,) + batch, **kw))


def particle_filter(
    f: Callable,          # f(x, u) -> x_next, indexing the last axis (models/plants)
    h: Callable,          # h(x) -> y, indexing the last axis
    Q,                    # (n, n) process noise cov
    R,                    # (p, p) measurement noise cov
    x0,                   # (n,) prior mean
    P0,                   # (n, n) prior cov
    ys,                   # (T, p) measurements
    us,                   # (T, m) known inputs
    generator: Optional[torch.Generator] = None,
    n_particles: int = 1024,
    resample_threshold: float = 0.5,
    resample_method: str = "auto",
) -> ParticleFilterResult:
    """Bootstrap particle filter. Resamples (systematic) when
    ESS < resample_threshold * n_particles; threshold 1.0 forces every step,
    0.0 never resamples. resample_method (see route_resample): "auto" (K14
    for float32 on the card, "gather" elsewhere), "pallas", "onehot" or
    "gather"; the filter is the same with each."""
    x0, Q, R, P0, ys, us = _operands(x0, Q, R, P0, ys, us)
    noise0, prop, u0s = _draws(generator, (), int(n_particles), x0.shape[-1], ys.shape[-2], x0)
    return _particle_filter_core(f, h, Q, R, x0, P0, ys, us, noise0, prop, u0s,
                                 resample_threshold, resample_method)


def particle_filter_batched(
    f: Callable, h: Callable, Q, R,
    x0s,                  # (B, n)
    P0,
    yss,                  # (B, T, p)
    uss,                  # (B, T, m)
    generator: Optional[torch.Generator] = None,
    n_particles: int = 1024,
    resample_threshold: float = 0.5,
    resample_method: str = "auto",
) -> ParticleFilterResult:
    """Independent filters of B trajectories with independent draws, the
    cloud (B, N, n) as one batch: on the card each step resamples all
    trajectories with one K14 launch (T launches per call)."""
    x0s, Q, R, P0, yss, uss = _operands(x0s, Q, R, P0, yss, uss)
    noise0, prop, u0s = _draws(generator, x0s.shape[:1], int(n_particles), x0s.shape[-1],
                               yss.shape[-2], x0s)
    return _particle_filter_core(f, h, Q, R, x0s, P0, yss, uss, noise0, prop, u0s,
                                 resample_threshold, resample_method)
