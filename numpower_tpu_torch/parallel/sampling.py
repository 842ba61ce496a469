"""Sharded sampling solvers on torch.distributed: data-parallel MPPI and the
particle filter with its cloud sharded (port of
numpower_tpu/parallel/sampling.py).

Both are MESH-SHAPE-INVARIANT, as in the JAX package: every rank draws the
whole perturbation or noise tensor from a generator seeded as the
single-device solver's (utils.device.seeded_generator), with the
single-device solver's own draw functions (kernels/mppi.draw_eps,
models/particle._draws), and slices its block of it. So

    sharded(mesh (1, 1)) == sharded(mesh (D, M)) == single-device solver

up to the order of the collectives' sums (~1e-6 in fp32). A rank holds the
full draw: N iters K T m floats for MPPI (84 MB at the MPPI bench's shape).
Where the JAX package takes a key, the port takes a ``torch.Generator``.

  - MPPI: scenarios over the data axis, samples over the model axis; the
    softmax's shift (the minimum cost) is an all_reduce MIN over the model
    group, its normalizer, the weighted update and the sum of squared
    weights one all_reduce SUM.
  - Particle filter: the cloud sharded over one axis; the unnormalized
    log-weights are all_gathered and the log-sum-exp increment and the ESS
    formed from them on every rank (an all_reduced sum would round in another
    order than the single-device filter's, and one bit moves a resampling
    slot or flips the resampling choice); mean and covariance are
    all_reduced; resampling all_gathers the cloud, resamples the global cloud
    with models/particle._systematic_resample (K14 on the card) and keeps
    this rank's row block. The resample runs every step and is chosen by a
    ``where``, never by a branch on a value that differs between ranks.

The private cores take the draws, so tests can hand them the JAX package's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from numpower_tpu_torch.kernels import mppi as mppi_kernel
from numpower_tpu_torch.kernels.mppi import _clip
from numpower_tpu_torch.models.estimation import _psd_sqrt
from numpower_tpu_torch.models.mppi import MPPIResult, _trajectory_cost
from numpower_tpu_torch.models.particle import (
    ParticleFilterResult, _draws, _neg_log, _operands, _systematic_resample,
)
from numpower_tpu_torch.models.rollout import rollout_nonlinear
from numpower_tpu_torch.parallel.mesh import Mesh
from numpower_tpu_torch.parallel.sharding import _all_reduce
from numpower_tpu_torch.utils.device import seeded_generator, state_tensor


def mppi_solve_dp(
    f: Callable,
    x0s,                      # (N_local, n): this rank's block of the scenarios
    cost_fn: Callable,
    horizon: int,
    generator: Optional[torch.Generator],
    mesh: Mesh,
    samples: int = 1024,
    iters: int = 8,
    lam: float = 1.0,
    sigma=1.0,
    u_lo: Optional[float] = None,
    u_hi: Optional[float] = None,
    m: int = 1,
    shard_samples: bool = True,
) -> MPPIResult:
    """Data-parallel MPPI: scenarios over the data axis, the K samples over
    the model axis (shard_samples=False keeps all samples on every rank: pure
    scenario DP).

    The math of models/mppi.mppi_solve_batched's plain route on the same
    draws: the full (N, iters, K, T, m) perturbation tensor is drawn from
    ``generator`` (default: seeded 0 on the block's device) on every rank and
    sliced to its scenarios and samples. Cold nominal only (no us_init or
    baseline_mix), as in the JAX package. Returns this rank's block of the
    MPPIResult."""
    x0s = state_tensor(x0s)
    samp_ax = mesh.axis_names[1] if shard_samples else None
    n_samp = mesh.size(samp_ax) if samp_ax else 1
    if samples % n_samp:
        raise ValueError(f"samples={samples} not divisible by model axis {n_samp}")
    K_loc, N_loc = samples // n_samp, x0s.shape[0]
    data_ax = mesh.axis_names[0]
    row0 = mesh.index(data_ax) * N_loc
    col0 = mesh.index(samp_ax) * K_loc if samp_ax else 0
    generator = seeded_generator(generator, x0s.device)
    eps = mppi_kernel.draw_eps(generator, N_loc * mesh.size(data_ax), iters, samples, horizon,
                               m, sigma, x0s.dtype)
    eps = eps[row0:row0 + N_loc, :, col0:col0 + K_loc]
    return _mppi_dp_core(f, x0s, cost_fn, eps, mesh, samp_ax, lam=lam, sigma=sigma, u_lo=u_lo,
                         u_hi=u_hi)


def _mppi_dp_core(f, x0s, cost_fn, eps, mesh: Mesh, samp_ax: Optional[str], lam=1.0,
                  sigma=1.0, u_lo=None, u_hi=None) -> MPPIResult:
    """The rounds of mppi_solve_dp on this rank's scenarios x0s (N_local, n)
    and its block of the perturbations eps (N_local, iters, K_local, T, m),
    the rank's whole block at once; the weights' sums over the samples are
    all_reduced over ``samp_ax`` (None: the rank holds every sample)."""
    N_loc, iters, K_loc, T, m = eps.shape
    dt, dev = x0s.dtype, x0s.device
    sigma_arr = torch.as_tensor(np.asarray(mppi_kernel.sigma_tuple(sigma, m), np.float32),
                                dtype=dt, device=dev)
    inv_sig2 = 1.0 / (sigma_arr * sigma_arr)
    us = torch.zeros((N_loc, T, m), dtype=dt, device=dev)
    x0k = x0s[:, None, :].expand(N_loc, K_loc, x0s.shape[-1])
    ess = None
    for it in range(iters):
        cand = _clip(us[:, None] + eps[:, it], u_lo, u_hi)
        eps_eff = cand - us[:, None]
        costs = _trajectory_cost(cost_fn, rollout_nonlinear(f, x0k, cand), cand)  # (N_loc, K_loc)
        couple = lam * torch.einsum("nktm,ntm->nk", eps_eff, inv_sig2 * us)
        S = costs + couple
        # softmax(-S / lam) shifted by the MINIMUM cost (the best sample gets
        # weight 1): a shift by the maximum would overflow the good samples
        S_min = S.amin(dim=-1)
        if samp_ax:
            S_min = _all_reduce(S_min, dist.ReduceOp.MIN, mesh, samp_ax)
        e = torch.exp(-(S - S_min[:, None]) / lam)
        upd = torch.einsum("nk,nktm->ntm", e, eps_eff)
        sums = torch.cat([e.sum(dim=-1, keepdim=True), (e * e).sum(dim=-1, keepdim=True),
                          upd.reshape(N_loc, T * m)], dim=-1)
        if samp_ax:
            sums = _all_reduce(sums, dist.ReduceOp.SUM, mesh, samp_ax)  # one collective
        Z, w2, upd = sums[:, 0], sums[:, 1], sums[:, 2:].reshape(N_loc, T, m)
        ess = Z * Z / w2
        us = _clip(us + upd / Z[:, None, None], u_lo, u_hi)
    xs = rollout_nonlinear(f, x0s, us)
    return MPPIResult(us=us, xs=xs, cost=_trajectory_cost(cost_fn, xs, us), ess=ess)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``group``, concatenated in rank
    order along dim 0."""
    blocks = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(blocks, x.contiguous(), group=group)
    return torch.cat(blocks)


def particle_filter_dp(
    f: Callable, h: Callable, Q, R,
    x0,                      # (n,) prior mean of the one trajectory
    P0,
    ys,                      # (T, p)
    us,                      # (T, m)
    generator: Optional[torch.Generator],
    mesh: Mesh,
    n_particles: int = 1024,
    resample_threshold: float = 0.5,
    axis: Optional[str] = None,
    resample_method: str = "auto",
) -> ParticleFilterResult:
    """Bootstrap particle filter with the cloud sharded over ``axis``
    (default: the data axis): rank k of the axis holds particles
    [k N/D, (k + 1) N/D).

    The draws are models/particle.particle_filter's, from ``generator``
    (default: seeded 0 on x0's device), each rank slicing its rows, so the
    moments, ESS and log-likelihood equal the single-device filter's to the
    order of the collectives' sums; on one rank every collective is the
    identity and the filter is the single-device one, operation for
    operation. resample_method is _systematic_resample's ("auto": K14 for
    float32 on the card), applied to the gathered global cloud.

    Returns the replicated means, covs, ess and log_likelihood, and this
    rank's block of the final particles and log-weights."""
    x0, Q, R, P0, ys, us = _operands(x0, Q, R, P0, ys, us)
    ax = axis or mesh.axis_names[0]
    D, N = mesh.size(ax), int(n_particles)
    if N % D:
        raise ValueError(f"n_particles={N} not divisible by axis {ax}={D}")
    N_loc = N // D
    rows = slice(mesh.index(ax) * N_loc, (mesh.index(ax) + 1) * N_loc)
    noise0, prop, u0s = _draws(generator, (), N, x0.shape[-1], ys.shape[-2], x0)
    return _particle_filter_dp_core(f, h, Q, R, x0, P0, ys, us, noise0[rows], prop[:, rows],
                                    u0s, N, mesh, ax, resample_threshold, resample_method)


def _particle_filter_dp_core(f, h, Q, R, x0, P0, ys, us, noise0, prop_noise, u0s, N: int,
                             mesh: Mesh, ax: str, resample_threshold: float,
                             resample_method: str) -> ParticleFilterResult:
    """The filter of particle_filter_dp on this rank's rows of the draws:
    noise0 (N_local, n) and prop_noise (T, N_local, n) standard normals, u0s
    (T,) uniforms; N the global particle count. Each expression is
    models/particle._particle_filter_core's: the log-weights and the ESS
    from the gathered global log-weights, the mean's and covariance's sums
    over the particles all_reduced over ``ax``."""
    N_loc, n = noise0.shape
    p = ys.shape[-1]
    dt, dev = x0.dtype, x0.device
    group = mesh.group(ax)
    row0 = mesh.index(ax) * N_loc
    L0, Lq = _psd_sqrt(P0), _psd_sqrt(Q)
    Lr = torch.linalg.cholesky(0.5 * (R + R.T))
    log_norm = -torch.sum(torch.log(torch.diagonal(Lr))) - 0.5 * p * math.log(2.0 * math.pi)
    thr = resample_threshold * N
    neg_log_n = _neg_log(N, dt)

    parts = x0[None, :] + noise0 @ L0.T
    logw = torch.full((N_loc,), neg_log_n, dtype=dt, device=dev)
    ll = torch.zeros((), dtype=dt, device=dev)
    means, covs, esss = [], [], []
    for t in range(ys.shape[-2]):
        y, u = ys[t], us[t]
        parts = f(parts, u[None, :].expand(N_loc, u.shape[-1])) + prop_noise[t] @ Lq.T
        v = y[None, :] - h(parts)                                              # (N_loc, p)
        alpha = torch.linalg.solve_triangular(Lr, v.T, upper=False)
        logp = log_norm - 0.5 * torch.sum(alpha * alpha, dim=-2)               # (N_loc,)
        # the log-sum-exp increment from the gathered global s, formed as the
        # single-device filter forms it: every rank's log-weights, and with
        # them the resampling slots, are then the single-device filter's bit
        # for bit at any D (an all_reduced sum rounds in another order, and
        # one bit moves a slot boundary: the clouds part from there on)
        s = logw + logp
        s_g = _gather(s, group)
        inc = torch.logsumexp(s_g, dim=-1)
        logw, logw_g = s - inc, s_g - inc
        w_g = torch.exp(logw_g)
        ess = 1.0 / torch.sum(w_g * w_g, dim=-1)  # it decides the resampling: global too
        w = torch.exp(logw)
        mean = _all_reduce((w[None, :] @ parts)[0], dist.ReduceOp.SUM, mesh, ax)
        d = parts - mean[None, :]
        cov = _all_reduce((w[:, None] * d).T @ d, dist.ReduceOp.SUM, mesh, ax)
        # resample the global cloud every step; keep this rank's rows where chosen
        new_parts, _ = _systematic_resample(u0s[t], _gather(parts, group), logw_g,
                                            resample_method)
        resample = ess < thr
        parts = torch.where(resample, new_parts[row0:row0 + N_loc], parts)
        logw = torch.where(resample, torch.full_like(logw, neg_log_n), logw)
        ll = ll + inc
        means.append(mean)
        covs.append(cov)
        esss.append(ess)
    return ParticleFilterResult(means=torch.stack(means), covs=torch.stack(covs),
                                ess=torch.stack(esss), log_likelihood=ll, particles=parts,
                                log_weights=logw)
