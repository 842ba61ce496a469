"""Horizon-sharded parallel-in-time Kalman filter on torch.distributed (port
of numpower_tpu/parallel/kalman_sp.py).

The estimation-side companion of parallel/riccati_sp.py:
models/estimation.kalman_filter_associative parallelizes time within one
device; this module shards the measurement horizon across the ranks of one
mesh axis. A two-level PREFIX scan over the conditional-density elements
(A, b, C, eta, J) of models/estimation.py (Sarkka & Garcia-Fernandez, IEEE
TAC 2021):

  1. local:  each rank takes its block of the elements and runs the forward
             associative scan: local prefixes and the block total;
  2. global: the block totals are gathered (one all_gather of
             D (3n^2 + 2n) floats over the axis group) and each rank folds
             the totals of the EARLIER blocks into its before-block prefix;
  3. apply:  combining that prefix with each local prefix gives the global
             prefix, the filtered (x_t, P_t); the predictions and the
             innovation log-likelihood are recovered stage by stage (the
             block's boundary state is the before-block prefix's (b, C)),
             and the log-likelihood is an all_reduce SUM over the axis.

Ragged T is handled as in riccati_sp: the horizon is padded at the FRONT
with the combine's identity element (A = I, b = 0, C = 0, eta = 0, J = 0),
whose stages are dropped and whose log-likelihood terms are masked.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from numpower_tpu_torch.models.estimation import (
    KalmanResult, _KFElement, _kf_build_elements, _kf_combine, _kf_predict_ll, _tensors,
    _u_terms,
)
from numpower_tpu_torch.parallel.mesh import Mesh
from numpower_tpu_torch.parallel.riccati_sp import horizon_block
from numpower_tpu_torch.utils.associative_scan import associative_scan


def kalman_filter_associative_sharded(A, C, Q, R, x0, P0, ys, mesh: Mesh, B=None, us=None,
                                      axis: str = "model") -> KalmanResult:
    """Kalman filter of one trajectory with its T-step horizon sharded over
    ``axis``.

    Every rank takes the whole (replicated) problem, x0 (n,), ys (T, p)
    [, us (T, m) with B], and returns its stage block of
    models/estimation.kalman_filter's KalmanResult (means, covs, pred_means,
    pred_covs) with the GLOBAL log-likelihood; the blocks concatenated in
    axis order are kalman_filter's to fp32 tolerance. Any T is accepted
    (front padding with identity elements; a rank may keep no stage)."""
    x0, A, C, Q, R, P0, ys, B, us = _tensors(x0, A, C, Q, R, P0, ys, B, us)
    T, n = ys.shape[0], x0.shape[0]
    D, k = mesh.size(axis), mesh.index(axis)
    dt, dev = x0.dtype, x0.device
    blk, pad, stages, keep = horizon_block(T, mesh, axis, dev)
    cs = _u_terms(x0, T, B, us)
    elems = _kf_build_elements(A, C, Q, R, x0, P0, ys, cs)
    ident = _KFElement(A=torch.eye(n, dtype=dt, device=dev), b=torch.zeros(n, dtype=dt, device=dev),
                       C=torch.zeros((n, n), dtype=dt, device=dev),
                       eta=torch.zeros(n, dtype=dt, device=dev),
                       J=torch.zeros((n, n), dtype=dt, device=dev))
    # this rank's block of the front-padded horizon: stage s is real stage s - pad
    src = (stages - pad).clamp(min=0)
    real = stages >= pad

    def block(x, pad_val):
        mask = real.reshape((blk,) + (1,) * (x.ndim - 1))
        return torch.where(mask, x[src], pad_val)

    local_in = _KFElement(*(block(e, i) for e, i in zip(elems, ident)))
    ys_b, cs_b = block(ys, 0.0), block(cs, 0.0)

    # (1) local forward prefix scan
    local = associative_scan(
        lambda earlier, later: tuple(_kf_combine(_KFElement(*earlier), _KFElement(*later))),
        tuple(local_in))

    # (2) the block totals of every rank; fold the earlier ones into the prefix
    total = torch.cat([x[-1].reshape(-1) for x in local])              # 3n^2 + 2n floats
    gathered = [torch.empty_like(total) for _ in range(D)]
    dist.all_gather(gathered, total, group=mesh.group(axis))
    sizes = [n * n, n, n * n, n, n * n]
    prefix = ident
    for b in range(k):
        parts = torch.split(gathered[b], sizes)
        prefix = _kf_combine(prefix, _KFElement(*(p.reshape(i.shape)
                                                  for p, i in zip(parts, ident))))

    # (3) the global prefix of every local stage: the filtered moments
    pre_blk = _KFElement(*(x.expand((blk,) + x.shape) for x in prefix))
    glob = _kf_combine(pre_blk, _KFElement(*local))
    xs_f, Ps_f = glob.b, glob.C

    # (4) stage-local recovery: the boundary state is the prefix's (b, C); the
    # first real stage predicts from the prior (x0, P0), its prefix being the
    # identity padding, whose (b, C) are zeros
    xs_prev = torch.cat([prefix.b[None], xs_f[:-1]])
    Ps_prev = torch.cat([prefix.C[None], Ps_f[:-1]])
    first = stages == pad
    xs_prev = torch.where(first[:, None], x0, xs_prev)
    Ps_prev = torch.where(first[:, None, None], P0, Ps_prev)
    xs_p, Ps_p, lls = _kf_predict_ll(A, C, Q, R, xs_prev, Ps_prev, ys_b, cs_b)
    ll = torch.sum(torch.where(real, lls, 0.0))
    dist.all_reduce(ll, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return KalmanResult(means=xs_f[keep], covs=Ps_f[keep], pred_means=xs_p[keep],
                        pred_covs=Ps_p[keep], log_likelihood=ll)
