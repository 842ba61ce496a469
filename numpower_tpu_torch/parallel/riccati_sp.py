"""Horizon-sharded parallel-in-time Riccati on torch.distributed (port of
numpower_tpu/parallel/riccati_sp.py).

models/lqr.riccati_associative parallelizes time within one device (an
O(log T) associative scan); this module shards the horizon across the ranks
of one mesh axis, for horizons long enough (thousands of stages) that one
device's scan or its (T, n, n) element stack dominates.

A two-level suffix scan over the conditional-value-function elements
(F, C, J) of models/lqr.py:

  1. local:  each rank runs the reverse associative scan over its
             contiguous stage block: per-stage local suffixes and the block's
             total composition;
  2. global: the block totals are gathered (one all_gather of 3 D n^2
             floats over the axis group) and each rank folds the totals of
             the LATER blocks and the terminal element (0, 0, QF) into its
             after-block suffix S;
  3. apply:  one combine of each local suffix with S gives the global suffix
             and with it P_t; the gains come from the (R + B'PB)^{-1} B'PA
             solve over the block.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from numpower_tpu_torch.models.lqr import _RiccatiElement, _combine, _psd_solve, _tensors
from numpower_tpu_torch.parallel.mesh import Mesh
from numpower_tpu_torch.utils.associative_scan import associative_scan


def horizon_block(T: int, mesh: Mesh, axis: str, device):
    """(blk, pad, stages, keep): the stages per rank, ceil(T / D), the
    identity stages padded at the front, this rank's stage indices in the
    padded horizon (pad + t is real stage t) on ``device``, and the slice of
    its block that holds real stages (padding comes first, so a suffix)."""
    D, k = mesh.size(axis), mesh.index(axis)
    blk = -(-T // D)
    pad = blk * D - T
    first_real = min(max(pad - k * blk, 0), blk)
    return blk, pad, torch.arange(k * blk, (k + 1) * blk, device=device), slice(first_real, blk)


def riccati_associative_sharded(A, B, Q, R, QF, horizon: int, mesh: Mesh,
                                axis: str = "model"):
    """Backward Riccati with the horizon sharded over ``axis``.

    Every rank takes the whole (replicated) problem and returns its stage
    block (Ks (T_k, m, n), Ps (T_k, n, n)) of models/lqr.riccati_scan's
    result; the rank that holds the last block also appends Ps[T] = QF, so
    the blocks concatenated in axis order are riccati_scan's (Ks (T, m, n),
    Ps (T + 1, n, n)) to fp32 tolerance. Any T is accepted: where D does not
    divide T the horizon is padded at the FRONT with the combine's identity
    element (F = I, C = 0, J = 0), which leaves every real stage's suffix
    unchanged, and the padded stages are dropped (a rank may keep none)."""
    A, B, Q, R, QF = _tensors(A, B, Q, R, QF)
    n = A.shape[-1]
    D, k = mesh.size(axis), mesh.index(axis)
    blk, pad, stages, keep = horizon_block(int(horizon), mesh, axis, A.device)
    real = (stages >= pad)[:, None, None]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    zero = torch.zeros_like(eye)

    # (1) this rank's stage elements and their local reverse suffix scan
    # (as in riccati_associative, fn is called as fn(later, earlier))
    C_stage = B @ _psd_solve(R, B.T)
    elems = tuple(torch.where(real, x, pad_val).expand(blk, n, n)
                  for x, pad_val in ((A, eye), (C_stage, zero), (Q, zero)))
    local = associative_scan(
        lambda later, earlier: _combine(_RiccatiElement(*earlier), _RiccatiElement(*later)),
        elems, reverse=True)

    # (2) the block totals of every rank; fold the later ones and the terminal
    totals = torch.stack([x[0] for x in local])                       # (3, n, n)
    gathered = [torch.empty_like(totals) for _ in range(D)]
    dist.all_gather(gathered, totals, group=mesh.group(axis))
    S = _RiccatiElement(zero, zero, QF)
    for b in range(D - 1, k, -1):
        S = _combine(_RiccatiElement(*gathered[b]), S)

    # (3) the global suffix of every local stage -> P_t, then the gains
    S_blk = _RiccatiElement(*(x.expand(blk, n, n) for x in S))
    P_blk = _combine(_RiccatiElement(*local), S_blk).J               # (blk, n, n)
    P_next = torch.cat([P_blk[1:], S.J[None]])
    BtP = B.T @ P_next
    K_blk = _psd_solve(R + BtP @ B, BtP @ A)                         # (blk, m, n)
    Ks, Ps = K_blk[keep], P_blk[keep]
    if k == D - 1:
        Ps = torch.cat([Ps, QF[None]])
    return Ks, Ps
