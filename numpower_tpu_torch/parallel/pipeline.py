"""Pipeline parallelism over the MPC horizon on torch.distributed (port of
numpower_tpu/parallel/pipeline.py).

The horizon (time) axis is mapped onto the ranks of one mesh axis: rank d
owns the stages [d blk, (d + 1) blk), and scenario microbatches flow through
the stage groups, each boundary state handed to the next rank. The JAX
package's ``lax.ppermute`` ring is one ``dist.batch_isend_irecv`` per
pipeline step here: every rank sends to (d + 1) % D and receives from
(d - 1) % D in the same call, so no rank waits on another before it posts
its own send. With M = D microbatches the schedule is 2D - 1 steps.

This engine is for LONG horizons (T in the thousands), where one device
cannot hold the whole unrolled horizon; for T = 30 one device wins. Any
(N, T) is accepted: the horizon is padded to a multiple of D with masked
identity stages and the batch to a multiple of D with zero scenarios, both
dropped before returning.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from numpower_tpu_torch.parallel.mesh import Mesh
from numpower_tpu_torch.utils.device import follow, state_tensor


def _ring_shift(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x of the previous rank along ``axis`` (ring order): this rank's x goes
    to the next one in the same call. At D = 1 the permutation is the
    identity and x stays local."""
    D = mesh.size(axis)
    if D == 1:
        return x.clone()
    group, i = mesh.group(axis), mesh.index(axis)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (i + 1) % D),
                      group=group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - 1) % D), group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def rollout_lti_pipelined(A, B, x0s, us, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """Horizon-pipelined batched LTI rollout x_{t+1} = A x_t + B u_t.

    Every rank takes the whole batch, x0s (N, n) and us (N, T, m), and
    returns its horizon block of the trajectories: the states x_{t+1} of its
    stages t, (N, T_d, n), rank 0's block led by x0s. The blocks concatenated
    along dim 1 in axis order are batched_rollout_lti's (N, T + 1, n).

    Rank d runs the stages of its block for microbatch j = k - d at pipeline
    step k (0 <= j < D), taking its entry states from rank d - 1 (rank 0
    from x0s) and handing its exit states to rank d + 1."""
    x0s = state_tensor(x0s)
    A, B, us = follow(x0s, A, B, us)
    D, d = mesh.size(axis), mesh.index(axis)
    N, T, m = us.shape
    n = A.shape[0]
    blk = -(-T // D)             # ceil(T / D) stages per rank
    micro = -(-N // D)           # ceil(N / D) scenarios per microbatch
    N_pad = micro * D
    dt, dev = x0s.dtype, x0s.device
    x0s_p = torch.zeros((N_pad, n), dtype=dt, device=dev)
    x0s_p[:N] = x0s
    # this rank's controls for its stages; a padded stage (t >= T) is identity
    t0 = d * blk
    stages = min(max(T - t0, 0), blk)
    us_blk = torch.zeros((N_pad, blk, m), dtype=dt, device=dev)
    us_blk[:N, :stages] = us[:, t0:t0 + stages]

    state = torch.zeros((micro, n), dtype=dt, device=dev)
    outs = torch.empty((N_pad, blk, n), dtype=dt, device=dev)
    for k in range(2 * D - 1):
        j = k - d
        active = 0 <= j < D
        if active:
            rows = slice(j * micro, (j + 1) * micro)
            x = x0s_p[rows] if d == 0 else state
            for t in range(stages):
                x = x @ A.T + us_blk[rows, t] @ B.T
                outs[rows, t] = x
            outs[rows, stages:] = x[:, None]  # padded stages pass the state through
            state = x
        # hand off to the next stage group (the ring; last -> 0 wraps harmlessly)
        state = _ring_shift(state, mesh, axis)
    out = outs[:N, :stages]
    return torch.cat([x0s[:, None], out], dim=1) if d == 0 else out
