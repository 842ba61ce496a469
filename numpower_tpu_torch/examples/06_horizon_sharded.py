"""Horizon-sharded (sequence-parallel) solvers: the time axis over the ranks
(the port of examples/06_horizon_sharded.py).

Two engines for LONG horizons:

 1. riccati_associative_sharded: backward Riccati with the horizon sharded
    across the ranks (a two-level suffix scan; one all_gather of the block
    totals per solve);
 2. rollout_lti_pipelined: batched forward rollouts pipelined through the
    horizon's stage groups (microbatches handed rank to rank).

Each rank returns its horizon block; the blocks are gathered here to print
the whole result. Run from the repository root, alone (world size 1 over a
FileStore in a temporary directory) or under torchrun (gloo on the CPU,
NCCL with one card a rank):
    PYTHONPATH=. python numpower_tpu_torch/examples/06_horizon_sharded.py [--device cpu]
    PYTHONPATH=. torchrun --nproc-per-node 4 numpower_tpu_torch/examples/06_horizon_sharded.py \
        --device cpu
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from numpower_tpu_torch.models import batched_rollout_lti, double_integrator, riccati_scan
from numpower_tpu_torch.parallel import (
    initialize, make_mesh, riccati_associative_sharded, rollout_lti_pipelined,
)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(parser.parse_args().device)
backend = "nccl" if dev.type == "cuda" else "gloo"


def gather(block: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The ranks' blocks of the model axis (sizes may differ), concatenated."""
    group = mesh.group("model")
    sizes = [None] * mesh.size("model")
    dist.all_gather_object(sizes, block.shape[dim], group=group)
    width = max(sizes)
    padded = torch.zeros(block.shape[:dim] + (width,) + block.shape[dim + 1:],
                         dtype=block.dtype, device=block.device)
    padded.narrow(dim, 0, block.shape[dim]).copy_(block)
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)


with tempfile.TemporaryDirectory() as tmp:
    if "RANK" in os.environ:  # under torchrun
        initialize(backend=backend)
    else:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
    if dev.type == "cuda":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    try:
        D = min(dist.get_world_size(), 8)
        mesh = make_mesh((1, D), device=dev)
        lead = dist.get_rank() == 0
        A, B = (torch.as_tensor(M, device=dev) for M in double_integrator(0.05))
        Q = torch.eye(2, device=dev)
        R = torch.eye(1, device=dev) * 0.1
        QF = torch.eye(2, device=dev) * 10.0

        # --- 1. horizon-sharded Riccati ----------------------------------------
        T = 64 * D
        Ks_blk, _ = riccati_associative_sharded(A, B, Q, R, QF, T, mesh)
        Ks_sh = gather(Ks_blk, mesh, 0)
        Ks, _ = riccati_scan(A, B, Q, R, QF, T)
        if lead:
            print(f"sharded Riccati T={T} over {D} ranks: "
                  f"max|dK| = {float((Ks_sh - Ks).abs().max()):.2e}")

        # --- 2. pipelined rollout (ragged shapes welcome) -----------------------
        rng = np.random.default_rng(0)
        N, T_roll = 13, 123            # deliberately not multiples of D
        x0s = torch.as_tensor(rng.standard_normal((N, 2)), dtype=torch.float32, device=dev)
        us = torch.as_tensor(0.1 * rng.standard_normal((N, T_roll, 1)), dtype=torch.float32,
                             device=dev)
        xs = gather(rollout_lti_pipelined(A, B, x0s, us, mesh), mesh, 1)
        ref = batched_rollout_lti(A, B, x0s, us)
        if lead:
            print(f"pipelined rollout N={N} T={T_roll}: full trajectories {tuple(xs.shape)}, "
                  f"max err = {float((xs - ref).abs().max()):.2e}")
    finally:
        dist.destroy_process_group()
