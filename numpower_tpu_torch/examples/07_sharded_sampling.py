"""Sharded sampling solvers: MPPI over scenarios x samples, the particle
filter with its cloud sharded over the ranks (the port of
examples/07_sharded_sampling.py).

Both are mesh-shape-invariant: every rank draws the whole random tensor from
a generator seeded as the single-device solver's and takes its block, so the
sharded result equals the single-device solver (up to the order of the
collectives' sums) at any mesh shape. The mesh follows the world size: (4, 2)
at eight ranks, (D, 1) otherwise, (1, 1) alone. Run from the repository
root, alone (world size 1 over a FileStore in a temporary directory) or
under torchrun (gloo on the CPU, NCCL with one card a rank):
    PYTHONPATH=. python numpower_tpu_torch/examples/07_sharded_sampling.py [--device cpu]
    PYTHONPATH=. torchrun --nproc-per-node 8 numpower_tpu_torch/examples/07_sharded_sampling.py \
        --device cpu
"""

import argparse
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from numpower_tpu_torch.models import (
    mppi_solve_batched, particle_filter, pendulum_step, quadratic_mppi_cost,
)
from numpower_tpu_torch.parallel import (
    initialize, make_mesh, mppi_solve_dp, particle_filter_dp, shard_batch,
)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(parser.parse_args().device)
backend = "nccl" if dev.type == "cuda" else "gloo"

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
        world = dist.get_world_size()
        shape = (4, 2) if world >= 8 else (world, 1)
        mesh = make_mesh(shape, device=dev)
        lead = dist.get_rank() == 0
        if mesh is not None:
            if lead:
                print(f"mesh: {dict(zip(mesh.axis_names, mesh.shape))}")

            # --- MPPI: 32 pendulum swing-up scenarios, 256 samples ------------
            cost_fn = quadratic_mppi_cost(np.diag([1.0, 0.1]), np.eye(1) * 0.01,
                                          np.diag([100.0, 10.0]), np.zeros(2))
            rng = np.random.default_rng(0)
            x0s_all = torch.as_tensor(rng.uniform(-math.pi, math.pi, (32, 2)),
                                      dtype=torch.float32, device=dev)
            kw = dict(samples=256, iters=8, m=1, u_lo=-2.0, u_hi=2.0)
            res = mppi_solve_dp(pendulum_step, shard_batch(x0s_all, mesh), cost_fn, 40,
                                torch.Generator(device=dev).manual_seed(0), mesh, **kw)
            ref = mppi_solve_batched(pendulum_step, x0s_all, cost_fn, 40,
                                     torch.Generator(device=dev).manual_seed(0), method="xla",
                                     **kw)
            n_loc = res.us.shape[0]
            mine = slice(mesh.coords[0] * n_loc, (mesh.coords[0] + 1) * n_loc)
            dev_max = (res.us - ref.us[mine]).abs().max()
            dist.all_reduce(dev_max, op=dist.ReduceOp.MAX, group=mesh.group(("data", "model")))
            cost_sum = res.cost.sum()
            dist.all_reduce(cost_sum, group=mesh.group("data"))
            if lead:
                print(f"MPPI: mean cost {float(cost_sum) / 32:.2f}, "
                      f"max dev vs single-device {float(dev_max):.1e}")

            # --- Particle filter: 4096 particles sharded over the data axis ---
            T = 50
            ys = torch.as_tensor(0.3 * rng.standard_normal((T, 1)), dtype=torch.float32,
                                 device=dev)
            us = torch.zeros((T, 1), device=dev)
            args = (pendulum_step, lambda x: x[..., :1], torch.eye(2, device=dev) * 1e-3,
                    torch.eye(1, device=dev) * 1e-2, torch.tensor([0.4, 0.0], device=dev),
                    torch.eye(2, device=dev) * 0.1, ys, us)
            pf = particle_filter_dp(*args, torch.Generator(device=dev).manual_seed(0), mesh,
                                    n_particles=4096, axis="data")
            pf_ref = particle_filter(*args, torch.Generator(device=dev).manual_seed(0),
                                     n_particles=4096)
            if lead:
                print(f"PF: log-lik {float(pf.log_likelihood):.2f} "
                      f"(single-device {float(pf_ref.log_likelihood):.2f}), "
                      f"min ESS {float(pf.ess.min()):.0f}/4096")
    finally:
        dist.destroy_process_group()
