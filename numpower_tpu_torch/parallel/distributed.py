"""Multi-process runtime setup (port of numpower_tpu/parallel/distributed.py).

The JAX package wires its multi-host runtime with ``jax.distributed``; here
the runtime is ``torch.distributed``: one process per device, NCCL between
CUDA devices and gloo on the CPU. The solvers of parallel/sharding.py are
written against a mesh (parallel/mesh.py) and run unchanged on one rank or
many; only the process group differs.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def default_backend() -> str:
    """NCCL where there is a card, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Initialize the default process group (idempotent).

    With an explicit coordinator ("host:port", or an init method URL such as
    "tcp://localhost:29500" or "file:///path"), num_processes and
    process_id, every failure propagates: a silently single-process
    "cluster" is the worst failure mode (every process solves the full
    problem and collectives never cross processes). With no arguments the
    cluster comes from the environment that torch's launchers set (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); where none is set, no cluster is
    found and the process runs alone, with no group."""
    if dist.is_initialized():
        return
    backend = backend or default_backend()
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=init, world_size=num_processes,
                                rank=process_id)
        return
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return  # no cluster found: run locally
    dist.init_process_group(backend)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multi_host() -> bool:
    return process_count() > 1


def local_scenario_slice(n_total: int) -> slice:
    """Which slice of a global scenario batch this process owns (for
    process-local data loading that feeds a data-axis block)."""
    per = n_total // process_count()
    start = per * process_index()
    return slice(start, start + per)


def scaling_report(solves_per_sec_1chip: float, solves_per_sec_now: float) -> dict:
    """Scaling efficiency against linear (BASELINE: >= 85% at 2+ hosts); one
    device per process."""
    n = process_count()
    ideal = solves_per_sec_1chip * n
    eff = solves_per_sec_now / ideal if ideal > 0 else 0.0
    return {
        "devices": n,
        "processes": n,
        "solves_per_sec": solves_per_sec_now,
        "ideal": ideal,
        "efficiency": eff,
    }
