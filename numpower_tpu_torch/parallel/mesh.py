"""Device mesh construction (port of numpower_tpu/parallel/mesh.py).

The JAX package names a ``jax.sharding.Mesh`` of devices with axes

    data  - MPC scenarios (DP)
    model - QP / condensed-matrix blocks (TP)

and places arrays on it by PartitionSpecs. Here a mesh is a grid of the ranks
of ``torch.distributed``, one device per rank, and the process groups along
its axes: rank r sits at (data index, model index) = (r // M, r % M) of a
(D, M) mesh, as the JAX package's row-major device grid. A rank holds its
own block of every sharded array (what each device's body sees under
``shard_map``); :func:`place` cuts that block out of a global array by a
spec, and the collectives of parallel/sharding.py run over the axis groups.

The specs are tuples, as PartitionSpecs: entry k names the mesh axis (or a
tuple of axes) that splits dimension k of the array, None leaves it whole;
:func:`data_sharding`, :func:`model_sharding` and :func:`replicated` build
the JAX package's three.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from numpower_tpu_torch.utils.config import config


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (D, M) grid of ranks."""

    shape: Tuple[int, int]
    axis_names: Tuple[str, str]
    rank: int
    coords: Tuple[int, int]  # this rank's (data index, model index)
    device: torch.device     # this rank's device
    groups: dict             # axis name, and the tuple of both, -> this rank's process group

    def size(self, axes) -> int:
        """Ranks along ``axes`` (an axis name or a tuple of them)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return _prod(self.shape[self.axis_names.index(a)] for a in axes)

    def index(self, axes) -> int:
        """This rank's index along ``axes``, the later axis varying fastest."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            k = self.axis_names.index(a)
            i = i * self.shape[k] + self.coords[k]
        return i

    def group(self, axes):
        """The process group of the ranks that share this rank's coordinates
        off ``axes``."""
        return self.groups[(axes,) if isinstance(axes, str) else tuple(axes)]


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Optional[Tuple[str, str]] = None,
              device: Optional[torch.device] = None,
              devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """Build a (data, model) mesh over the ranks of the default process
    group (parallel/distributed.initialize, or ``init_process_group``).

    shape=None takes ``utils.config.mesh_shape``, and where that is None
    puts every rank on the data axis (scenario parallelism is the dominant
    axis for MPC sweeps); the axis names default to the config's. Raises ValueError when the shape
    needs more ranks than the group has. Every rank must call it (the axis
    groups are made collectively); a rank beyond the shape's ranks gets
    None. device: this rank's device, by default ``cuda:(rank % cards)``
    on an NCCL group and the CPU otherwise. devices (the JAX package's
    argument): one device for each rank of the group, rank r taking
    ``devices[r]``; ValueError where its length is not the group's size,
    TypeError where device is given too."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call "
                           "parallel.distributed.initialize (or init_process_group) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if devices is not None:
        if device is not None:
            raise TypeError("pass this rank's device= or every rank's devices=, not both")
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a group of {world} ranks: "
                             "devices= takes one device for each rank")
        device = devices[rank]
    axis_names = tuple(axis_names or (config.data_axis, config.model_axis))
    shape = tuple(shape or config.mesh_shape or (world, 1))
    D, M = shape
    if D * M > world:
        raise ValueError(f"mesh shape {shape} needs {D * M} devices, have {world}")
    # every rank makes every group, in one order (new_group is collective)
    data_groups = [dist.new_group([i * M + j for i in range(D)]) for j in range(M)]
    model_groups = [dist.new_group([i * M + j for j in range(M)]) for i in range(D)]
    mesh_group = dist.new_group(list(range(D * M)))
    if rank >= D * M:
        return None
    i, j = divmod(rank, M)
    if device is None:
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
    groups = {(axis_names[0],): data_groups[j], (axis_names[1],): model_groups[i],
              axis_names: mesh_group}
    return Mesh(shape=shape, axis_names=axis_names, rank=rank, coords=(i, j),
                device=torch.device(device), groups=groups)


def data_sharding(mesh: Mesh) -> tuple:
    """Scenario-batched arrays: leading axis over the data mesh axis."""
    return (mesh.axis_names[0],)


def model_sharding(mesh: Mesh, axis: int = 0) -> tuple:
    """Block matrices: the given axis over the model mesh axis."""
    return (None,) * axis + (mesh.axis_names[1],)


def replicated(mesh: Mesh) -> tuple:
    return ()


def place(x, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of the global array ``x`` under ``spec``, as a
    contiguous tensor on the rank's device (a numpy ``x`` as float32). Each
    split dimension must divide evenly, as the JAX package's shardings
    require."""
    x = torch.as_tensor(x, dtype=x.dtype if isinstance(x, torch.Tensor) else torch.float32,
                        device=mesh.device)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        parts, k = mesh.size(axes), mesh.index(axes)
        if x.shape[dim] % parts:
            raise ValueError(f"dimension {dim} of shape {tuple(x.shape)} does not split "
                             f"into {parts} blocks over {axes}")
        x = x.narrow(dim, k * (x.shape[dim] // parts), x.shape[dim] // parts)
    return x.contiguous()


def shard_batch(x, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of the rows of a scenario batch, on the
    rank's device: the placement of the JAX package's shard_batch."""
    return place(x, mesh, data_sharding(mesh))
