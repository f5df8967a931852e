"""The device mesh, the port of the JAX package's ``parallel/mesh.py``.

JAX's mesh is a (data, model) grid of devices. The port runs one process
per device, so its mesh is a grid of processes: ``make_mesh`` lays the
process group's ranks out row-major on a (world // m, m) grid, the axes
``cfg.data_axis`` and ``cfg.model_axis``, and keeps one process group per
axis: the ranks of this rank's column (``data_group``) and of its row
(``model_group``). The batch is sharded over ``data`` (each rank holds its
rows: the loader's shard, ``shard_batch`` puts them on its device); the
tensor-parallel parameters (``parallel/sharding.py``) over ``model``.

A single process with no process group is a mesh of size 1 without
groups, and runs the same code as a pod slice: with no group there is no
reduction to run. Under a process group every reduction runs, over an axis
of size 1 too (a copy, which changes no bit).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tacotron_tpu_torch.config import MeshConfig
from tacotron_tpu_torch.parallel.collectives import capturable
from tacotron_tpu_torch.parallel.multihost import process_count, process_index, rank_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on the (data, model) grid.

    ``data_group`` holds the ranks that share this rank's model index (the
    ranks that split the batch), ``model_group`` those that share its data
    index (the ranks that split the sharded parameters); both are None
    without a process group."""

    cfg: MeshConfig
    data_size: int
    model_size: int
    data_index: int
    model_index: int
    device: torch.device
    data_group: object = None
    model_group: object = None

    @property
    def size(self) -> int:
        return self.data_size * self.model_size

    @property
    def capturable(self) -> bool:
        """Whether this mesh's collectives can go into a CUDA graph
        (``collectives.capturable``): NCCL groups, or none."""
        return capturable(self.data_group, self.model_group)

    def batch_shard(self, generator: torch.Generator):
        """``generator`` as dropout draws it on this mesh (an
        ``ops.modules.BatchShard``): the masks of the global batch, this
        rank's rows kept."""
        from tacotron_tpu_torch.ops.modules import BatchShard

        return BatchShard(generator, self.data_index, self.data_size)


def make_mesh(cfg: MeshConfig = MeshConfig(), platform: str = "cuda") -> Mesh:
    """The mesh of the current process group (or of this one process).
    Raises ValueError when the world does not divide by
    ``model_parallel_size``."""
    world, m = process_count(), cfg.model_parallel_size
    if world % m:
        raise ValueError(f"{world} devices not divisible by model_parallel_size={m}")
    device = rank_device(platform)
    if not dist.is_initialized():
        return Mesh(cfg, 1, 1, 0, 0, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)   # NCCL groups are made on the current card
    d, rank = world // m, process_index()
    grid = [[i * m + j for j in range(m)] for i in range(d)]
    # every rank creates every group, as torch.distributed requires
    data_group, _ = dist.new_subgroups_by_enumeration([[row[j] for row in grid]
                                                       for j in range(m)])
    model_group, _ = dist.new_subgroups_by_enumeration(grid)
    return Mesh(cfg, d, m, rank // m, rank % m, device, data_group, model_group)


def shard_batch(batch, mesh: Mesh):
    """Put this rank's batch (the loader's shard, a tuple of arrays or
    tensors) on the rank's device. Unlike JAX, nothing is assembled into a
    global array: each rank keeps its rows."""
    return tuple(torch.as_tensor(a).to(mesh.device, non_blocking=True) for a in batch)
