"""The mesh forms of three layers, which ``sharding.shard_model`` swaps in
for the plain ones: the same parameters and state-dict names, each holding
its process groups.

* ``ColumnParallelDense``: the post-net's ``linear_proj`` with its output
  units split over the model group; this rank's units, then every rank's
  gathered along the last axis. Backward, the input's gradient is summed
  over the group and each rank keeps its units' gradient.
* ``RowShardedEmbed``: the character table with its rows split over the
  model group; this rank looks up the ids it owns, zeros the rest, and the
  group sums.
* ``SyncBatchNorm``: the batch statistics of the global batch, split over
  the data group in equal shards: each rank's E[x] and E[x^2], scaled by
  1/ranks and summed over the group (with their gradient), as flax reduces
  over the whole sharded batch under GSPMD; every rank updates its running
  statistics from the global ones.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tacotron_tpu_torch.models.encoder import Embed
from tacotron_tpu_torch.ops.modules import BatchNorm, Dense, dense
from tacotron_tpu_torch.parallel import collectives


def _variant(cls, base: torch.nn.Module, **attrs):
    """``base`` as an instance of its subclass ``cls`` (the same parameters,
    buffers and settings) with ``attrs`` added."""
    new = cls.__new__(cls)
    new.__dict__.update(base.__dict__)
    new.__dict__.update(attrs)
    return new


class ColumnParallelDense(Dense):
    @classmethod
    def of(cls, base: Dense, group):
        return _variant(cls, base, group=group)

    def forward(self, x):
        y = dense(collectives.copy_to_group(x, self.group), self.weight, self.bias,
                  self.compute_dtype)
        return collectives.gather_last_dim(y, self.group)


class RowShardedEmbed(Embed):
    @classmethod
    def of(cls, base: Embed, group, row_offset: int):
        return _variant(cls, base, group=group, row_offset=row_offset)

    def forward(self, ids):
        table = self.embedding
        local = ids - self.row_offset
        owned = (local >= 0) & (local < table.shape[0])
        e = F.embedding(local.clamp(0, table.shape[0] - 1), table)
        return collectives.reduce_from_group(torch.where(owned[..., None], e, 0.0), self.group)


class SyncBatchNorm(BatchNorm):
    @classmethod
    def of(cls, base: BatchNorm, group):
        return _variant(cls, base, group=group)

    def moments(self, xf, axes):
        local = torch.stack(super().moments(xf, axes))
        return collectives.all_reduce_sum(local * (1.0 / dist.get_world_size(self.group)),
                                          self.group)
