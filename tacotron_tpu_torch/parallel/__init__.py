"""Port of tacotron_tpu.parallel: the mesh, its batch placement and the
multi-process control plane, on ``torch.distributed`` with one process per
device."""

from tacotron_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from tacotron_tpu_torch.parallel import multihost

__all__ = ["Mesh", "make_mesh", "shard_batch", "multihost"]
