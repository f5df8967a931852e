"""Parameter sharding rules, the port of the JAX package's
``parallel/sharding.py``.

Data parallelism is the main strategy; the ``model`` axis lets the widest
products shard when ``model_parallel_size`` > 1. The rules are JAX's,
matched by the suffix of the port's state-dict names (``weights.py`` maps
the JAX paths to them):

* ``postnet.linear_proj.weight`` / ``.bias`` (256 -> n_freq, the widest
  projection): split by output unit (JAX's column sharding of the kernel);
* ``encoder.embed.embedding`` (vocab x 256): split by row;
* everything else replicated.

A parameter is split only where its dimension divides by the model size.
Adam's moments follow their parameters (they are created on the local
shards). ``shard_model`` cuts a model's parameters to this rank's shards and
swaps in the mesh forms of the two split layers and of the batch norms
(``parallel/layers.py``); ``full_tensor`` and ``local_slice`` move a
sharded tensor between its full and its local form (checkpoints, eval).
"""

from __future__ import annotations

import torch

from tacotron_tpu_torch.models.encoder import Embed
from tacotron_tpu_torch.ops.modules import BatchNorm, Dense
from tacotron_tpu_torch.parallel.collectives import all_gather_cat
from tacotron_tpu_torch.parallel.layers import ColumnParallelDense, RowShardedEmbed, SyncBatchNorm

# state-dict suffix -> the dimension split over the model axis
RULES = {
    "postnet.linear_proj.weight": 0,
    "postnet.linear_proj.bias": 0,
    "encoder.embed.embedding": 0,
}


def spec_for(name: str, shape, axis_size: int) -> int | None:
    """The dimension of parameter ``name`` split over a model axis of
    ``axis_size``, or None (replicated)."""
    if axis_size <= 1 or len(shape) == 0:
        return None
    for suffix, dim in RULES.items():
        if name.endswith(suffix) and shape[dim] % axis_size == 0:
            return dim
    return None


def tree_shardings(named_shapes: dict, mesh) -> dict:
    """{name: split dimension or None} for ``{name: shape}`` (parameters or
    their Adam moments) on ``mesh``."""
    return {k: spec_for(k, tuple(s), mesh.model_size) for k, s in named_shapes.items()}


def _swap(model: torch.nn.Module, name: str, new: torch.nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent), leaf, new)


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Prepare ``model`` (full parameters, the same on every rank) for
    ``mesh``, in place: keep this rank's shard of each split parameter, swap
    in the column-parallel ``Dense`` and the row-sharded embedding over the
    model group for the split layers, and the global batch statistics over
    the data group for every batch norm. Records the mesh and the splits as
    ``model.mesh`` and ``model.tp_shards``."""
    shapes = {k: p.shape for k, p in model.named_parameters()}
    splits = {k: d for k, d in tree_shardings(shapes, mesh).items() if d is not None}
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, dim in splits.items():
            owner, leaf = name.rsplit(".", 1)
            p = getattr(modules[owner], leaf)
            n = p.shape[dim] // mesh.model_size
            p.data = p.data.narrow(dim, mesh.model_index * n, n).clone()
    for owner in {k.rsplit(".", 1)[0] for k in splits}:
        mod = modules[owner]
        if isinstance(mod, Dense):
            _swap(model, owner, ColumnParallelDense.of(mod, mesh.model_group))
        elif isinstance(mod, Embed):
            rows = mod.embedding.shape[0]
            _swap(model, owner, RowShardedEmbed.of(mod, mesh.model_group, mesh.model_index * rows))
        else:
            raise TypeError(f"no tensor-parallel form of {type(mod).__name__} ({owner})")
    if mesh.data_group is not None:
        for name, mod in modules.items():
            if isinstance(mod, BatchNorm):
                _swap(model, name, SyncBatchNorm.of(mod, mesh.data_group))
    model.mesh = mesh
    model.tp_shards = splits
    return model


def full_tensor(model: torch.nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` (parameter ``name``'s local shard, or a tensor shaped like it)
    as the full tensor: gathered over the model group when ``name`` is
    split. Collective: every rank of the group calls it."""
    dim = getattr(model, "tp_shards", {}).get(name)
    if dim is None:
        return t
    return all_gather_cat(t.detach(), model.mesh.model_group, dim=dim)


def local_slice(model: torch.nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the full tensor ``full`` of parameter ``name``."""
    dim = getattr(model, "tp_shards", {}).get(name)
    if dim is None:
        return full
    n = full.shape[dim] // model.mesh.model_size
    return full.narrow(dim, model.mesh.model_index * n, n).contiguous()
