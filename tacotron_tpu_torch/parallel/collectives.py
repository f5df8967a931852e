"""The collectives the parallel step and synthesis run, and their autograd.

Every function takes a process group (``torch.distributed``) and works on
tensors of either device: NCCL takes CUDA tensors; gloo, which the port
also uses for several ranks on one card, gets a host copy of a CUDA tensor
and the result is copied back. A group of one rank runs the collective all
the same (a copy), so a one-rank mesh computes the same bits as no mesh.

The three autograd functions are the tensor-parallel layers' halves
(``ops/modules.py``): ``copy_to_group`` (identity forward; the gradients
of the group's ranks summed backward) before a column-parallel product,
``gather_last_dim`` (the ranks' slices concatenated forward; this rank's
slice of the gradient backward) after it, and ``reduce_from_group`` (sum
forward; identity backward) after a row-sharded embedding.
``all_reduce_sum`` is a sum with the sum of the gradients backward, the
global batch statistics' reduction.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if _via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (each of ``t``'s shape) concatenated along
    ``dim`` in rank order, on ``t``'s device."""
    src = (t.cpu() if _via_host(t, group) else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[-1]
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n].contiguous(), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, group):
    return _AllReduceSum.apply(x, group)


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def gather_last_dim(x, group):
    return _GatherLastDim.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)
