"""L1 losses: mel + linear (paper §3.3).

Port of the JAX package's ``train/loss.py``. The paper trains on
zero-padded frames without masking; ``mask_padding`` averages over the
frames inside ``frame_len`` only.

With ``data_group`` (a mesh's, ``parallel/``) the batch is split in equal
shards over that group's ranks and the loss is the global batch's: each
rank returns its share of it (its mean over its rows divided by the
ranks, or with ``mask_padding`` its masked sum over the global count of
valid frames), whose gradients summed over the ranks are those of the
global loss, and the metrics summed over the group, the global values.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tacotron_tpu_torch.parallel import collectives


def tacotron_loss(mel_pred, linear_pred, mel_gt, linear_gt, frame_len=None,
                  mask_padding: bool = False, linear_weight: float = 1.0,
                  data_group=None):
    """Returns (total, {mel_loss, linear_loss, total_loss}); with
    ``data_group``, total is this rank's share and the metrics (detached)
    the global batch's."""
    if mask_padding and frame_len is not None:
        t = mel_pred.shape[1]
        mask = (torch.arange(t, device=mel_pred.device)[None, :]
                < frame_len[:, None]).to(mel_pred.dtype)
        count = mask.sum()
        if data_group is not None:
            count = collectives.all_reduce_(count, data_group)
        denom = torch.clamp_min(count, 1.0)
        mel_l1 = ((mel_pred - mel_gt).abs().mean(-1) * mask).sum() / denom
        lin_l1 = ((linear_pred - linear_gt).abs().mean(-1) * mask).sum() / denom
    else:
        mel_l1 = (mel_pred - mel_gt).abs().mean()
        lin_l1 = (linear_pred - linear_gt).abs().mean()
        if data_group is not None:
            share = 1.0 / dist.get_world_size(data_group)
            mel_l1, lin_l1 = mel_l1 * share, lin_l1 * share
    total = mel_l1 + linear_weight * lin_l1
    metrics = {"mel_loss": mel_l1, "linear_loss": lin_l1, "total_loss": total}
    if data_group is not None:
        summed = collectives.all_reduce_(torch.stack([mel_l1, lin_l1, total]).detach(),
                                         data_group)
        metrics = dict(zip(metrics, summed.unbind()))
    return total, metrics
