"""L1 losses: mel + linear (paper §3.3).

Port of the JAX package's ``train/loss.py``. The paper trains on
zero-padded frames without masking; ``mask_padding`` averages over the
frames inside ``frame_len`` only.
"""

from __future__ import annotations

import torch


def tacotron_loss(mel_pred, linear_pred, mel_gt, linear_gt, frame_len=None,
                  mask_padding: bool = False, linear_weight: float = 1.0):
    """Returns (total, {mel_loss, linear_loss, total_loss})."""
    if mask_padding and frame_len is not None:
        t = mel_pred.shape[1]
        mask = (torch.arange(t, device=mel_pred.device)[None, :]
                < frame_len[:, None]).to(mel_pred.dtype)
        denom = torch.clamp_min(mask.sum(), 1.0)
        mel_l1 = ((mel_pred - mel_gt).abs().mean(-1) * mask).sum() / denom
        lin_l1 = ((linear_pred - linear_gt).abs().mean(-1) * mask).sum() / denom
    else:
        mel_l1 = (mel_pred - mel_gt).abs().mean()
        lin_l1 = (linear_pred - linear_gt).abs().mean()
    total = mel_l1 + linear_weight * lin_l1
    return total, {"mel_loss": mel_l1, "linear_loss": lin_l1, "total_loss": total}
