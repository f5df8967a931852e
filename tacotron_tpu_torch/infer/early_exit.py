"""Per-utterance end frames from silence (no stop token in Tacotron).

Port of ``end_frames`` and ``end_frames_device`` from the JAX package's
``infer/early_exit.py``; the early-exit decode (``decode_while``) is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def end_frames(mel: np.ndarray, threshold: float = 0.05,
               min_run: int = 12) -> np.ndarray:
    """Per-utterance end frame from a normalized mel (B, T, n_mels): the
    first frame t such that frames [t, t + min_run) ALL have peak value <
    threshold, or T if no such run exists."""
    mel = np.asarray(mel)
    b, t, _ = mel.shape
    silent = mel.max(axis=-1) < threshold
    if t < min_run:
        return np.full((b,), t, np.int64)
    c = np.concatenate([np.zeros((b, 1), np.int64),
                        np.cumsum(silent, axis=1)], axis=1)
    run_all = (c[:, min_run:] - c[:, :-min_run]) == min_run
    idx = np.argmax(run_all, axis=1)
    return np.where(run_all.any(axis=1), idx, t)


def end_frames_device(mel: torch.Tensor, threshold: float = 0.05,
                      min_run: int = 12) -> torch.Tensor:
    """``end_frames`` on the tensor's device, so only the (B,) result has to
    reach the host."""
    b, t, _ = mel.shape
    if t < min_run:
        return torch.full((b,), t, dtype=torch.int64, device=mel.device)
    silent = (mel.amax(dim=-1) < threshold).long()
    c = torch.nn.functional.pad(torch.cumsum(silent, dim=1), (1, 0))
    run_all = (c[:, min_run:] - c[:, :-min_run]) == min_run
    idx = torch.argmax(run_all.int(), dim=1)
    return torch.where(run_all.any(dim=1), idx, torch.full_like(idx, t))
