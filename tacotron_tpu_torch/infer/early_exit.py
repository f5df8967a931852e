"""Early-exit decode and per-utterance end frames from silence (Tacotron
has no stop token).

Port of the JAX package's ``infer/early_exit.py``: ``decode_while``, a
feed-previous decode that stops once every utterance of the batch has been
silent long enough, and ``end_frames`` / ``end_frames_device``, the
per-utterance end-frame detector used for wav trimming and for the slice
before Griffin-Lim.
"""

from __future__ import annotations

import numpy as np
import torch

from tacotron_tpu_torch.ops.decode_loop import DecoderWeights, packed_decoder_step


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


def decode_while(memory, keys, mask, w: DecoderWeights, generator=None, *,
                 n_steps: int, r: int, n_mels: int, dropout_rate: float = 0.0,
                 silence_threshold: float = 0.05, min_silence_steps: int = 3):
    """Feed-previous decode with silence early exit, in f32 over the packed
    decoder weights (the step of the fused decode's plain version).

    memory (B, T_in, D_mem), keys (B, T_in, attn_dim), mask (B, T_in) bool;
    bf16 keys (bf16 compute) are widened, as JAX's f32 loop promotes them.
    Returns (mel (B, n_steps*r, n_mels), alignments (B, n_steps, T_in),
    steps_done). The loop stops after the step at which every row's
    ``silent_run`` (consecutive steps whose r frames all peak below
    ``silence_threshold``) has reached ``min_silence_steps``; frames and
    alignments past the exit step are zero. ``silence_threshold < 0``
    never exits and gives the fixed-length decode. Prenet dropout draws
    from ``generator``.

    The exit test reads one flag from the device per step: the host drives
    this loop, as it drives the step-by-step decoder.
    """
    b, t_in, _ = memory.shape
    if w.f_w.shape[0] != r * n_mels:
        raise ValueError(f"frame projection width {w.f_w.shape[0]} != r * n_mels "
                         f"({r} * {n_mels})")
    state, step = packed_decoder_step(memory, keys, mask, w, dropout_rate=dropout_rate,
                                      lowp=False, generator=generator)
    frames_buf = memory.new_zeros(b, n_steps, r * n_mels)
    aligns_buf = memory.new_zeros(b, n_steps, t_in)
    silent_run = torch.zeros(b, dtype=torch.int64, device=memory.device)
    t = 0
    while t < n_steps:
        state, frames, align = step(state)
        frames_buf[:, t] = frames
        aligns_buf[:, t] = align
        t += 1
        silent = frames.amax(dim=-1) < silence_threshold
        silent_run = torch.where(silent, silent_run + 1, torch.zeros_like(silent_run))
        if bool((silent_run >= min_silence_steps).all()):
            break
    return frames_buf.reshape(b, n_steps * r, n_mels), aligns_buf, t
