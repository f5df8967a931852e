"""Framing, windowing and overlap-add for the STFT, and the FFT transforms.

Port of the JAX package's ``dsp/stft.py`` (the forward transform feeds
preprocessing, the inverse synthesis), and of its ``dsp/griffin_lim.py`` (the ``"fft"`` Griffin-Lim backend
over ``torch.fft``; the JAX package computes these transforms outside any
kernel too). Conventions follow librosa's, as the reference did: centre-padded
(reflect), periodic Hann window of ``win_length`` zero-padded (centred) to
``n_fft``, one-sided transform.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (sym=False) Hann window, as librosa/scipy ``hann``."""
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Window centred in an n_fft-long buffer: ``lpad = (n_fft - win)//2``
    zeros on the left (librosa pad_center)."""
    lpad = (n_fft - win_length) // 2
    w = np.zeros(n_fft)
    w[lpad:lpad + win_length] = hann_window(win_length)
    return w


def num_frames(n_samples: int, hop_length: int) -> int:
    """The frame count of a centre-padded signal of ``n_samples``."""
    return n_samples // hop_length + 1


def frame_signal(y, n_fft: int, hop_length: int, center: bool = True):
    """(..., T) -> (..., frames, n_fft) overlapping frames; ``center``
    reflect-pads by n_fft//2 first."""
    if center:
        pad = n_fft // 2
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad),
                  mode="reflect").reshape(*lead, -1)
    return y.unfold(-1, n_fft, hop_length)


def overlap_add(frames_t, hop_length: int):
    """OLA: (..., F, n_fft) -> (..., n_fft + hop*(F-1)) as m = ceil(n_fft /
    hop) shifted adds of hop-sized chunks (a fixed summation order)."""
    *batch, f, n_fft = frames_t.shape
    m = -(-n_fft // hop_length)
    fr = F.pad(frames_t, (0, m * hop_length - n_fft)).reshape(*batch, f, m, hop_length)
    out = frames_t.new_zeros(*batch, f + m, hop_length)
    for j in range(m):
        out[..., j:j + f, :] += fr[..., :, j, :]
    total = n_fft + hop_length * (f - 1)
    return out.reshape(*batch, (f + m) * hop_length)[..., :total]


def window_sumsquare(win_length: int, n_fft: int, hop_length: int,
                     n_frames: int) -> np.ndarray:
    """Sum over frames of the squared window, (n_fft + hop*(F-1),), f64."""
    win = padded_window(win_length, n_fft)
    total = n_fft + hop_length * (n_frames - 1)
    wss = np.zeros(total)
    for f in range(n_frames):
        wss[f * hop_length:f * hop_length + n_fft] += win * win
    return wss


def _window(win_length: int, n_fft: int, like):
    from tacotron_tpu_torch.dsp.dft import device_constant   # dft imports this module
    return device_constant("padded window", like.device, lambda: torch.from_numpy(
        padded_window(win_length, n_fft).astype(np.float32)), n_fft=n_fft, win_length=win_length)


def stft(y, n_fft: int, hop_length: int, win_length: int, center: bool = True):
    """Complex STFT. (..., T) -> (..., frames, n_fft//2 + 1)."""
    frames = frame_signal(y.float(), n_fft, hop_length, center=center)
    return torch.fft.rfft(frames * _window(win_length, n_fft, y), n=n_fft, dim=-1)


def stft_magnitude(y, n_fft: int, hop_length: int, win_length: int,
                   center: bool = True):
    """|STFT|. (..., T) -> (..., frames, n_fft//2 + 1), f32."""
    return stft(y, n_fft, hop_length, win_length, center=center).abs()


def istft(spec, n_fft: int, hop_length: int, win_length: int,
          length: int | None = None):
    """Inverse STFT with window-sum-square normalisation: (..., frames,
    n_fft//2 + 1) complex -> (..., hop*(frames-1)) real (or ``length``)."""
    win = _window(win_length, n_fft, spec)
    frames_t = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    n_frames = spec.shape[-2]
    pad = n_fft // 2
    total = n_fft + hop_length * (n_frames - 1)
    wss = overlap_add((win * win).expand(n_frames, n_fft), hop_length)
    y = overlap_add(frames_t, hop_length) / torch.clamp(wss, min=1e-11)
    y = y[..., pad:total - pad]
    if length is not None:
        n = y.shape[-1]
        y = F.pad(y, (0, length - n)) if n < length else y[..., :length]
    return y


def gl_spectrum_fft(magnitude, *, n_fft: int, hop_length: int, win_length: int,
                    n_iter: int = 60):
    """Classic Griffin-Lim over the FFT pair, from zero phase: iSTFT ->
    STFT, keep the phase, re-impose the magnitude. Returns the complex
    spectrum. No momentum, as in the JAX package."""
    mag = magnitude.float()
    spec = mag.to(torch.complex64)
    for _ in range(n_iter):
        rebuilt = stft(istft(spec, n_fft, hop_length, win_length),
                       n_fft, hop_length, win_length)
        spec = mag * (rebuilt / torch.clamp(rebuilt.abs(), min=1e-8))
    return spec


def griffin_lim(magnitude, *, n_fft: int, hop_length: int, win_length: int,
                n_iter: int = 60, length: int | None = None):
    """Magnitude (..., frames, n_bins) -> waveform, all through the FFT."""
    spec = gl_spectrum_fft(magnitude, n_fft=n_fft, hop_length=hop_length,
                           win_length=win_length, n_iter=n_iter)
    return istft(spec, n_fft, hop_length, win_length, length=length)
