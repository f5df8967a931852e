"""Mel filterbank construction (Slaney-style, librosa-compatible).

The port's own copy of the JAX package's ``dsp/mel.py`` (numpy only): the
Slaney formula (linear below 1 kHz, log above; area-normalised triangles),
built once in numpy and applied as one (n_freq, n_mels) product, and its
pseudo-inverse (``mel_pinv``), which takes a mel spectrogram back to a
linear one where the model predicts only mels (Tacotron 2:
``dsp.audio.mel_to_linear``).
"""

from __future__ import annotations

import functools

import numpy as np


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) float32 Slaney-normalised triangular filterbank.
    Cached: the same array is returned to every caller, so do not write to it."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalisation: each triangle integrates to ~2/bandwidth.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_pinv(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """(n_fft//2 + 1, n_mels) float32: the Moore-Penrose pseudo-inverse of
    ``mel_filterbank``, computed in float64. The filterbank has full row
    rank, so filterbank @ pinv is the identity. Cached like
    ``mel_filterbank``."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax).astype(np.float64)
    return np.linalg.pinv(fb).astype(np.float32)
