"""Matmul-DFT STFT/iSTFT and the plain Griffin-Lim loop, in f32.

Port of the JAX package's ``dsp/dft.py`` (f32 mode). The 2048-point real
transforms are products against DFT matrices with the analysis window (and,
for synthesis, the window, 1/N and the one-sided weights) folded in, so
framing -> windowing -> transform is one product. These large products go
to ``torch.matmul``, as the JAX package left them to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tacotron_tpu_torch.dsp.stft import (frame_signal, overlap_add,
                                         padded_window, window_sumsquare)


def live_span(n_fft: int, win_length: int) -> tuple[int, int]:
    """128-aligned bounds of the window's nonzero samples [lpad,
    lpad + win_length): the only rows/columns of the DFT matrices that carry
    window mass."""
    lpad = (n_fft - win_length) // 2
    lo = lpad // 128 * 128
    hi = min(-(-(lpad + win_length) // 128) * 128, n_fft)
    return lo, hi


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """(analysis (n_fft, 2*n_bins) with the window folded in, synthesis
    (2*n_bins, n_fft) with window, 1/N and the one-sided weights folded in),
    numpy f32. Columns of the analysis matrix are [re bins | im bins]."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos, sin = np.cos(ang), np.sin(ang)
    win = padded_window(win_length, n_fft)
    # analysis: re = (x*win) @ cos, im = -(x*win) @ sin
    fwd = np.concatenate([cos * win[:, None], -sin * win[:, None]], axis=1)
    # synthesis: x[n] = (1/N) sum_k w_k (re_k cos - im_k sin), w = 2 except DC/Nyquist
    w = np.full(n_bins, 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    inv_re = (cos * w[None, :] / n_fft).T
    inv_im = (-sin * w[None, :] / n_fft).T
    bwd = np.concatenate([inv_re, inv_im], axis=0) * win[None, :]
    return fwd.astype(np.float32), bwd.astype(np.float32)


def stft_mm(y, n_fft: int, hop_length: int, win_length: int):
    """Matmul STFT -> (re, im), each (..., frames, n_bins)."""
    fwd, _ = dft_matrices(n_fft, win_length)
    lo, hi = live_span(n_fft, win_length)
    frames = frame_signal(y.float(), n_fft, hop_length)[..., lo:hi]
    out = frames @ torch.from_numpy(fwd[lo:hi]).to(y.device)
    n_bins = n_fft // 2 + 1
    return out[..., :n_bins], out[..., n_bins:]


def _inv_wss(win_length, n_fft, hop_length, n_frames, device):
    wss = window_sumsquare(win_length, n_fft, hop_length, n_frames)
    return torch.from_numpy(
        (1.0 / np.maximum(wss.astype(np.float32), 1e-11)).astype(np.float32)
    ).to(device)


def istft_mm(re, im, n_fft: int, hop_length: int, win_length: int,
             length: int | None = None):
    """Matmul iSTFT with window-sum-square OLA; (..., F, n_bins) pair ->
    (..., hop*(F-1)) samples (or ``length``)."""
    _, bwd = dft_matrices(n_fft, win_length)
    lo, hi = live_span(n_fft, win_length)
    spec = torch.cat([re, im], dim=-1).float()
    frames_t = spec @ torch.from_numpy(bwd[:, lo:hi]).to(spec.device)
    frames_t = torch.nn.functional.pad(frames_t, (lo, n_fft - hi))
    n_frames = frames_t.shape[-2]
    pad = n_fft // 2
    total = n_fft + hop_length * (n_frames - 1)
    y = overlap_add(frames_t, hop_length) * _inv_wss(
        win_length, n_fft, hop_length, n_frames, spec.device)
    y = y[..., pad:total - pad]
    if length is not None:
        n = y.shape[-1]
        y = (torch.nn.functional.pad(y, (0, length - n)) if n < length
             else y[..., :length])
    return y


def griffin_lim_mm(magnitude, *, n_fft: int, hop_length: int, win_length: int,
                   n_iter: int = 60, length: int | None = None,
                   momentum: float = 0.0):
    """Griffin-Lim phase recovery, then the final iSTFT -> waveform."""
    re, im = gl_spectrum_mm(magnitude, n_fft=n_fft, hop_length=hop_length,
                            win_length=win_length, n_iter=n_iter,
                            momentum=momentum)
    return istft_mm(re, im, n_fft, hop_length, win_length, length=length)


def gl_spectrum_mm(magnitude, *, n_fft: int, hop_length: int, win_length: int,
                   n_iter: int = 60, momentum: float = 0.0):
    """Griffin-Lim over the matmul transforms, f32 throughout: per
    iteration one synthesis product, OLA, window-sum-square normalise,
    centre reflect pad, one analysis product and the magnitude projection
    ``mag / max(|X|, 1e-8)``, from a zero-phase start. Returns the final
    spectrum (re, im), each shaped like ``magnitude``.

    ``momentum``: Fast Griffin-Lim (Perraudin et al. 2013) — the projection
    input is extrapolated as ``s + beta * (s - s_prev)``; 0.0 is vanilla GL.
    """
    mag = magnitude.float()
    beta = float(momentum)
    n_bins = n_fft // 2 + 1
    dev = mag.device
    fwd_np, bwd_np = dft_matrices(n_fft, win_length)
    fwd, bwd = torch.from_numpy(fwd_np).to(dev), torch.from_numpy(bwd_np).to(dev)
    *batch, f, _ = mag.shape
    mag2 = mag.reshape(-1, f, n_bins)
    inv_wss = _inv_wss(win_length, n_fft, hop_length, f, dev)
    pad = n_fft // 2

    def project(spec):
        y = overlap_add(spec @ bwd, hop_length) * inv_wss
        out = frame_signal(y[..., pad:-pad], n_fft, hop_length) @ fwd
        re, im = out[..., :n_bins], out[..., n_bins:]
        scale = mag2 / torch.clamp(torch.sqrt(re * re + im * im), min=1e-8)
        return torch.cat([re * scale, im * scale], dim=-1)

    spec = torch.cat([mag2, torch.zeros_like(mag2)], dim=-1)   # zero phase
    prev = spec
    for _ in range(n_iter):
        if beta:
            spec, prev = project(spec + beta * (spec - prev)), spec
        else:
            spec = project(spec)
    return (spec[..., :n_bins].reshape(*batch, f, n_bins),
            spec[..., n_bins:].reshape(*batch, f, n_bins))
