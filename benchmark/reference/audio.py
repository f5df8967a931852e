"""Plain PyTorch and NumPy audio for the reference: normalised linear
spectrogram to magnitude, Griffin-Lim (Griffin and Lim 1984; with
momentum, Perraudin et al. 2013) from a zero phase, and the checks a
waveform can be held to.

The transforms follow librosa's conventions: a periodic Hann window of
``win_length`` centred in ``n_fft``, frames centre-padded by reflection,
the inverse normalised by the window's sum of squares. They are products
with DFT matrices made here in float64, so the rounding of their operands
(``model.Precision``) applies to them as to every other product.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import F32, Precision


def magnitude(linear, a: dict):
    """Normalised linear spectrogram -> the magnitude Griffin-Lim inverts:
    denormalise, dB to amplitude, raised to ``griffin_lim_power``."""
    db = torch.clamp(linear, 0.0, 1.0) * -a["min_level_db"] + a["min_level_db"] + a["ref_level_db"]
    return torch.pow(torch.pow(10.0, db * 0.05), a["griffin_lim_power"])


def normalized_spectrogram(y, a: dict):
    """Waveform (B, samples) -> the normalised linear spectrogram the model
    emits: pre-emphasis, |STFT|, dB above ``ref_level_db``, scaled from
    ``min_level_db`` to 0 onto [0, 1]."""
    y = torch.cat([y[:, :1], y[:, 1:] - a["preemphasis"] * y[:, :-1]], -1)
    re, im = Stft(a, y.device).analysis(y)
    db = 20.0 * torch.log10(torch.clamp(torch.sqrt(re * re + im * im), min=1e-5)) - a["ref_level_db"]
    return torch.clamp((db - a["min_level_db"]) / -a["min_level_db"], 0.0, 1.0)


class Stft:
    """Analysis and synthesis over the window's nonzero samples."""

    def __init__(self, a: dict, device, p: Precision = F32):
        n_fft, win, self.hop = a["n_fft"], a["win_length"], a["hop_length"]
        self.n_fft, self.win, self.p = n_fft, win, p
        self.lpad = (n_fft - win) // 2
        n = np.arange(win)[:, None] + self.lpad
        k = np.arange(n_fft // 2 + 1)[None, :]
        ang = 2.0 * np.pi * n * k / n_fft
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
        self.window = w
        fwd = np.concatenate([np.cos(ang), -np.sin(ang)], 1) * w[:, None]
        wk = np.full(k.shape[1], 2.0)
        wk[0] = wk[-1] = 1.0
        bwd = np.concatenate([np.cos(ang).T * wk[:, None], -np.sin(ang).T * wk[:, None]], 0)
        bwd = bwd / n_fft * w[None, :]
        self.fwd = torch.from_numpy(fwd).float().to(device)       # (win, 2 n_bins)
        self.bwd = torch.from_numpy(bwd).float().to(device)       # (2 n_bins, win)
        self.nb = k.shape[1]

    def analysis(self, y):
        """(B, samples) -> (re, im), each (B, frames, n_bins)."""
        pad = self.n_fft // 2
        y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = y.unfold(-1, self.n_fft, self.hop)[..., self.lpad:self.lpad + self.win]
        out = self.p(frames) @ self.p(self.fwd)
        return out[..., :self.nb], out[..., self.nb:]

    def synthesis(self, re, im):
        """(re, im) (B, F, n_bins) -> (B, hop (F - 1)) samples."""
        b, f, _ = re.shape
        frames = self.p(torch.cat([re, im], -1)) @ self.p(self.bwd)       # (B, F, win)
        total = self.n_fft + self.hop * (f - 1)
        y = frames.new_zeros(b, total)
        wss = np.zeros(total)
        w2 = self.window ** 2
        for i in range(f):
            s = i * self.hop + self.lpad
            wss[s:s + self.win] += w2
        idx = (torch.arange(f, device=re.device)[:, None] * self.hop + self.lpad
               + torch.arange(self.win, device=re.device)[None, :])
        y.index_add_(1, idx.reshape(-1), frames.reshape(b, -1))
        y = y / torch.from_numpy(np.maximum(wss, 1e-11)).float().to(re.device)
        pad = self.n_fft // 2
        return y[:, pad:total - pad]


def griffin_lim(mag, a: dict, n_iter: int, momentum: float, p: Precision = F32):
    """``n_iter`` projections from a zero phase -> (re, im) whose magnitude
    is ``mag``: x = s + momentum (s - s_prev), s = mag X / max(|X|, 1e-8)
    with X the analysis of the synthesis of x."""
    st = Stft(a, mag.device, p)
    re, im = mag.clone(), torch.zeros_like(mag)
    prev = (re, im)
    for _ in range(n_iter):
        xr = re + momentum * (re - prev[0])
        xi = im + momentum * (im - prev[1])
        o_re, o_im = st.analysis(st.synthesis(xr, xi))
        scale = mag / torch.clamp(torch.sqrt(o_re * o_re + o_im * o_im), min=1e-8)
        prev = (re, im)
        re, im = o_re * scale, o_im * scale
    return re, im


def spectral_convergence(y, mag, a: dict, preemphasis: float | None):
    """Per row, ||S(y)| - c mag| / |c mag| with S the analysis of ``y`` and
    c the least-squares scale (a waveform scaled to its peak keeps no
    absolute level). ``preemphasis`` given: ``y`` is a served waveform,
    filtered back through pre-emphasis first (the exact inverse of the
    de-emphasis synthesis ends with)."""
    y = y.float()
    if preemphasis is not None:
        y = torch.cat([y[:, :1], y[:, 1:] - preemphasis * y[:, :-1]], -1)
    re, im = Stft(a, y.device).analysis(y)
    s = torch.sqrt(re * re + im * im).double()
    m = mag.double()
    c = (s * m).sum((1, 2)) / (m * m).sum((1, 2)).clamp_min(1e-300)
    cm = c[:, None, None] * m
    return ((s - cm).norm(dim=(1, 2)) / cm.norm(dim=(1, 2)).clamp_min(1e-300)).float()


def end_frames(mel: np.ndarray, threshold: float, min_run: int) -> np.ndarray:
    """Per row the first frame t with frames [t, t + min_run) all peaking
    below ``threshold``, else the frame count."""
    b, t, _ = mel.shape
    silent = mel.max(-1) < threshold
    out = np.full(b, t, np.int64)
    for i in range(b):
        run = 0
        for j in range(t):
            run = run + 1 if silent[i, j] else 0
            if run == min_run:
                out[i] = j - min_run + 1
                break
    return out
