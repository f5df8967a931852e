"""Griffin-Lim phase recovery through the hand-written CUDA kernels.

Port of the JAX package's ``dsp/pallas_gl.py`` (TPU kernel K4,
``_make_gl_call_fused``), in its f32 mode (``lowp=False``: f32 products,
f32 accumulation, f32 carried spectrum). The JAX default on the TPU is the
bf16 mode, so the two differ in precision; the bf16 mode is not ported yet.

For CUDA tensors ``griffin_lim_spectrum`` runs ``csrc/griffin_lim.cu``:
three launches per iteration (synthesis product, overlap-add + normalise,
analysis product with the magnitude projection and momentum in its
epilogue). For CPU tensors it runs the plain version,
``dsp.dft.gl_spectrum_mm``. The zero-phase start and the final iSTFT
(``istft_mm``) are plain in both cases, as the final iSTFT is XLA in JAX.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.dsp.dft import dft_matrices, gl_spectrum_mm, istft_mm
from tacotron_tpu_torch.dsp.stft import window_sumsquare


def griffin_lim(magnitude, *, n_fft: int, hop_length: int, win_length: int,
                n_iter: int = 60, length: int | None = None,
                momentum: float = 0.0):
    """Magnitude (..., F, n_bins) -> waveform (..., hop*(F-1))."""
    re, im = griffin_lim_spectrum(magnitude, n_fft=n_fft, hop_length=hop_length,
                                  win_length=win_length, n_iter=n_iter,
                                  momentum=momentum)
    return istft_mm(re, im, n_fft, hop_length, win_length, length=length)


def griffin_lim_spectrum(magnitude, *, n_fft: int, hop_length: int,
                         win_length: int, n_iter: int = 60,
                         momentum: float = 0.0):
    """``n_iter`` Griffin-Lim iterations from a zero-phase start ->
    (re, im), each shaped like ``magnitude``."""
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length,
              n_iter=n_iter, momentum=momentum)
    if magnitude.device.type == "cpu":
        return gl_spectrum_mm(magnitude, **kw)
    return _gl_cuda(magnitude, **kw)


def live_bases(n_fft: int, win_length: int):
    """(bwd (2*n_bins, win), fwd (win, 2*n_bins)) restricted to the
    window's nonzero span, with (re, im) interleaved per bin."""
    fwd, bwd = dft_matrices(n_fft, win_length)
    nb = n_fft // 2 + 1
    lpad = (n_fft - win_length) // 2
    f = fwd[lpad:lpad + win_length]
    fwd_il = np.stack([f[:, :nb], f[:, nb:]], axis=-1).reshape(win_length, 2 * nb)
    bw = bwd[:, lpad:lpad + win_length]
    bwd_il = np.stack([bw[:nb], bw[nb:]], axis=1).reshape(2 * nb, win_length)
    return np.ascontiguousarray(bwd_il), np.ascontiguousarray(fwd_il)


def _gl_cuda(magnitude, *, n_fft, hop_length, win_length, n_iter, momentum):
    dev = magnitude.device
    if dev.type != "cuda":
        raise ValueError(f"griffin_lim: unsupported device {dev}")
    *batch, f, nb = magnitude.shape
    if nb != n_fft // 2 + 1:
        raise ValueError(f"griffin_lim: {nb} bins, expected {n_fft // 2 + 1}")
    pad = n_fft // 2
    if n_fft + hop_length * (f - 1) < 3 * pad + 1:
        min_frames = -(-(3 * pad + 1 - n_fft) // hop_length) + 1
        raise ValueError(f"signal too short to reflect-pad: need n_frames >= {min_frames}")
    b = math.prod(batch)
    m = b * f
    beta = float(momentum)
    mag = magnitude.float().reshape(m, nb).contiguous()
    bwd_np, fwd_np = live_bases(n_fft, win_length)
    bwd = torch.from_numpy(bwd_np).to(dev)
    fwd = torch.from_numpy(fwd_np).to(dev)
    wss = window_sumsquare(win_length, n_fft, hop_length, f).astype(np.float32)
    invwss = torch.from_numpy(1.0 / np.maximum(wss, np.float32(1e-11))).to(dev)
    e = torch.stack([mag, torch.zeros_like(mag)], dim=-1).reshape(m, 2 * nb)
    s0 = e.clone() if beta else None
    s1 = torch.empty_like(e) if beta else None
    frames = torch.empty(m, win_length, device=dev)
    sig = torch.empty(b, hop_length * (f - 1), device=dev)

    lib = runtime.load("griffin_lim")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tt_griffin_lim.argtypes = [vp] * 9 + [ci] * 7 + [ctypes.c_float, vp]
    lib.tt_griffin_lim.restype = ci
    with torch.cuda.device(dev):
        err = lib.tt_griffin_lim(
            mag.data_ptr(), e.data_ptr(),
            s0.data_ptr() if beta else None, s1.data_ptr() if beta else None,
            bwd.data_ptr(), fwd.data_ptr(), invwss.data_ptr(),
            frames.data_ptr(), sig.data_ptr(),
            b, f, nb, n_fft, hop_length, win_length, n_iter, beta,
            runtime.stream_ptr(dev))
    runtime.check(err, "griffin_lim kernel launch")
    runtime.LAUNCHES["griffin_lim"] += 3 * n_iter
    spec = (s1 if n_iter % 2 else s0) if beta else e
    re = spec[:, 0::2].reshape(*batch, f, nb)
    im = spec[:, 1::2].reshape(*batch, f, nb)
    return re, im
