"""Matmul-DFT STFT/iSTFT and the plain Griffin-Lim loop.

Port of the JAX package's ``dsp/dft.py``. The 2048-point real transforms
are products against DFT matrices with the analysis window (and, for
synthesis, the window, 1/N and the one-sided weights) folded in, so
framing -> windowing -> transform is one product. These large products go
to ``torch.matmul``, as the JAX package left them to XLA.

``lowp`` is the bf16 mode: both operands of every product are rounded to
bf16 and accumulated in f32 (a product of two bf16 values is exact in f32,
so an f32 product of the rounded operands is the same sum), and the
Griffin-Lim loop carries its spectrum, its synthesis frames, the
overlap-add and the window-sum-square division in bf16, with the rounding
points of the JAX loop. ``gl_iteration`` is the one f32 Griffin-Lim
iteration of the port (the f32 loop here and the plain version of the f32
kernels), and with ``lowp`` the plain version of the bf16 kernels.

The DFT bases, windows and window sum-squares are made on the host; each
reaches a device once, through ``device_constant``, and is kept there. A
CUDA graph can then capture any of these transforms: a capture cannot copy
from host memory, and would keep a temporary's address if it could.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.dsp.stft import (frame_signal, overlap_add,
                                         padded_window, window_sumsquare)

_CONSTANTS: dict = {}


def device_constant(name: str, device, make, *, n_fft: int, win_length: int,
                    hop_length: int | None = None, frames: int | None = None,
                    dtype: torch.dtype = torch.float32, pieces: int | None = None):
    """The host tensor ``make()`` on ``device``, made at first use and kept
    per (name, device, n_fft, win_length, hop_length, frames, dtype,
    pieces): the parameters that ``make`` reads. ``dtype`` is the dtype the
    constant was rounded through (``make`` does the rounding), ``pieces``
    the TF32 pieces it was split into. A CUDA constant is made outside any
    graph capture (``runtime.fill_outside_capture``): one eager call of a
    shape fills what its graph reads."""
    dev = torch.device(device)
    key = (name, dev, n_fft, win_length, hop_length, frames, dtype, pieces)
    t = _CONSTANTS.get(key)
    if t is None:
        if dev.type == "cuda":
            runtime.fill_outside_capture(f"the DSP constant {name} ({key[2:]})")
        t = _CONSTANTS[key] = make().to(dev)
    return t


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


def _dot(x, w, lowp: bool):
    """x @ w in f32; with ``lowp`` both operands are rounded to bf16 first."""
    if lowp:
        x, w = x.bfloat16(), w.bfloat16()
    return x.float() @ w.float()


def stft_mm(y, n_fft: int, hop_length: int, win_length: int, lowp: bool = False):
    """Matmul STFT -> (re, im), each (..., frames, n_bins)."""
    lo, hi = live_span(n_fft, win_length)
    fwd = device_constant("analysis basis, live span", y.device,
                          lambda: torch.from_numpy(dft_matrices(n_fft, win_length)[0][lo:hi]),
                          n_fft=n_fft, win_length=win_length)
    frames = frame_signal(y.float(), n_fft, hop_length)[..., lo:hi]
    out = _dot(frames, fwd, lowp)
    n_bins = n_fft // 2 + 1
    return out[..., :n_bins], out[..., n_bins:]


def stft_mm_magnitude(y, n_fft: int, hop_length: int, win_length: int):
    """|STFT| through the matmul STFT, sqrt(re^2 + im^2 + 1e-12), f32:
    (..., T) -> (..., frames, n_fft//2 + 1)."""
    re, im = stft_mm(y, n_fft, hop_length, win_length)
    return torch.sqrt(re * re + im * im + 1e-12)


def inv_window_sumsquare(win_length, n_fft, hop_length, n_frames, device):
    """1 / max(window sum-square, 1e-11) over the padded signal, f32."""
    def make():
        wss = window_sumsquare(win_length, n_fft, hop_length, n_frames)
        return torch.from_numpy(
            (1.0 / np.maximum(wss.astype(np.float32), 1e-11)).astype(np.float32))

    return device_constant("inverse window sum-square", device, make, n_fft=n_fft,
                           win_length=win_length, hop_length=hop_length, frames=n_frames)


def istft_mm(re, im, n_fft: int, hop_length: int, win_length: int,
             length: int | None = None, lowp: bool = False):
    """Matmul iSTFT with window-sum-square OLA; (..., F, n_bins) pair ->
    (..., hop*(F-1)) samples (or ``length``)."""
    lo, hi = live_span(n_fft, win_length)
    spec = torch.cat([re, im], dim=-1).float()
    bwd = device_constant("synthesis basis, live span", spec.device,
                          lambda: torch.from_numpy(dft_matrices(n_fft, win_length)[1][:, lo:hi]),
                          n_fft=n_fft, win_length=win_length)
    frames_t = _dot(spec, bwd, lowp)
    frames_t = torch.nn.functional.pad(frames_t, (lo, n_fft - hi))
    n_frames = frames_t.shape[-2]
    pad = n_fft // 2
    total = n_fft + hop_length * (n_frames - 1)
    y = overlap_add(frames_t, hop_length) * inv_window_sumsquare(
        win_length, n_fft, hop_length, n_frames, spec.device)
    y = y[..., pad:total - pad]
    if length is not None:
        n = y.shape[-1]
        y = (torch.nn.functional.pad(y, (0, length - n)) if n < length
             else y[..., :length])
    return y


def griffin_lim_mm(magnitude, *, n_fft: int, hop_length: int, win_length: int,
                   n_iter: int = 60, length: int | None = None,
                   lowp: bool = True, momentum: float = 0.0):
    """Griffin-Lim phase recovery, then the final iSTFT (f32) -> waveform."""
    re, im = gl_spectrum_mm(magnitude, n_fft=n_fft, hop_length=hop_length,
                            win_length=win_length, n_iter=n_iter, lowp=lowp,
                            momentum=momentum)
    return istft_mm(re, im, n_fft, hop_length, win_length, length=length)


def carrier_dtype(lowp: bool) -> torch.dtype:
    """The dtype in which a Griffin-Lim loop carries its spectrum."""
    return torch.bfloat16 if lowp else torch.float32


def zero_phase(mag, lowp: bool):
    """The zero-phase start (re, im) in the carrier dtype."""
    re = mag.to(carrier_dtype(lowp))
    return re, torch.zeros_like(re)


def gl_iteration(magnitude, n_fft: int, hop_length: int, win_length: int, lowp: bool,
                 product=torch.matmul):
    """``step(re, im, prev=None, momentum=0.0)``: one Griffin-Lim iteration
    on ``magnitude`` (..., F, n_bins) over the window's nonzero span:
    synthesis product, overlap-add, window-sum-square normalise, centre
    reflect pad, analysis product, projection ``mag / max(|X|, 1e-8)``.

    Without ``lowp`` everything is f32. With it the rounding points are the
    Griffin-Lim kernel's (``dsp/fused_gl.py``), not those of
    ``gl_spectrum_mm(lowp=True)``: (re, im) and ``prev`` are bf16 carriers,
    the extrapolation is formed in f32, both operands of both products are
    rounded to bf16, and everything between the products stays f32.

    ``product(x, w)`` takes both products (f32 operands, f32 result):
    ``torch.matmul`` here; the precision studies of ``dsp/fused_gl.py``
    pass an f64 sum or the split-TF32 emulation."""
    sd = carrier_dtype(lowp)
    mag = magnitude.float()
    dev = mag.device
    f, nb = mag.shape[-2:]
    lpad, pad = (n_fft - win_length) // 2, n_fft // 2
    fwd_np, bwd_np = dft_matrices(n_fft, win_length)
    geo = dict(n_fft=n_fft, win_length=win_length, dtype=sd)
    bwd = device_constant("synthesis basis, window", dev, lambda: torch.from_numpy(
        bwd_np[:, lpad:lpad + win_length]).to(sd).float(), **geo)
    fwd = device_constant("analysis basis, window", dev, lambda: torch.from_numpy(
        fwd_np[lpad:lpad + win_length]).to(sd).float(), **geo)
    inv_wss = inv_window_sumsquare(win_length, n_fft, hop_length, f, dev)

    def step(re, im, prev=None, momentum=0.0):
        x = torch.cat([re, im], dim=-1).float()
        if momentum:
            x = x + momentum * (x - torch.cat(prev, dim=-1).float())
        frames_t = product(x.to(sd).float(), bwd)
        frames_t = torch.nn.functional.pad(frames_t, (lpad, n_fft - win_length - lpad))
        y = overlap_add(frames_t, hop_length) * inv_wss
        seg = frame_signal(y[..., pad:-pad], n_fft, hop_length)[..., lpad:lpad + win_length]
        out = product(seg.to(sd).float(), fwd)
        o_re, o_im = out[..., :nb], out[..., nb:]
        scale = mag / torch.clamp(torch.sqrt(o_re * o_re + o_im * o_im), min=1e-8)
        return (o_re * scale).to(sd), (o_im * scale).to(sd)

    return step


def gl_iterate(magnitude, *, n_fft: int, hop_length: int, win_length: int,
               n_iter: int, momentum: float, lowp: bool, product=torch.matmul):
    """``n_iter`` steps of ``gl_iteration`` from a zero-phase start ->
    (re, im) in the carrier dtype."""
    step = gl_iteration(magnitude, n_fft, hop_length, win_length, lowp, product)
    cur = prev = zero_phase(magnitude.float(), lowp)
    for _ in range(n_iter):
        cur, prev = step(*cur, prev, float(momentum)), cur
    return cur


def gl_spectrum_mm(magnitude, *, n_fft: int, hop_length: int, win_length: int,
                   n_iter: int = 60, lowp: bool = True, momentum: float = 0.0):
    """Griffin-Lim over the matmul transforms: per iteration one synthesis
    product, OLA, window-sum-square normalise, centre reflect pad, one
    analysis product and the magnitude projection ``mag / max(|X|, 1e-8)``
    in f32, from a zero-phase start. Returns the final spectrum (re, im) in
    f32, each shaped like ``magnitude``.

    ``lowp`` (the default, as in the JAX package): bf16 bases and product
    operands with f32 accumulation; the synthesis frames, the overlap-add
    and the division by the window sum-square in bf16; the projected
    spectrum and the momentum extrapolation carried in bf16. Without it
    everything is f32: the loop of ``gl_iteration``.

    ``momentum``: Fast Griffin-Lim (Perraudin et al. 2013) — the projection
    input is extrapolated as ``s + beta * (s - s_prev)``; 0.0 is vanilla GL.
    """
    if not lowp:
        return gl_iterate(magnitude, n_fft=n_fft, hop_length=hop_length,
                          win_length=win_length, n_iter=n_iter, momentum=momentum,
                          lowp=False)
    mag = magnitude.float()
    beta = float(momentum)
    n_bins = n_fft // 2 + 1
    dev = mag.device
    cdtype = torch.bfloat16
    geo = dict(n_fft=n_fft, win_length=win_length)
    fwd = device_constant("analysis basis", dev,
                          lambda: torch.from_numpy(dft_matrices(n_fft, win_length)[0]), **geo)
    bwd = device_constant("synthesis basis", dev,
                          lambda: torch.from_numpy(dft_matrices(n_fft, win_length)[1]), **geo)
    *batch, f, _ = mag.shape
    mag2 = mag.reshape(-1, f, n_bins)
    pad = n_fft // 2
    # the JAX loop's own f32 window sum-square, rounded to bf16 and divided
    # by (not multiplied by its inverse)
    win = device_constant("padded window", dev, lambda: torch.from_numpy(
        padded_window(win_length, n_fft).astype(np.float32)), **geo)
    wss = overlap_add((win * win).expand(f, n_fft), hop_length)
    wss = torch.clamp(wss, min=1e-11).to(cdtype)

    def project(spec):
        frames_t = _dot(spec, bwd, True).to(cdtype)
        y = overlap_add(frames_t, hop_length) / wss
        out = _dot(frame_signal(y[..., pad:-pad], n_fft, hop_length), fwd, True)
        re, im = out[..., :n_bins], out[..., n_bins:]
        scale = mag2 / torch.clamp(torch.sqrt(re * re + im * im), min=1e-8)
        return torch.cat([re * scale, im * scale], dim=-1).to(cdtype)

    spec = torch.cat([mag2, torch.zeros_like(mag2)], dim=-1).to(cdtype)   # zero phase
    # beta itself is rounded to bf16, and the subtraction, the product and
    # the sum each round to bf16, as the JAX loop's bf16 arithmetic does
    beta_c = torch.tensor(beta, dtype=cdtype)
    prev = spec
    for _ in range(n_iter):
        if beta:
            spec, prev = project(spec + beta_c * (spec - prev)), spec
        else:
            spec = project(spec)
    spec = spec.float()
    return (spec[..., :n_bins].reshape(*batch, f, n_bins),
            spec[..., n_bins:].reshape(*batch, f, n_bins))
