"""Griffin-Lim phase recovery through the hand-written CUDA kernels.

Port of the JAX package's ``dsp/pallas_gl.py``: TPU kernel K4
(``_make_gl_call_fused``, every iteration behind one call, momentum) and
TPU kernel K5 (``_make_gl_call``, ``inner=1``: one iteration per call, the
spectrum in and out through device memory as separate re and im arrays, no
momentum), each in the bf16 mode (``lowp=True``, the default as in the JAX
package) and the f32 mode.

For CUDA tensors the wrappers run ``csrc/griffin_lim.cu``: three launches
per iteration (synthesis product, overlap-add + normalise, analysis product
with the magnitude projection and momentum in its epilogue), and in the
bf16 mode of the streaming kernel a fourth that packs the planar input into
the interleaved carrier. The bf16 mode runs both products on the tensor
cores, with every operand K-major and zero-padded to ``PAD`` columns
(``padded_bases``; the carriers and the analysis operand likewise). For CPU
tensors they run the plain versions below, ``gl_step_reference`` and
``gl_spectrum_reference``, which keep the kernel's rounding points. The
zero-phase start and the final iSTFT (``istft_mm``, f32) are plain in both
cases, as the final iSTFT is XLA in JAX.

Rounding points of the bf16 mode (those of the TPU kernel's iteration
body): the carried spectrum and the previous iterate are bf16; the momentum
extrapolation ``s + beta (s - prev)`` is formed in f32 from the bf16
carriers; both product operands and both DFT bases are rounded to bf16 and
accumulated in f32; the synthesis frames, the overlap-add, the
window-sum-square normalisation, the reflect padding and the magnitude
projection are f32; the projected spectrum is rounded to bf16. The TPU
kernel factors each DFT block into a shared positional matrix and a
per-chunk twiddle, so it rounds ``spectrum x twiddle`` and the positional
matrix to bf16; the port multiplies by the windowed DFT bases over the
window's nonzero span (``live_bases``) and rounds the spectrum and those
bases. Bit equality with the TPU kernel is therefore not the contract; the
tolerances in tests/test_torch_gl_lowp.py are.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.dsp.dft import (carrier_dtype, dft_matrices, gl_iterate, gl_iteration,
                                        inv_window_sumsquare, istft_mm, zero_phase)


def griffin_lim(magnitude, *, n_fft: int, hop_length: int, win_length: int,
                n_iter: int = 60, length: int | None = None,
                momentum: float = 0.0, inner: int | None = None,
                lowp: bool = True):
    """Magnitude (..., F, n_bins) -> waveform (..., hop*(F-1))."""
    re, im = griffin_lim_spectrum(magnitude, n_fft=n_fft, hop_length=hop_length,
                                  win_length=win_length, n_iter=n_iter,
                                  momentum=momentum, inner=inner, lowp=lowp)
    return istft_mm(re, im, n_fft, hop_length, win_length, length=length)


def griffin_lim_spectrum(magnitude, *, n_fft: int, hop_length: int,
                         win_length: int, n_iter: int = 60,
                         momentum: float = 0.0, inner: int | None = None,
                         lowp: bool = True):
    """``n_iter`` Griffin-Lim iterations from a zero-phase start ->
    (re, im) in f32, each shaped like ``magnitude``.

    ``inner``: iterations per kernel call. None runs them all behind one
    call (K4); 1 streams the spectrum through device memory once per
    iteration (K5) and takes no momentum."""
    if inner not in (None, 1):
        raise ValueError("the streaming kernel runs one iteration per call: "
                         "inner must be None or 1")
    if inner == 1 and momentum:
        raise ValueError("momentum requires inner=None")
    geo = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length, lowp=lowp)
    if inner is None:
        if magnitude.device.type == "cpu":
            re, im = gl_spectrum_reference(magnitude, n_iter=n_iter,
                                           momentum=momentum, **geo)
        else:
            re, im = _gl_cuda(magnitude, n_iter=n_iter, momentum=momentum, **geo)
    else:
        mag = magnitude.float()
        re, im = zero_phase(mag, lowp)
        plan = None if mag.device.type == "cpu" else _Plan(mag, **geo)
        for _ in range(n_iter):
            re, im = griffin_lim_step(re, im, mag, _plan=plan, **geo)
    return re.float(), im.float()


def griffin_lim_step(re, im, magnitude, *, n_fft: int, hop_length: int,
                     win_length: int, lowp: bool = True, _plan=None):
    """ONE Griffin-Lim iteration (K5): spectrum (re, im), each (..., F,
    n_bins) in the carrier dtype (bf16 with ``lowp``, else f32), plus the f32
    target magnitude -> the projected (re, im) in the carrier dtype."""
    sd = carrier_dtype(lowp)
    if re.dtype != sd or im.dtype != sd:
        raise TypeError(f"griffin_lim_step: spectrum must be {sd}, got {re.dtype}/{im.dtype}")
    if re.shape != magnitude.shape or im.shape != magnitude.shape:
        raise ValueError("griffin_lim_step: re, im and magnitude must have one shape")
    geo = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length, lowp=lowp)
    if magnitude.device.type == "cpu":
        return gl_step_reference(re, im, magnitude, **geo)
    return _gl_step_cuda(re, im, _plan or _Plan(magnitude, **geo))


@functools.lru_cache(maxsize=4)
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


# column padding of the bf16 mode's operands: kPad in csrc/griffin_lim.cu
PAD = 64


def padded(n: int) -> int:
    """``n`` rounded up to a multiple of ``PAD``."""
    return -(-n // PAD) * PAD


@functools.lru_cache(maxsize=4)
def padded_bases(n_fft: int, win_length: int):
    """The bf16 mode's product operands, K-major and zero-padded to PAD:
    (bwd_t (win_pad, S_pad) = bwd^T, fwd_t (S_pad, win_pad) = fwd^T) of
    ``live_bases``, S = 2*n_bins."""
    bwd, fwd = live_bases(n_fft, win_length)
    s, win = bwd.shape
    bwd_t = np.zeros((padded(win), padded(s)), np.float32)
    bwd_t[:win, :s] = bwd.T
    fwd_t = np.zeros((padded(s), padded(win)), np.float32)
    fwd_t[:s, :win] = fwd.T
    return bwd_t, fwd_t


# ------------------------------------------------------------ plain versions

def gl_step_reference(re, im, magnitude, *, n_fft: int, hop_length: int,
                      win_length: int, lowp: bool = True):
    """Plain PyTorch version of the streaming kernel: one iteration, no
    momentum, (re, im) in and out in the carrier dtype."""
    return gl_iteration(magnitude, n_fft, hop_length, win_length, lowp)(re, im)


def gl_spectrum_reference(magnitude, *, n_fft: int, hop_length: int,
                          win_length: int, n_iter: int = 60,
                          momentum: float = 0.0, lowp: bool = True):
    """Plain PyTorch version of the whole-loop kernel -> (re, im) in the
    carrier dtype."""
    return gl_iterate(magnitude, n_fft=n_fft, hop_length=hop_length,
                      win_length=win_length, n_iter=n_iter, momentum=momentum, lowp=lowp)


# ------------------------------------------------------------------ kernels

def tensor_core_smem_bytes() -> dict:
    """Dynamic shared memory of one block of each of the bf16 mode's two
    product kernels, bytes."""
    lib = runtime.load("griffin_lim")
    lib.tt_griffin_lim_smem.argtypes = [ctypes.c_int]
    lib.tt_griffin_lim_smem.restype = ctypes.c_int
    return {"synthesis": lib.tt_griffin_lim_smem(0), "analysis": lib.tt_griffin_lim_smem(1)}


class _Plan:
    """Device-side constants and scratch of one kernel call (or of one run
    of streaming calls on the same magnitude). ``e`` is the interleaved
    carrier (B*F, ld): in the bf16 mode ld = padded(2*n_bins), pad columns
    zero, and ``work`` is the analysis operand (B*F, padded(win)) bf16; in
    the f32 mode ld = 2*n_bins and ``work`` is the signal (B, L) f32."""

    def __init__(self, magnitude, n_fft, hop_length, win_length, lowp):
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
        sd = carrier_dtype(lowp)
        self.dev, self.batch, self.f, self.nb, self.sd = dev, batch, f, nb, sd
        self.b = math.prod(batch)
        self.m = self.b * f
        self.mag = magnitude.float().reshape(self.m, nb).contiguous()
        if lowp:
            bwd_np, fwd_np = padded_bases(n_fft, win_length)
            self.ld, win = padded(2 * nb), padded(win_length)
            self.work = torch.zeros(self.m, win, device=dev, dtype=sd)
        else:
            bwd_np, fwd_np = live_bases(n_fft, win_length)
            self.ld, win = 2 * nb, win_length
            self.work = torch.empty(self.b, hop_length * (f - 1), device=dev)
        self.bwd = torch.from_numpy(bwd_np).to(dev).to(sd)
        self.fwd = torch.from_numpy(fwd_np).to(dev).to(sd)
        self.e = torch.zeros(self.m, self.ld, device=dev, dtype=sd)
        self.invwss = inv_window_sumsquare(win_length, n_fft, hop_length, f, dev)
        self.frames = torch.empty(self.m, win, device=dev)
        self.dims = (self.b, f, nb, n_fft, hop_length, win_length)
        self.lowp = int(lowp)


def _gl_cuda(magnitude, *, n_fft, hop_length, win_length, n_iter, momentum, lowp):
    p = _Plan(magnitude, n_fft, hop_length, win_length, lowp)
    beta = float(momentum)
    # interleaved (re, im) per bin: e is the synthesis input (the start and,
    # with beta, each extrapolated iterate); s0/s1 hold the projected
    # iterates in turn
    e = p.e
    e[:, 0:2 * p.nb:2] = p.mag
    s0 = e.clone() if beta else None
    s1 = torch.zeros_like(e) if beta else None

    lib = runtime.load("griffin_lim")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tt_griffin_lim.argtypes = [vp] * 9 + [ci] * 8 + [ctypes.c_float, vp]
    lib.tt_griffin_lim.restype = ci
    with torch.cuda.device(p.dev):
        err = lib.tt_griffin_lim(
            p.mag.data_ptr(), e.data_ptr(),
            s0.data_ptr() if beta else None, s1.data_ptr() if beta else None,
            p.bwd.data_ptr(), p.fwd.data_ptr(), p.invwss.data_ptr(),
            p.frames.data_ptr(), p.work.data_ptr(),
            *p.dims, n_iter, p.lowp, beta, runtime.stream_ptr(p.dev))
    runtime.check(err, "griffin_lim kernel launch")
    runtime.LAUNCHES["griffin_lim"] += 3 * n_iter
    spec = (s1 if n_iter % 2 else s0) if beta else e
    re = spec[:, 0:2 * p.nb:2].reshape(*p.batch, p.f, p.nb)
    im = spec[:, 1:2 * p.nb:2].reshape(*p.batch, p.f, p.nb)
    return re, im


def _gl_step_cuda(re, im, p):
    if re.device != p.dev or im.device != p.dev:
        raise ValueError("griffin_lim_step: all inputs must be on one CUDA device")
    re, im = re.contiguous(), im.contiguous()
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)

    lib = runtime.load("griffin_lim")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tt_griffin_lim_step.argtypes = [vp] * 11 + [ci] * 7 + [vp]
    lib.tt_griffin_lim_step.restype = ci
    with torch.cuda.device(p.dev):
        err = lib.tt_griffin_lim_step(
            p.mag.data_ptr(), re.data_ptr(), im.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(),
            p.bwd.data_ptr(), p.fwd.data_ptr(), p.invwss.data_ptr(),
            p.frames.data_ptr(), p.work.data_ptr(), p.e.data_ptr(),
            *p.dims, p.lowp, runtime.stream_ptr(p.dev))
    runtime.check(err, "griffin_lim_step kernel launch")
    # bf16: the pack, then the iteration's three
    runtime.LAUNCHES["griffin_lim_step"] += 3 + p.lowp
    return out_re, out_im
