"""Griffin-Lim phase recovery through the hand-written CUDA kernels.

Port of the JAX package's ``dsp/pallas_gl.py``: TPU kernel K4
(``_make_gl_call_fused``, every iteration behind one call, momentum) and
TPU kernel K5 (``_make_gl_call``, ``inner=1``: one iteration per call, the
spectrum in and out through device memory as separate re and im arrays, no
momentum), each in the bf16 mode (``lowp=True``, the default as in the JAX
package) and the f32 mode.

For CUDA tensors the wrappers run ``csrc/griffin_lim.cu``: three launches
per iteration (synthesis product, overlap-add + normalise + frame, analysis
product with the magnitude projection and momentum in its epilogue), and in
the streaming kernel a fourth that packs the planar input into the
interleaved carrier. Both modes run both products on the tensor cores,
with every operand K-major and zero-padded to ``PAD`` columns
(``padded_bases``; the carriers and the analysis operand likewise): the
bf16 mode in one pass, the f32 mode as five TF32 products of operands
split into TF32 pieces (three of the spectrum side, two of the basis;
``split_tf32``; ``tf32_split_matmul`` is its plain version), as exact as
an f32 product. For CPU
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
from tacotron_tpu_torch.dsp.dft import (carrier_dtype, device_constant, dft_matrices, gl_iterate,
                                        gl_iteration, inv_window_sumsquare, istft_mm, zero_phase)


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
    """The kernels' basis operands, K-major and zero-padded to PAD, f32:
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
                      win_length: int, lowp: bool = True, product=torch.matmul):
    """Plain PyTorch version of the streaming kernel: one iteration, no
    momentum, (re, im) in and out in the carrier dtype. ``product`` takes
    both DFT products (``f64_matmul``, ``tf32_split_matmul`` for precision
    studies)."""
    return gl_iteration(magnitude, n_fft, hop_length, win_length, lowp, product)(re, im)


def gl_spectrum_reference(magnitude, *, n_fft: int, hop_length: int,
                          win_length: int, n_iter: int = 60,
                          momentum: float = 0.0, lowp: bool = True, product=torch.matmul):
    """Plain PyTorch version of the whole-loop kernel -> (re, im) in the
    carrier dtype; ``product`` as ``gl_step_reference``'s."""
    return gl_iterate(magnitude, n_fft=n_fft, hop_length=hop_length,
                      win_length=win_length, n_iter=n_iter, momentum=momentum, lowp=lowp,
                      product=product)


# ------------------------------------- the f32 mode's split TF32 products

# depth of one k-tile of the f32 mode's products: 32 f32 values fill one
# 128-byte swizzled row (BK of the f32 tile in csrc/griffin_lim.cu)
TF32_K_TILE = 32
# TF32 pieces of the spectrum-side operand and of the DFT basis: kPiecesA and
# kPiecesB in csrc/griffin_lim.cu (tests/test_torch_split_tf32.py holds the
# two equal). Three represent any normal f32 value exactly, two keep 22 of
# its 24 significant bits
TF32_PIECES = (3, 2)


def tf32_round(x):
    """f32 ``x`` rounded to TF32 (10 explicit mantissa bits) to nearest even:
    the low 13 bits of the result are zero. Inf and NaN pass unchanged."""
    u = x.float().contiguous().view(torch.int32)
    # int32 arithmetic wraps; the carry out of the mantissa is the rounding up
    r = (u + (0xFFF + ((u >> 13) & 1))) & -0x2000
    return torch.where((u & 0x7F800000) == 0x7F800000, u, r).view(torch.float32)


def split_tf32(x, pieces: int = 2):
    """f32 ``x`` -> ``pieces`` TF32 values, each tf32_round of what the
    earlier ones leave. Two (big, small) keep 22 of f32's 24 significant
    bits (big + small is x within 2^-22 of |x|); three sum to x exactly."""
    out, rest = [], x.float()
    for _ in range(pieces):
        out.append(tf32_round(rest))
        rest = rest - out[-1]
    return tuple(out)


def tf32_split_matmul(x, w):
    """Plain version of the f32 mode's products: ``x @ w`` (f32) as the
    kernel takes it on the tensor cores. x is split into TF32_PIECES[0] TF32
    pieces, the basis w into TF32_PIECES[1]; each TF32_K_TILE-deep k-tile
    sums the products of pieces i of x and j of w with i + j <= 2 (each
    product of two TF32 values is exact in f32), the smallest first, and is
    added to the f32 result with one rounded add per k-tile, in k order."""
    *lead, k = x.shape
    t = -(-k // TF32_K_TILE)
    pad = t * TF32_K_TILE - k
    # (k-tile, rows, depth) and (k-tile, depth, cols): one batched product per
    # pair of pieces gives every k-tile's sum
    xt = torch.nn.functional.pad(x.reshape(-1, k).float(), (0, pad))
    xt = xt.reshape(-1, t, TF32_K_TILE).transpose(0, 1)
    wt = torch.nn.functional.pad(w.float(), (0, 0, 0, pad)).reshape(t, TF32_K_TILE, -1)
    xp, wp = split_tf32(xt, TF32_PIECES[0]), split_tf32(wt, TF32_PIECES[1])
    pairs = [(i, o - i) for o in (2, 1, 0) for i in range(len(xp)) if 0 <= o - i < len(wp)]
    part = None
    for i, j in pairs:
        term = torch.bmm(xp[i], wp[j])
        part = term if part is None else part + term
    acc = part[0]
    for p in part[1:]:
        acc = acc + p
    return acc.reshape(*lead, -1)


def f64_matmul(x, w):
    """``x @ w`` summed in f64 and rounded once to f32: the products'
    exact answer for precision studies."""
    return (x.double() @ w.double()).float()


# ------------------------------------------------------------------ kernels

def tensor_core_smem_bytes() -> dict:
    """Dynamic shared memory of one block of each product kernel, bytes,
    by mode."""
    lib = runtime.load("griffin_lim")
    lib.tt_griffin_lim_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tt_griffin_lim_smem.restype = ctypes.c_int
    return {mode: {"synthesis": lib.tt_griffin_lim_smem(0, lowp),
                   "analysis": lib.tt_griffin_lim_smem(1, lowp)}
            for mode, lowp in (("bf16", 1), ("f32", 0))}


@functools.lru_cache(maxsize=4)
def split_padded_bases(n_fft: int, win_length: int, pieces: int):
    """The f32 mode's basis operands: each of ``padded_bases`` as its
    ``pieces`` TF32 pieces, (pieces, rows, cols) f32."""
    return tuple(torch.stack(split_tf32(torch.from_numpy(b), pieces)).numpy()
                 for b in padded_bases(n_fft, win_length))


class _Plan:
    """Device-side constants (the bases and the inverse window sum-square,
    kept per device by ``device_constant``) and scratch of one kernel call
    (or of one run of streaming calls on the same magnitude). ``e`` is the
    interleaved carrier (B*F, padded(2*n_bins)) in the storage type, pad columns zero;
    ``work`` the analysis operand (B*F, padded(win)), pad columns zero;
    ``frames`` the synthesis frames (B*F, padded(win)) f32."""

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
        pieces = None if lowp else TF32_PIECES[1]
        geo = dict(n_fft=n_fft, win_length=win_length, dtype=sd, pieces=pieces)

        def basis(i):
            return lambda: torch.from_numpy(
                padded_bases(n_fft, win_length)[i] if lowp else
                split_padded_bases(n_fft, win_length, pieces)[i]).to(sd)

        self.ld, win = padded(2 * nb), padded(win_length)
        self.work = torch.zeros(self.m, win, device=dev, dtype=sd)
        self.bwd = device_constant("kernel synthesis basis", dev, basis(0), **geo)
        self.fwd = device_constant("kernel analysis basis", dev, basis(1), **geo)
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
    # the pack, then the iteration's three
    runtime.LAUNCHES["griffin_lim_step"] += 4
    return out_re, out_im
