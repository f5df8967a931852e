"""Griffin-Lim (TPU kernel K4 port, f32 mode) and the synthesis DSP around
it; the bf16 mode is in tests/test_torch_gl_lowp.py.

The port's plain f32 Griffin-Lim (reached through the kernel wrapper with
``lowp=False``, which takes it for CPU tensors) vs the JAX Pallas kernel interpreted in f32
(``lowp=False``); ``istft_mm`` and ``inv_preemphasis`` vs JAX; an emulation
of the CUDA kernel's three stages (interleaved live-span bases, gather OLA,
reflect-by-index analysis, projection and momentum epilogue) vs the plain
loop. The bf16 mode's tensor-core layout: the padded K-major bases against
``live_bases``; a mirror of the overlap-add-and-frame launch against the
reflect framing of ``frame_signal`` (bit-identical, every slot written
once); and an emulation of the bf16 stages (padded carriers, f32 products
of bf16 operands, the mirror, the epilogue's roundings) against
``gl_step_reference`` / ``gl_spectrum_reference`` from a common state,
within one bf16 ulp (2^-7) of the magnitude's peak. The CUDA kernels
themselves are held against the plain loop in
tests/test_torch_kernels_cuda.py.

Small geometry n_fft 256 / hop 48 / win 190, as tests/unit/test_pallas_gl.py:
hop does not divide n_fft, win < n_fft, reflect edges span several hops.
Tolerance: max abs error over the reference's peak <= 5e-4, as that file.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tacotron_tpu.dsp.audio import inv_preemphasis as jax_inv_preemphasis
from tacotron_tpu.dsp.dft import istft_mm as jax_istft_mm
from tacotron_tpu.dsp.dft import stft_mm as jax_stft_mm
from tacotron_tpu.dsp.pallas_gl import griffin_lim_pallas
from tacotron_tpu_torch.dsp.audio import inv_preemphasis
from tacotron_tpu_torch.dsp.dft import gl_spectrum_mm, istft_mm
from tacotron_tpu_torch.dsp.dft import inv_window_sumsquare, zero_phase
from tacotron_tpu_torch.dsp.fused_gl import (PAD, gl_spectrum_reference, gl_step_reference,
                                             griffin_lim, griffin_lim_spectrum, live_bases,
                                             padded, padded_bases)
from tacotron_tpu_torch.dsp.stft import frame_signal, overlap_add, window_sumsquare

KW = dict(n_fft=256, hop_length=48, win_length=190)


def _mag(batch=2, t=4096, seed=0):
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.standard_normal((batch, t)).astype(np.float32), axis=-1) * 0.1
    y -= y.mean(axis=-1, keepdims=True)
    re, im = jax_stft_mm(jnp.asarray(y), **KW)
    return np.array(jnp.sqrt(re ** 2 + im ** 2 + 1e-12))


def _close_to_peak(got, want, tol=5e-4):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("momentum,n_iter", [(0.0, 4), (0.9, 5)])
def test_plain_gl_matches_jax_kernel_f32(momentum, n_iter):
    mag = _mag(seed=3)
    want = np.asarray(griffin_lim_pallas(jnp.asarray(mag), **KW, n_iter=n_iter,
                                         momentum=momentum, lowp=False, interpret=True))
    got = griffin_lim(torch.from_numpy(mag), **KW, n_iter=n_iter, momentum=momentum,
                      lowp=False)
    assert got.shape == want.shape
    _close_to_peak(got.numpy(), want)


def test_istft_mm_matches_jax():
    rng = np.random.default_rng(1)
    re, im = (rng.standard_normal((2, 40, 129)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_istft_mm(jnp.asarray(re), jnp.asarray(im), **KW))
    got = istft_mm(torch.from_numpy(re), torch.from_numpy(im), **KW).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n", [1, 255, 256, 20_000])
def test_inv_preemphasis_matches_jax(n):
    y = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    want = np.asarray(jax_inv_preemphasis(jnp.asarray(y), 0.97))
    got = inv_preemphasis(torch.from_numpy(y), 0.97).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5)


def _kernel_emulation(mag, n_fft, hop_length, win_length, n_iter, momentum):
    """The CUDA kernel's algorithm in torch, stage for stage."""
    b, f, nb = mag.shape
    m, lpad, pad = b * f, (n_fft - win_length) // 2, n_fft // 2
    length = hop_length * (f - 1)
    bwd, fwd = (torch.from_numpy(x) for x in live_bases(n_fft, win_length))
    wss = window_sumsquare(win_length, n_fft, hop_length, f).astype(np.float32)
    invwss = torch.from_numpy(1.0 / np.maximum(wss, np.float32(1e-11)))
    mag2 = mag.reshape(m, nb)
    e = torch.stack([mag2, torch.zeros_like(mag2)], -1).reshape(m, 2 * nb)
    s0, s1 = e.clone(), torch.empty_like(e)
    t = torch.arange(length) + pad                       # OLA: gather per sample
    fr_idx = torch.arange(f)
    col = t[:, None] - fr_idx[None, :] * hop_length - lpad
    live = (col >= 0) & (col < win_length)
    idx = (fr_idx[:, None] * hop_length + lpad + torch.arange(win_length)[None, :] - pad)
    idx = idx.abs()                                      # reflect by index
    idx = torch.where(idx >= length, 2 * (length - 1) - idx, idx)
    for it in range(n_iter):
        s_cur, s_new = (s0, s1) if it % 2 == 0 else (s1, s0)
        frames = (e @ bwd).reshape(b, f, win_length)
        g = frames[:, fr_idx[None, :].expand_as(col), col.clamp(0, win_length - 1)]
        sig = (g * live).sum(-1) * invwss[t]
        spec = (sig[:, idx].reshape(m, win_length) @ fwd).reshape(m, nb, 2)
        scale = mag2 / torch.clamp(spec.norm(dim=-1), min=1e-8)
        new = (spec * scale[..., None]).reshape(m, 2 * nb)
        if momentum:
            e = new + momentum * (new - s_cur)
            s_new.copy_(new)
        else:
            e = new
    spec = ((s1 if n_iter % 2 else s0) if momentum else e).reshape(b, f, nb, 2)
    return spec[..., 0], spec[..., 1]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_kernel_algorithm_matches_plain(momentum):
    mag = torch.from_numpy(_mag(seed=5))
    kw = dict(n_fft=256, hop_length=48, win_length=190, n_iter=5, momentum=momentum)
    want = istft_mm(*gl_spectrum_mm(mag, lowp=False, **kw), **KW).numpy()
    got = istft_mm(*_kernel_emulation(mag, **kw), **KW).numpy()
    _close_to_peak(got, want, tol=1e-5)


def test_cpu_tensors_take_the_plain_path():
    from tacotron_tpu_torch import runtime
    before = dict(runtime.LAUNCHES)
    mag = torch.from_numpy(_mag())
    got = griffin_lim_spectrum(mag, **KW, n_iter=2, momentum=0.5, lowp=False)
    want = gl_spectrum_reference(mag, **KW, n_iter=2, momentum=0.5, lowp=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the wrapper's plain version and the matmul-DFT loop are the same f32 loop
    mm = gl_spectrum_mm(mag, **KW, n_iter=2, momentum=0.5, lowp=False)
    assert all(torch.equal(g, w) for g, w in zip(got, mm))
    assert dict(runtime.LAUNCHES) == before



# ------------------------------------------------ the bf16 mode's tensor-core layout

@pytest.mark.parametrize("n_fft,win", [(256, 190), (2048, 1102)])
def test_padded_bases_hold_live_bases(n_fft, win):
    bwd, fwd = live_bases(n_fft, win)
    bwd_t, fwd_t = padded_bases(n_fft, win)
    s = 2 * (n_fft // 2 + 1)
    assert bwd_t.shape == (padded(win), padded(s)) and fwd_t.shape == (padded(s), padded(win))
    assert all(n % PAD == 0 for n in (*bwd_t.shape, *fwd_t.shape))
    np.testing.assert_array_equal(bwd_t[:win, :s], bwd.T)
    np.testing.assert_array_equal(fwd_t[:s, :win], fwd.T)
    for x, (r, c) in ((bwd_t, (win, s)), (fwd_t, (s, win))):
        assert not x[r:].any() and not x[:, c:].any()


def _ola_frame(frames, invwss, n_fft, hop, win, f):
    """The overlap-add-and-frame launch (``gl_ola_frame``), its index
    arithmetic as written there, vectorised over the samples: frames (B*F,
    padded(win)) f32 -> (signal (B, L) f32, analysis operand (B*F,
    padded(win)) bf16, writes per slot)."""
    b = frames.shape[0] // f
    length, lpad, pad = hop * (f - 1), (n_fft - win) // 2, n_fft // 2
    off = pad - lpad
    fr = frames.reshape(b, f, -1)
    s = torch.arange(length)

    def frame_range(c):                     # f_lo, f_hi of ola_sample / put_slots
        f_hi = torch.where(c < 0, -1, torch.clamp(c // hop, max=f - 1))
        lo_num = c - win + 1
        f_lo = torch.where(lo_num <= 0, 0, (lo_num + hop - 1) // hop)
        return f_lo, f_hi

    c0 = s + off
    f_lo, f_hi = frame_range(c0)
    y = torch.zeros(b, length)
    for fi in range(f):                     # the kernel's order: ascending frames
        live = (f_lo <= fi) & (fi <= f_hi)
        col = torch.where(live, c0 - fi * hop, 0)
        y = torch.where(live, y + fr[:, fi, col], y)
    y = y * invwss[s + pad]
    v = y.bfloat16()
    ana = torch.zeros(b, f, fr.shape[-1], dtype=torch.bfloat16)
    writes = torch.zeros(b, f, fr.shape[-1], dtype=torch.int32)
    for c, keep in ((c0, s >= 0), (off - s, s > 0), (off + 2 * (length - 1) - s, s < length - 1)):
        f_lo, f_hi = frame_range(c)
        for fi in range(f):
            sel = keep & (c >= 0) & (f_lo <= fi) & (fi <= f_hi)
            ana[:, fi, c[sel] - fi * hop] = v[:, sel]
            writes[:, fi, c[sel] - fi * hop] += 1
    return y, ana.reshape(b * f, -1), writes.reshape(b * f, -1)


@pytest.mark.parametrize("n_fft,hop,win,f", [(256, 48, 190, 86), (256, 48, 190, 4),
                                             (2048, 275, 1102, 5), (2048, 275, 1102, 37)])
def test_ola_frame_mirror_equals_reflect_framing(n_fft, hop, win, f):
    """F 4 at 256/48 and F 5 at 2048/275 are the fewest frames the reflect
    pad allows: both reflected edges meet there."""
    b, lpad, pad = 3, (n_fft - win) // 2, n_fft // 2
    rng = np.random.default_rng(f)
    frames = torch.zeros(b * f, padded(win))
    frames[:, :win] = torch.from_numpy(rng.standard_normal((b * f, win)).astype(np.float32))
    invwss = inv_window_sumsquare(win, n_fft, hop, f, "cpu")
    y, ana, writes = _ola_frame(frames, invwss, n_fft, hop, win, f)
    # every live slot written exactly once, the pad columns never
    assert bool((writes[:, :win] == 1).all()) and not writes[:, win:].any()
    want = frame_signal(y, n_fft, hop)[..., lpad:lpad + win].reshape(b * f, win).bfloat16()
    assert torch.equal(ana[:, :win], want)
    # the signal is the plain overlap-add, normalised (only the f32 sum's order differs)
    ft = torch.nn.functional.pad(frames[:, :win].reshape(b, f, win), (lpad, n_fft - win - lpad))
    plain = (overlap_add(ft, hop) * invwss)[..., pad:-pad]
    assert float((y - plain).abs().max()) <= 1e-6 * float(plain.abs().max())


def _tc_iterations(mag, e, n_fft, hop, win, n_iter=1, beta=0.0):
    """The bf16 mode's stages as the kernels run them, from the synthesis
    operand ``e`` (B*F, padded(2*n_bins)) bf16: the products as f32 sums of
    bf16 operands, ``_ola_frame`` between them, the epilogue's roundings.
    -> (the last projected spectrum, the carrier e) both (B*F,
    padded(2*n_bins)) bf16."""
    b, f, nb = mag.shape
    bwd_t, fwd_t = (torch.from_numpy(x).bfloat16().float() for x in padded_bases(n_fft, win))
    invwss = inv_window_sumsquare(win, n_fft, hop, f, "cpu")
    mag2 = mag.reshape(b * f, nb)
    cur = e
    for _ in range(n_iter):
        frames = e.float() @ bwd_t.T
        _, ana, _ = _ola_frame(frames, invwss, n_fft, hop, win, f)
        spec = ana.float() @ fwd_t.T
        re, im = spec[:, 0:2 * nb:2], spec[:, 1:2 * nb:2]
        scale = mag2 / torch.clamp(torch.sqrt(re * re + im * im), min=1e-8)
        new = torch.zeros_like(e)
        new[:, 0:2 * nb:2], new[:, 1:2 * nb:2] = (re * scale).bfloat16(), (im * scale).bfloat16()
        if beta:
            x = new.float()
            e, cur = (x + beta * (x - cur.float())).bfloat16(), new
        else:
            e = cur = new
        assert not e[:, 2 * nb:].any()      # the pad columns stay zero
    return cur, e


def _carrier(re, im):
    m, nb = re.shape[0] * re.shape[1], re.shape[-1]
    e = torch.zeros(m, padded(2 * nb), dtype=torch.bfloat16)
    e[:, 0:2 * nb:2], e[:, 1:2 * nb:2] = re.reshape(m, nb), im.reshape(m, nb)
    return e


@pytest.mark.parametrize("depth", [0, 3])
def test_tensor_core_stages_match_plain_step(depth):
    mag = torch.from_numpy(_mag(seed=7))
    re, im = zero_phase(mag, True)
    for _ in range(depth):
        re, im = gl_step_reference(re, im, mag, **KW)
    want = gl_step_reference(re, im, mag, **KW)
    got, _ = _tc_iterations(mag, _carrier(re, im), **_geo())
    nb, peak = mag.shape[-1], float(mag.max())
    for g, w in zip((got[:, 0:2 * nb:2], got[:, 1:2 * nb:2]), want):
        assert float((g.float() - w.reshape(g.shape).float()).abs().max()) <= 2.0 ** -7 * peak


@pytest.mark.parametrize("n_iter", [1, 2])
def test_tensor_core_stages_match_plain_loop_with_momentum(n_iter):
    """K4's momentum: s_new = projection, e = s_new + beta (s_new - s_cur),
    from the zero-phase start in s0 and e."""
    mag = torch.from_numpy(_mag(seed=8))
    want = gl_spectrum_reference(mag, **KW, n_iter=n_iter, momentum=0.99)
    got, _ = _tc_iterations(mag, _carrier(*zero_phase(mag, True)), **_geo(), n_iter=n_iter,
                            beta=0.99)
    nb, peak = mag.shape[-1], float(mag.max())
    for g, w in zip((got[:, 0:2 * nb:2], got[:, 1:2 * nb:2]), want):
        assert float((g.float() - w.reshape(g.shape).float()).abs().max()) <= 2.0 ** -7 * peak


def _geo():
    return dict(n_fft=KW["n_fft"], hop=KW["hop_length"], win=KW["win_length"])
