"""Griffin-Lim (TPU kernel K4 port, f32 mode) and the synthesis DSP around
it; the bf16 mode is in tests/test_torch_gl_lowp.py.

The port's plain f32 Griffin-Lim (reached through the kernel wrapper with
``lowp=False``, which takes it for CPU tensors) vs the JAX Pallas kernel interpreted in f32
(``lowp=False``); ``istft_mm``, ``stft_mm_magnitude``, ``num_frames`` and
``inv_preemphasis`` vs JAX. The kernels'
tensor-core layout, both modes: the padded K-major bases against
``live_bases``; a mirror of the overlap-add-and-frame launch against the
reflect framing of ``frame_signal`` (bit-identical, every slot written
once); an emulation of the f32 stages (padded f32 carriers, the split TF32
products of ``tf32_split_matmul``, the mirror, the projection and momentum
epilogue) vs the plain f32 loop, with ``torch.matmul`` products and with
the same split products, over 5 iterations at 1e-5 of the peak; and an
emulation of the bf16 stages
(f32 products of bf16 operands, the epilogue's roundings) against
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
from tacotron_tpu.dsp.dft import stft_mm_magnitude as jax_stft_mm_magnitude
from tacotron_tpu.dsp.stft import num_frames as jax_num_frames
from tacotron_tpu.dsp.pallas_gl import griffin_lim_pallas
from tacotron_tpu_torch.dsp.audio import inv_preemphasis
from tacotron_tpu_torch.dsp.dft import gl_spectrum_mm, istft_mm, stft_mm_magnitude
from tacotron_tpu_torch.dsp.dft import inv_window_sumsquare, zero_phase
from tacotron_tpu_torch.dsp.fused_gl import (PAD, gl_spectrum_reference, gl_step_reference,
                                             griffin_lim, griffin_lim_spectrum, live_bases,
                                             padded, padded_bases, tf32_split_matmul)
from tacotron_tpu_torch.dsp.stft import frame_signal, num_frames, overlap_add

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


def test_stft_mm_magnitude_matches_jax():
    """f32 products on both sides, only the order of the sums differs: 1e-5
    of the peak, as ``stft_mm`` is held in bf16 (tests/test_torch_gl_lowp.py)."""
    y = np.random.default_rng(2).standard_normal((2, 3000)).astype(np.float32)
    want = np.asarray(jax_stft_mm_magnitude(jnp.asarray(y), **KW))
    got = stft_mm_magnitude(torch.from_numpy(y), **KW).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    _close_to_peak(got, want, 1e-5)


@pytest.mark.parametrize("n", [1, 47, 48, 3000, 20_000])
def test_num_frames_matches_jax(n):
    assert num_frames(n, KW["hop_length"]) == jax_num_frames(n, KW["hop_length"])
    # the frame count of the centre-padded transform itself
    y = torch.zeros(1, max(n, KW["n_fft"] // 2 + 1))
    assert frame_signal(y, KW["n_fft"], KW["hop_length"]).shape[-2] == num_frames(
        y.shape[-1], KW["hop_length"])


@pytest.mark.parametrize("n", [1, 255, 256, 20_000])
def test_inv_preemphasis_matches_jax(n):
    y = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    want = np.asarray(jax_inv_preemphasis(jnp.asarray(y), 0.97))
    got = inv_preemphasis(torch.from_numpy(y), 0.97).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5)


def _kernel_emulation_wav(mag, momentum):
    """The f32 kernels' stages (``_tc_iterations``), 5 iterations -> waveform."""
    spec, _ = _tc_iterations(mag, _carrier(*zero_phase(mag, False)), **_geo(), n_iter=5,
                             beta=momentum)
    nb = mag.shape[-1]
    re, im = (spec[:, k:2 * nb:2].reshape(mag.shape) for k in (0, 1))
    return istft_mm(re, im, **KW).numpy()


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_kernel_algorithm_matches_plain(momentum):
    """The f32 kernel's algorithm, split TF32 products included, against the
    plain f32 loop (``torch.matmul`` products): 3.6e-6 and 7.6e-6 of the
    peak measured."""
    mag = torch.from_numpy(_mag(seed=5))
    kw = dict(n_fft=256, hop_length=48, win_length=190, n_iter=5, momentum=momentum)
    want = istft_mm(*gl_spectrum_mm(mag, lowp=False, **kw), **KW).numpy()
    _close_to_peak(_kernel_emulation_wav(mag, momentum), want, tol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_kernel_stages_match_plain_with_the_same_products(momentum):
    """The f32 kernel's stages (padded carriers, the overlap-add-and-frame
    mirror, the epilogue) against the plain f32 loop taking the same split
    products: 1.0e-6 and 2.8e-6 of the peak measured."""
    mag = torch.from_numpy(_mag(seed=5))
    kw = dict(n_fft=256, hop_length=48, win_length=190, n_iter=5, momentum=momentum)
    want = istft_mm(*gl_spectrum_reference(mag, lowp=False, product=tf32_split_matmul, **kw),
                    **KW).numpy()
    _close_to_peak(_kernel_emulation_wav(mag, momentum), want, tol=1e-5)


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



# ------------------------------------------------ the kernels' tensor-core layout

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


def _ola_frame(frames, invwss, n_fft, hop, win, f, dtype=torch.bfloat16):
    """The overlap-add-and-frame launch (``gl_ola_frame``), its index
    arithmetic as written there, vectorised over the samples: frames (B*F,
    padded(win)) f32 -> (signal (B, L) f32, analysis operand (B*F,
    padded(win)) in ``dtype``, writes per slot)."""
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
    v = y.to(dtype)
    ana = torch.zeros(b, f, fr.shape[-1], dtype=dtype)
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
    """The kernels' stages as they run them, from the synthesis operand
    ``e`` (B*F, padded(2*n_bins)) in the storage type (bf16: the products as
    f32 sums of bf16 operands; f32: the split TF32 products of
    ``tf32_split_matmul``), ``_ola_frame`` between them, the epilogue's
    roundings. -> (the last projected spectrum, the carrier e) both (B*F,
    padded(2*n_bins)) in the storage type."""
    b, f, nb = mag.shape
    sd = e.dtype
    bwd_t, fwd_t = (torch.from_numpy(x).to(sd).float() for x in padded_bases(n_fft, win))
    product = tf32_split_matmul if sd == torch.float32 else torch.matmul
    invwss = inv_window_sumsquare(win, n_fft, hop, f, "cpu")
    mag2 = mag.reshape(b * f, nb)
    cur = e
    for _ in range(n_iter):
        frames = product(e.float(), bwd_t.T)
        _, ana, _ = _ola_frame(frames, invwss, n_fft, hop, win, f, sd)
        spec = product(ana.float(), fwd_t.T)
        re, im = spec[:, 0:2 * nb:2], spec[:, 1:2 * nb:2]
        scale = mag2 / torch.clamp(torch.sqrt(re * re + im * im), min=1e-8)
        new = torch.zeros_like(e)
        new[:, 0:2 * nb:2], new[:, 1:2 * nb:2] = (re * scale).to(sd), (im * scale).to(sd)
        if beta:
            x = new.float()
            e, cur = (x + beta * (x - cur.float())).to(sd), new
        else:
            e = cur = new
        assert not e[:, 2 * nb:].any()      # the pad columns stay zero
    return cur, e


def _carrier(re, im):
    m, nb = re.shape[0] * re.shape[1], re.shape[-1]
    e = torch.zeros(m, padded(2 * nb), dtype=re.dtype)
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
