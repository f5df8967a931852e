"""Griffin-Lim (TPU kernel K4 port, f32 mode) and the synthesis DSP around
it; the bf16 mode is in tests/test_torch_gl_lowp.py.

The port's plain f32 Griffin-Lim (reached through the kernel wrapper with
``lowp=False``, which takes it for CPU tensors) vs the JAX Pallas kernel interpreted in f32
(``lowp=False``); ``istft_mm`` and ``inv_preemphasis`` vs JAX; an emulation
of the CUDA kernel's three stages (interleaved live-span bases, gather OLA,
reflect-by-index analysis, projection and momentum epilogue) vs the plain
loop. The CUDA kernel itself is held against the plain loop in
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
from tacotron_tpu_torch.dsp.fused_gl import (gl_spectrum_reference, griffin_lim,
                                             griffin_lim_spectrum, live_bases)
from tacotron_tpu_torch.dsp.stft import window_sumsquare

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

