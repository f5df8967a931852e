"""The bf16 mode of Griffin-Lim, the streaming kernel's plain version and the
``"fft"`` backend, each against its JAX counterpart on the same numpy
inputs.

Small geometry n_fft 256 / hop 48 / win 190, as tests/unit/test_pallas_gl.py.
Tolerances are max abs error over the reference's peak; the value measured
on this setup is in brackets.

- ``stft_mm`` / ``istft_mm`` with ``lowp``: bf16 operands, f32 accumulation
  on both sides, only the order of the sum differs: 1e-5 [4.7e-7, 2.8e-7].
- ``griffin_lim_mm(lowp=True)``: the port keeps every rounding point of the
  JAX loop (bf16 frames, bf16 overlap-add in the same order, division by the
  bf16 window sum-square, bf16 carrier; with momentum, beta itself rounded to
  bf16 and the subtraction, product and sum each rounded to bf16). One bf16
  ulp of the peak, 2^-8 = 3.9e-3 [momentum 0: 1.7e-7; 0.9: 8.0e-4, where an
  f32 sum that differs in its last bit flips a bf16 rounding; 0.99: 9.6e-7].
- ``"fft"`` Griffin-Lim: f32 FFTs on both sides, 1e-4 [3.4e-6].
- The kernel's plain bf16 version against the interpreted Pallas kernel in
  bf16, whole-loop and streaming. The two round at different points by
  design (the TPU kernel rounds spectrum x twiddle and a positional matrix,
  the port the spectrum and the windowed DFT bases), and Griffin-Lim does not
  pin the phase down, so roundings of 2^-8 move the waveform by percent of
  its peak: after 4 iterations the JAX package's own two bf16 loops (Pallas
  kernel and ``griffin_lim_mm``) differ by 4.3e-2 and each differs from f32
  by 8.3e-2. Held to 1e-1 [4.3e-2 momentum 0, 3.7e-2 momentum 0.9], and, as
  tests/unit/test_pallas_gl.py holds the bf16 kernel, to converging as well:
  magnitude error after 30 iterations <= the bf16 Pallas kernel's * 1.05 +
  1e-3 [momentum 0: 0.0776 vs 0.0746; 0.99: 0.0580 vs 0.0551] and, without
  momentum (the case that file holds), <= the f32 loop's * 1.05 + 1e-3
  [0.0776 vs 0.0738]. With momentum 0.99 every bf16 loop sits above f32 at
  30 iterations (f32 0.0525, JAX ``griffin_lim_mm`` bf16 0.0612, Pallas
  bf16 0.0551, the port 0.0580), so that case is held to the bf16 kernel
  only.
- The plain f32 streaming version against JAX ``inner=1, lowp=False``:
  5e-4, as tests/unit/test_pallas_gl.py [4.7e-6].
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tacotron_tpu.dsp.dft import griffin_lim_mm as jax_griffin_lim_mm
from tacotron_tpu.dsp.dft import istft_mm as jax_istft_mm
from tacotron_tpu.dsp.dft import stft_mm as jax_stft_mm
from tacotron_tpu.dsp.griffin_lim import griffin_lim as jax_griffin_lim_fft
from tacotron_tpu.dsp.pallas_gl import griffin_lim_pallas
from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.dsp import stft as port_stft
from tacotron_tpu_torch.dsp.dft import griffin_lim_mm, istft_mm, stft_mm
from tacotron_tpu_torch.dsp.fused_gl import (gl_spectrum_reference, gl_step_reference,
                                             griffin_lim, griffin_lim_spectrum,
                                             griffin_lim_step, zero_phase)

KW = dict(n_fft=256, hop_length=48, win_length=190)
BF16_ULP = 2.0 ** -8


def _signal(batch=2, t=4096, seed=0):
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.standard_normal((batch, t)).astype(np.float32), axis=-1) * 0.1
    return y - y.mean(axis=-1, keepdims=True)


def _mag(seed=0, **kw):
    re, im = jax_stft_mm(jnp.asarray(_signal(seed=seed, **kw)), **KW)
    return np.array(jnp.sqrt(re ** 2 + im ** 2 + 1e-12))


def _close_to_peak(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=tol)


def _mag_err(wav, mag):
    re, im = jax_stft_mm(jnp.asarray(np.asarray(wav)), **KW)
    m = jnp.sqrt(re ** 2 + im ** 2 + 1e-12)
    return float(jnp.mean(jnp.abs(m - mag)) / jnp.mean(mag))


def test_stft_mm_lowp_matches_jax():
    y = _signal(seed=1)
    want = jax_stft_mm(jnp.asarray(y), **KW, lowp=True)
    got = stft_mm(torch.from_numpy(y), **KW, lowp=True)
    for g, w in zip(got, want):
        _close_to_peak(g.numpy(), w, 1e-5)
    # and the bf16 operands do cost accuracy against f32: about 1e-2 of the peak
    f32 = stft_mm(torch.from_numpy(y), **KW)
    err = float((got[0] - f32[0]).abs().max() / f32[0].abs().max())
    assert 1e-5 < err < 2e-2


def test_istft_mm_lowp_matches_jax():
    rng = np.random.default_rng(1)
    re, im = (rng.standard_normal((2, 40, 129)).astype(np.float32) for _ in range(2))
    want = jax_istft_mm(jnp.asarray(re), jnp.asarray(im), **KW, lowp=True)
    got = istft_mm(torch.from_numpy(re), torch.from_numpy(im), **KW, lowp=True)
    _close_to_peak(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.9, 0.99])
def test_griffin_lim_mm_lowp_matches_jax(momentum):
    mag = _mag(seed=3)
    want = jax_griffin_lim_mm(jnp.asarray(mag), **KW, n_iter=4, momentum=momentum,
                              lowp=True)
    got = griffin_lim_mm(torch.from_numpy(mag), **KW, n_iter=4, momentum=momentum,
                         lowp=True)
    _close_to_peak(got.numpy(), want, BF16_ULP)


def test_griffin_lim_mm_defaults_to_bf16_as_jax():
    mag = torch.from_numpy(_mag(seed=3))
    assert torch.equal(griffin_lim_mm(mag, **KW, n_iter=2),
                       griffin_lim_mm(mag, **KW, n_iter=2, lowp=True))
    assert not torch.equal(griffin_lim_mm(mag, **KW, n_iter=2),
                           griffin_lim_mm(mag, **KW, n_iter=2, lowp=False))


def test_fft_griffin_lim_matches_jax():
    mag = _mag(seed=2)
    want = jax_griffin_lim_fft(jnp.asarray(mag), **KW, n_iter=5)
    got = port_stft.griffin_lim(torch.from_numpy(mag), **KW, n_iter=5)
    _close_to_peak(got.numpy(), want, 1e-4)


def test_fft_transforms_round_trip():
    y = torch.from_numpy(_signal(seed=4))
    spec = port_stft.stft(y, **KW)
    assert spec.shape == (2, 4096 // 48 + 1, 129) and spec.dtype == torch.complex64
    back = port_stft.istft(spec, **KW, length=4096)
    n = 48 * (spec.shape[1] - 1)
    np.testing.assert_allclose(back[:, :n].numpy(), y[:, :n].numpy(), atol=1e-4)
    assert float(back[:, n:].abs().max()) == 0.0


@pytest.mark.parametrize("momentum,inner", [(0.0, None), (0.9, None), (0.0, 1)])
def test_plain_bf16_kernel_version_matches_jax_kernel(momentum, inner):
    mag = _mag(seed=3)
    want = griffin_lim_pallas(jnp.asarray(mag), **KW, n_iter=4, momentum=momentum,
                              inner=inner, lowp=True, interpret=True)
    got = griffin_lim(torch.from_numpy(mag), **KW, n_iter=4, momentum=momentum,
                      inner=inner, lowp=True)
    _close_to_peak(got.numpy(), want, 1e-1)


@pytest.mark.parametrize("momentum,inner", [(0.0, None), (0.99, None), (0.0, 1)])
def test_plain_bf16_kernel_version_converges_like_jax_kernel(momentum, inner):
    mag = _mag(seed=4)
    kw = dict(n_iter=30, momentum=momentum, inner=inner, lowp=True)
    ref = griffin_lim_pallas(jnp.asarray(mag), **KW, interpret=True, **kw)
    f32 = jax_griffin_lim_mm(jnp.asarray(mag), **KW, n_iter=30, lowp=False)
    got = griffin_lim(torch.from_numpy(mag), **KW, **kw)
    e_got = _mag_err(got.numpy(), mag)
    assert e_got <= _mag_err(ref, mag) * 1.05 + 1e-3
    if momentum == 0.0:
        assert e_got <= _mag_err(f32, mag) * 1.05 + 1e-3


def test_plain_f32_streaming_matches_jax_kernel():
    mag = _mag(seed=0)
    want = griffin_lim_pallas(jnp.asarray(mag), **KW, n_iter=4, inner=1, lowp=False,
                              interpret=True)
    got = griffin_lim(torch.from_numpy(mag), **KW, n_iter=4, inner=1, lowp=False)
    _close_to_peak(got.numpy(), want, 5e-4)


@pytest.mark.parametrize("lowp", [False, True])
def test_streaming_equals_whole_loop_without_momentum(lowp):
    """K5 and K4 compute the same thing when beta is 0: bit-equal plain
    versions."""
    mag = torch.from_numpy(_mag(seed=5))
    a = griffin_lim_spectrum(mag, **KW, n_iter=3, lowp=lowp)
    b = griffin_lim_spectrum(mag, **KW, n_iter=3, inner=1, lowp=lowp)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_step_interface_and_refusals():
    mag = torch.from_numpy(_mag(seed=6))
    re, im = zero_phase(mag, lowp=True)
    assert re.dtype == torch.bfloat16 and float(im.abs().max()) == 0.0
    out = griffin_lim_step(re, im, mag, **KW)
    assert out[0].dtype == torch.bfloat16 and out[0].shape == mag.shape
    want = gl_step_reference(re, im, mag, **KW)
    assert all(torch.equal(x, y) for x, y in zip(out, want))
    with pytest.raises(TypeError, match="bfloat16"):
        griffin_lim_step(re.float(), im.float(), mag, **KW)
    with pytest.raises(ValueError, match="one shape"):
        griffin_lim_step(re[:, :-1], im[:, :-1], mag, **KW, lowp=True)
    with pytest.raises(ValueError, match="inner must be None or 1"):
        griffin_lim(mag, **KW, n_iter=2, inner=2)
    with pytest.raises(ValueError, match="momentum requires inner=None"):
        griffin_lim(mag, **KW, n_iter=2, inner=1, momentum=0.5)


def test_cpu_tensors_launch_nothing():
    before = dict(runtime.LAUNCHES)
    mag = torch.from_numpy(_mag(seed=7))
    got = griffin_lim_spectrum(mag, **KW, n_iter=2, momentum=0.5)
    want = gl_spectrum_reference(mag, **KW, n_iter=2, momentum=0.5)
    assert all(torch.equal(g, w.float()) for g, w in zip(got, want))
    griffin_lim_spectrum(mag, **KW, n_iter=2, inner=1)
    assert dict(runtime.LAUNCHES) == before
