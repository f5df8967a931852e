"""The plain version of the f32 Griffin-Lim kernels' split TF32 products
(``dsp/fused_gl.py``: ``tf32_round``, ``split_tf32``,
``tf32_split_matmul``), on the CPU.

- ``tf32_round`` keeps 10 explicit mantissa bits, rounding to nearest even:
  held bit for bit against an independent numpy rounding to 11 significant
  bits (``np.round`` is half-to-even), and on the two kinds of tie.
- Two pieces (big + small) reconstruct x within 2^-21 of |x| (the split's
  bound is 2^-22); three reconstruct it exactly. The plain version splits
  into as many pieces as the kernel (``TF32_PIECES``, read from the CUDA
  source).
- The emulated product of a seeded operand and the live DFT basis, and one
  Griffin-Lim step taken with it, are within 2x the plain f32 product's
  (step's) own error against an f64 sum, the rule the kernel is held to on
  the card (tests/test_torch_kernels_cuda.py). One TF32 pass is not, and
  on a zero-phase speech-like spectrum, whose synthesis sums cancel 100x,
  neither is the two-piece split's three products nor the four products
  of three and two pieces without small.small.
"""

import re

import numpy as np
import pytest
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
from tacotron_tpu_torch.dsp.dft import stft_mm
from tacotron_tpu_torch.dsp.fused_gl import (TF32_PIECES, f64_matmul, gl_step_reference,
                                             live_bases, padded_bases, split_padded_bases,
                                             split_tf32, tf32_round, tf32_split_matmul,
                                             zero_phase)

GL_REAL = dict(n_fft=2048, hop_length=275, win_length=1102)


def _rne_11_bits(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, ties to even, in f64 (normal f32
    values only)."""
    m, e = np.frexp(x.astype(np.float64))          # x = m 2^e, 0.5 <= |m| < 1
    return np.ldexp(np.round(np.ldexp(m, 11)), e - 11)


@pytest.mark.parametrize("scale", [1.0, 1e-6, 3e4])
def test_tf32_round_is_round_to_nearest_even(scale):
    x = (np.random.default_rng(0).standard_normal(100_000) * scale).astype(np.float32)
    got = tf32_round(torch.from_numpy(x))
    bits = got.view(torch.int32).numpy()
    assert not (bits & 0x1FFF).any()
    np.testing.assert_array_equal(got.numpy().astype(np.float64), _rne_11_bits(x))


def test_tf32_round_ties_and_specials():
    u = 2.0 ** -10                                  # one TF32 ulp at 1
    x = torch.tensor([1 + u / 2, 1 + 3 * u / 2, -(1 + u / 2), 0.0, -0.0,
                      float("inf"), -float("inf")], dtype=torch.float32)
    got = tf32_round(x)
    assert got.tolist()[:3] == [1.0, 1 + 2 * u, -1.0]   # ties go to the even neighbour
    assert got.tolist()[3:] == x.tolist()[3:]
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("scale", [1.0, 1e-6, 3e4])
def test_split_tf32_reconstructs(scale):
    x = torch.from_numpy(
        (np.random.default_rng(1).standard_normal(100_000) * scale).astype(np.float32))
    big, small = split_tf32(x)
    assert torch.equal(tf32_round(big), big) and torch.equal(tf32_round(small), small)
    err = (big.double() + small.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    pieces = split_tf32(x, 3)
    assert all(torch.equal(tf32_round(p), p) for p in pieces)
    assert torch.equal(sum(p.double() for p in pieces), x.double())


def test_tf32_pieces_are_the_kernels():
    src = (runtime.CSRC_DIR / "griffin_lim.cu").read_text()
    pieces = tuple(int(re.search(rf"constexpr int kPieces{k} = (\d+);", src).group(1))
                   for k in "AB")
    assert pieces == TF32_PIECES


@pytest.mark.parametrize("n", [2, 3])
def test_split_padded_bases_hold_the_bases(n):
    for pieces, basis in zip(split_padded_bases(2048, 1102, n), padded_bases(2048, 1102)):
        assert pieces.shape == (n, *basis.shape)
        assert not (pieces.view(np.int32) & 0x1FFF).any()
        err = np.abs(pieces.astype(np.float64).sum(0) - basis)
        assert (err <= (2.0 ** -21 if n == 2 else 0.0) * np.abs(basis)).all()


def _speech_magnitude(b, f, seed):
    g = torch.Generator().manual_seed(seed)
    y = torch.cumsum(torch.randn(b, 275 * (f - 1), generator=g), -1) * 0.1
    re, im = stft_mm(y - y.mean(-1, keepdim=True), **GL_REAL)
    return torch.sqrt(re * re + im * im + 1e-12)


def _operands():
    bwd, fwd = (torch.from_numpy(a) for a in live_bases(2048, 1102))
    rng = np.random.default_rng(2)
    normal = lambda k: torch.from_numpy(rng.standard_normal((96, k)).astype(np.float32))
    floor = torch.from_numpy(rng.uniform(1e-6, 2e-6, (96, bwd.shape[0])).astype(np.float32))
    mag = _speech_magnitude(1, 96, 6).reshape(96, -1)
    zero_phase_speech = torch.stack([mag, torch.zeros_like(mag)], -1).reshape(96, -1)
    return {"synthesis": (normal(bwd.shape[0]), bwd),
            "synthesis_at_the_floor": (floor, bwd),
            "synthesis_zero_phase_speech": (zero_phase_speech, bwd),
            "analysis": (normal(fwd.shape[0]), fwd)}


def _two_piece_products(x, w):
    """The classic split: (small.big + big.small) + big.big per k-tile."""
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)
    return sum(
        (xs[:, k:k + 32] @ wb[k:k + 32] + xb[:, k:k + 32] @ ws[k:k + 32])
        + xb[:, k:k + 32] @ wb[k:k + 32] for k in range(0, x.shape[-1], 32))


def _four_products(x, w):
    """Three pieces of x and two of w without small.small: (x2.w0 + x0.w1 +
    x1.w0) + x0.w0 per k-tile."""
    (x0, x1, x2), (w0, w1) = split_tf32(x, 3), split_tf32(w)
    t = lambda a, b, k: a[:, k:k + 32] @ b[k:k + 32]
    return sum(((t(x2, w0, k) + t(x0, w1, k)) + t(x1, w0, k)) + t(x0, w0, k)
               for k in range(0, x.shape[-1], 32))


@pytest.mark.parametrize("name", ["synthesis", "synthesis_at_the_floor",
                                  "synthesis_zero_phase_speech", "analysis"])
def test_tf32_split_product_is_as_exact_as_f32(name):
    x, w = _operands()[name]
    exact = f64_matmul(x, w).double()
    peak = float(exact.abs().max())
    err = lambda y: float((y.double() - exact).abs().max()) / peak
    plain = err(x @ w)
    assert err(tf32_split_matmul(x, w)) <= 2 * plain
    one_pass = err(tf32_round(x) @ tf32_round(w))
    assert one_pass > 100 * plain
    if name == "synthesis_zero_phase_speech":       # 22 bits are not enough here
        assert err(_two_piece_products(x, w)) > 2 * plain
        # nor is leaving out small.small, though 3 pieces of x hold it exactly
        assert err(_four_products(x, w)) > 2 * plain


def _floor_magnitude():
    s = 0.11 * torch.rand(8, 64, 1025, generator=torch.Generator().manual_seed(3))
    return spectrogram_magnitude(s, get_config("synth_fast").audio)


@pytest.mark.parametrize("name", ["floor_b8_f64", "speech_b2_f64"])
def test_tf32_split_steps_as_exact_as_plain(name):
    """One f32 Griffin-Lim step with the emulated products from the plain f32
    loop's state at depths 0-9, at synth_fast's trimmed shape on the floor
    magnitudes (B 8 x F 64) and on a speech-like one (B 2 x F 64): its
    largest error against the f64 step within 2x the plain step's."""
    mag = _floor_magnitude() if name.startswith("floor") else _speech_magnitude(2, 64, 6)
    peak = float(mag.max())
    err = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b)) / peak
    re, im = zero_phase(mag, False)
    worst = {"plain": 0.0, "split": 0.0}
    for _ in range(10):
        step = lambda p: gl_step_reference(re, im, mag, **GL_REAL, lowp=False, product=p)
        exact, plain = step(f64_matmul), step(torch.matmul)
        worst["plain"] = max(worst["plain"], err(plain, exact))
        worst["split"] = max(worst["split"], err(step(tf32_split_matmul), exact))
        re, im = plain
    assert worst["split"] <= 2 * worst["plain"]
