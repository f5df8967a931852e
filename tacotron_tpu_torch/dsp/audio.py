"""Audio features: waveform <-> normalised log spectrograms.

Port of the JAX package's ``dsp/audio.py``. Forward (preprocessing):
pre-emphasis (0.97) -> STFT magnitude -> (80-band mel) -> dB -> normalised
into [0, 1]. Inverse (synthesis): denormalise -> dB to amplitude ->
magnitude^power sharpening (paper §3.3) -> Griffin-Lim phase recovery ->
final iSTFT -> inverse pre-emphasis.
"""

from __future__ import annotations

import torch

from tacotron_tpu_torch.config import AudioConfig
from tacotron_tpu_torch.dsp.dft import gl_spectrum_mm, istft_mm
from tacotron_tpu_torch.dsp.fused_gl import griffin_lim_spectrum
from tacotron_tpu_torch.dsp.mel import mel_filterbank
from tacotron_tpu_torch.dsp.stft import gl_spectrum_fft, stft_magnitude

_PREEMPH_BLOCK = 256


def preemphasis(y, coef: float = 0.97):
    """y[t] - coef * y[t-1] (reference: scipy lfilter([1, -coef], [1]))."""
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


def inv_preemphasis(y, coef: float = 0.97):
    """Inverse IIR filter 1 / (1 - coef z^-1): x[t] = y[t] + coef * x[t-1].

    Blocked form of the first-order recurrence: within each block of
    ``_PREEMPH_BLOCK`` samples one product with the lower-triangular matrix
    L[i, j] = coef^(i-j); the carries between blocks, e[k] = a[k] +
    coef^block * e[k-1], by a log-depth doubling scan; then each block adds
    coef^(i+1) times the previous block's carry.
    """
    n = y.shape[-1]
    lead = y.shape[:-1]
    blk = _PREEMPH_BLOCK
    nb = -(-n // blk)
    yb = torch.nn.functional.pad(y.float(), (0, nb * blk - n)).reshape(*lead, nb, blk)
    i = torch.arange(blk, device=y.device, dtype=torch.float64)
    expo = i[:, None] - i[None, :]
    tri = torch.where(expo >= 0, coef ** expo.clamp(min=0), 0.0).float()
    local = yb @ tri.T                          # (..., nb, blk) zero-carry solution
    carry = local[..., -1]                      # block ends, carry-free
    c, step = coef ** blk, 1
    while step < nb:                            # e[k] += c^step * e[k - step]
        carry = torch.cat([carry[..., :step],
                           carry[..., step:] + c * carry[..., :-step]], dim=-1)
        c, step = c * c, step * 2
    prev = torch.nn.functional.pad(carry[..., :-1], (1, 0))       # carry into block k
    decay = (coef ** (i + 1)).float()
    x = local + prev[..., None] * decay
    return x.reshape(*lead, nb * blk)[..., :n]


def amp_to_db(x):
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def normalize(s_db, cfg: AudioConfig):
    return torch.clamp((s_db - cfg.min_level_db) / -cfg.min_level_db, 0.0, 1.0)


def spectrogram(y, cfg: AudioConfig, *, preemph: bool = True, center: bool = True):
    """Waveform (..., T) -> normalised linear log-spectrogram (..., frames, n_freq).

    ``preemph=False, center=False`` is the batched-preprocess path
    (``data/ljspeech.py``): pre-emphasis and the centre reflect padding are
    then applied per utterance by the caller, so batch zero-padding never
    leaks into the reflected tail frames."""
    if preemph:
        y = preemphasis(y, cfg.preemphasis)
    mag = stft_magnitude(y, cfg.n_fft, cfg.hop_length, cfg.win_length, center=center)
    return normalize(amp_to_db(mag) - cfg.ref_level_db, cfg)


def melspectrogram(y, cfg: AudioConfig, *, preemph: bool = True, center: bool = True):
    """Waveform (..., T) -> normalised mel log-spectrogram (..., frames, n_mels)."""
    if preemph:
        y = preemphasis(y, cfg.preemphasis)
    mag = stft_magnitude(y, cfg.n_fft, cfg.hop_length, cfg.win_length, center=center)
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                         cfg.fmin, cfg.fmax)).to(mag.device)
    mel = torch.einsum("...tf,mf->...tm", mag, fb)
    return normalize(amp_to_db(mel) - cfg.ref_level_db, cfg)


def db_to_amp(x):
    return torch.pow(10.0, x * 0.05)


def denormalize(s, cfg: AudioConfig):
    return torch.clamp(s, 0.0, 1.0) * -cfg.min_level_db + cfg.min_level_db


def spectrogram_magnitude(s, cfg: AudioConfig):
    """Normalised linear spectrogram -> sharpened magnitude for GL."""
    mag = db_to_amp(denormalize(s, cfg) + cfg.ref_level_db)
    return torch.pow(mag, cfg.griffin_lim_power)


def mel_to_linear(mel, cfg: AudioConfig, pinv):
    """Normalised mel spectrogram (..., frames, n_mels) -> normalised linear
    spectrogram (..., frames, n_freq): denormalise, dB to amplitude, the
    filterbank's pseudo-inverse ``pinv`` (n_freq, n_mels; ``mel.mel_pinv``
    on the mel's device), the amplitude floor of ``amp_to_db``, back to
    normalised dB."""
    amp = db_to_amp(denormalize(mel, cfg) + cfg.ref_level_db) @ pinv.T
    return normalize(amp_to_db(amp) - cfg.ref_level_db, cfg)


def gl_spectrum(mag, cfg: AudioConfig, n_iter: int | None = None):
    """Griffin-Lim phase recovery on the configured backend -> (re, im).

    ``"pallas"`` is the Griffin-Lim kernel in its bf16 mode, the JAX
    package's default (the plain version with the same rounding points on
    CPU tensors); ``"mm"`` the plain matmul-DFT loop in its bf16 mode,
    ``"mm_f32"`` the same loop in f32; ``"fft"`` classic Griffin-Lim over
    ``torch.fft`` (no momentum, as in the JAX package).

    ``cfg.gl_trim_chunks`` changes nothing here: in the JAX kernel it trims
    the partially windowed chunks' products to their live lanes, and the
    port's products cover only the window's nonzero span to begin with."""
    kw = dict(n_fft=cfg.n_fft, hop_length=cfg.hop_length, win_length=cfg.win_length,
              n_iter=cfg.griffin_lim_iters if n_iter is None else n_iter)
    if cfg.gl_backend == "pallas":
        return griffin_lim_spectrum(mag, momentum=cfg.gl_momentum, **kw)
    if cfg.gl_backend in ("mm", "mm_f32"):
        return gl_spectrum_mm(mag, lowp=cfg.gl_backend == "mm",
                              momentum=cfg.gl_momentum, **kw)
    if cfg.gl_backend == "fft":
        spec = gl_spectrum_fft(mag, **kw)
        return spec.real, spec.imag
    raise ValueError(f"unknown gl_backend {cfg.gl_backend!r}")


def spectrum_to_wav(re, im, cfg: AudioConfig, length: int | None = None):
    """Final iSTFT + inverse pre-emphasis."""
    y = istft_mm(re, im, cfg.n_fft, cfg.hop_length, cfg.win_length, length=length)
    return inv_preemphasis(y, cfg.preemphasis)


def inv_spectrogram(s, cfg: AudioConfig, *, n_iter: int | None = None,
                    length: int | None = None):
    """Normalised linear spectrogram (..., frames, n_freq) -> waveform."""
    re, im = gl_spectrum(spectrogram_magnitude(s, cfg), cfg, n_iter)
    return spectrum_to_wav(re, im, cfg, length)
