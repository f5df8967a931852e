"""Port of tacotron_tpu.dsp: the same names, but for ``stft``, which here
stays the submodule ``dsp/stft.py`` (code and tests of the port import it by
that name); the transform is ``tacotron_tpu_torch.dsp.stft.stft``."""

from tacotron_tpu_torch.dsp.stft import griffin_lim, istft, stft_magnitude
from tacotron_tpu_torch.dsp.mel import mel_filterbank
from tacotron_tpu_torch.dsp.audio import (
    amp_to_db,
    db_to_amp,
    denormalize,
    inv_preemphasis,
    inv_spectrogram,
    melspectrogram,
    normalize,
    preemphasis,
    spectrogram,
)

__all__ = [
    "istft",
    "stft_magnitude",
    "mel_filterbank",
    "preemphasis",
    "inv_preemphasis",
    "spectrogram",
    "melspectrogram",
    "inv_spectrogram",
    "amp_to_db",
    "db_to_amp",
    "normalize",
    "denormalize",
    "griffin_lim",
]
