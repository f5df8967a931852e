"""Corpus I/O, as far as synthesis needs it.

The port's own copy of ``save_wav`` from the JAX package's
``data/ljspeech.py``; the rest of that module (corpus readers, the
synthetic corpora, preprocessing) is not ported yet (``ROADMAP.md`` Queue 1,
item 4).
"""

from __future__ import annotations

import wave

import numpy as np


def save_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Mono 16-bit PCM: ``wav`` clipped to [-1, 1], times 32767, truncated."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
