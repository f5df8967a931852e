"""Everything a run feeds both sides, made from ``--seed``: the weights, the
served prompts and the training batches.

The weights have the initial form of a fresh model (lecun-normal kernels,
zero biases, GRU gate biases 1, highway transform-gate biases -1, unit
batch-norm scales, zero running means and unit running variances), drawn
on the device by one ``torch.Generator`` in one call and cut into leaves.
"""

from __future__ import annotations

import itertools
import math
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.model import batch_norm_names, param_spec

DATA = Path(__file__).resolve().parent / "data"


def charset() -> str:
    return (DATA / "charset.txt").read_text().rstrip("\n")


def char_ids() -> dict[str, int]:
    """{character: id}: the padding id 0, then the character set sorted."""
    return {c: i for i, c in enumerate(sorted(set(charset())), start=1)}


def encode(texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Prompts -> (ids (B, T) int64 padded with 0, lengths (B,))."""
    table = char_ids()
    rows = [[table[c] for c in t] for t in texts]
    ids = np.zeros((len(rows), max(map(len, rows))), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return ids, np.array([len(r) for r in rows], np.int64)


def words() -> list[str]:
    return (DATA / "harvard.txt").read_text().lower().split()


def prompt(rng: np.random.Generator, vocab_words: list[str], length: int) -> str:
    """Words drawn from ``vocab_words`` joined by spaces, cut to exactly
    ``length`` characters, never starting or ending with a space."""
    text = ""
    while len(text) < length:
        text += (" " if text else "") + vocab_words[rng.integers(len(vocab_words))]
    text = text[:length]
    return text[:-1] + "." if text.endswith(" ") else text


def batch_prompts(rng: np.random.Generator, vocab_words, b: int, lo: int, hi: int) -> list[str]:
    """``b`` prompts of ``lo``..``hi`` characters, one of them exactly
    ``hi`` long (at a random row), so the batch's shape is (b, hi)."""
    lengths = rng.integers(lo, hi + 1, size=b)
    lengths[rng.integers(b)] = hi
    return [prompt(rng, vocab_words, int(n)) for n in lengths]


def calls(seed: int, b: int, buckets):
    """A closed-loop client's calls, without end: each run of
    ``len(buckets)`` consecutive calls holds every bucket once, in an order
    drawn from the seed, so every seed sends the same mix of shapes. Yields
    (prompts, the call's own seed)."""
    rng = np.random.default_rng(seed)
    vocab_words = words()
    while True:
        for k in rng.permutation(len(buckets)):
            lo, hi = buckets[k]
            yield (batch_prompts(rng, vocab_words, b, lo, hi), int(rng.integers(0, 2 ** 31 - 1)))


def call_schedule(seed: int, n: int, b: int, buckets) -> list[tuple[list[str], int]]:
    """The first ``n`` of ``calls``."""
    return list(itertools.islice(calls(seed, b, buckets), n))


def make_weights(m: dict, seed: int, device) -> tuple[dict, dict]:
    """-> (parameters {name: f32 tensor}, batch-norm statistics {name:
    tensor}) of a fresh model, the kernels drawn in one call."""
    spec = param_spec(m)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    drawn = [k for k, s in spec.items() if not _is_constant(k, s)]
    flat = torch.randn(sum(math.prod(spec[k]) for k in drawn), generator=gen, device=device)
    w, off = {}, 0
    for k in drawn:
        s = spec[k]
        n = math.prod(s)
        fan_in = s[0] if k.endswith((".v", "embedding")) else math.prod(s[1:])
        w[k] = (flat[off:off + n] / math.sqrt(fan_in)).reshape(s)
        off += n
    for k, s in spec.items():
        if k not in w:
            w[k] = torch.full(s, _constant(k), device=device)
    stats = {}
    for name in batch_norm_names(m):
        c = spec[f"{name}.weight"][0]
        stats[f"{name}.running_mean"] = torch.zeros(c, device=device)
        stats[f"{name}.running_var"] = torch.ones(c, device=device)
    return w, stats


def _is_constant(name: str, shape) -> bool:
    return name.endswith(".bias") or (name.endswith(".weight") and len(shape) == 1)


def _constant(name: str) -> float:
    if name.endswith(".weight"):
        return 1.0                                   # batch-norm scale
    owner = name.rsplit(".", 2)[-2]
    if owner in ("gates", "gates_x"):
        return 1.0
    if owner.startswith("T") and owner[1:].isdigit():
        return -1.0
    return 0.0


def speech_like(seed: int, b: int, n: int, sample_rate: int, device) -> torch.Tensor:
    """(b, n) waveforms shaped like voiced speech: a glottal pulse train
    (harmonics of a gliding 90-220 Hz pitch, falling 12 dB an octave)
    through three formant resonances, gated at a syllable rate of 3-5 Hz,
    over noise 40 dB down. Its spectrogram is nearly consistent, so
    Griffin-Lim converges on it, which it does not on the spectrograms of
    random weights."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 3)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    t = torch.arange(n, device=device) / sample_rate
    f0 = u(b, 1, lo=90.0, hi=220.0) * (1 + 0.15 * torch.sin(2 * math.pi * u(b, 1, lo=0.5, hi=2.0) * t))
    phase = 2 * math.pi * torch.cumsum(f0 / sample_rate * torch.ones_like(t), -1)
    formants = u(b, 3, 1, lo=1.0, hi=1.3) * torch.tensor([[500.0], [1500.0], [2500.0]], device=device)
    y = torch.zeros(b, n, device=device)
    for k in range(1, 41):
        fk = k * f0
        gain = sum(torch.exp(-((fk - formants[:, j]) / 150.0) ** 2) for j in range(3)) / k
        y = y + gain * torch.sin(k * phase) * (fk < sample_rate / 2)
    gate = 0.5 + 0.5 * torch.sin(2 * math.pi * u(b, 1, lo=3.0, hi=5.0) * t + u(b, 1, hi=6.0))
    y = y * gate ** 2
    y = y / y.abs().amax(-1, keepdim=True)
    return y + 0.01 * torch.randn((b, n), generator=gen, device=device)


def train_pool(seed: int, n: int, b: int, t_in: int, t_out: int, n_mels: int, n_freq: int,
               vocab_size: int, device) -> list[tuple]:
    """``n`` training batches on the device, every row full: (text ids,
    text lengths, mel, linear, frame lengths), targets uniform in [0, s]
    with a level s per row that rises over the batch from 0.25 to 1 (row i
    in [0.25 + 0.75 i / b, 0.25 + 0.75 (i + 1) / b)), so no half of a batch
    stands for the whole: every row's loss differs."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    ids = torch.randint(1, vocab_size, (n, b, t_in), generator=gen, device=device)
    mel = torch.rand((n, b, t_out, n_mels), generator=gen, device=device)
    lin = torch.rand((n, b, t_out, n_freq), generator=gen, device=device)
    rows = torch.arange(b, device=device)[None, :, None, None]
    level = 0.25 + 0.75 * (rows + torch.rand((n, b, 1, 1), generator=gen, device=device)) / b
    mel, lin = mel * level, lin * level
    tl = torch.full((b,), t_in, dtype=torch.int64, device=device)
    fl = torch.full((b,), t_out, dtype=torch.int64, device=device)
    return [(ids[i], tl, mel[i], lin[i], fl) for i in range(n)]
