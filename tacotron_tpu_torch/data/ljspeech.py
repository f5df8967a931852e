"""Corpus I/O and preprocessing: metadata + wavs -> packed feature arrays.

Port of the JAX package's ``data/ljspeech.py``. Features are computed
batched on the device (``device=None``: the card; ``device="cpu"``: the
CPU): utterances are chunked, padded to the chunk's longest, transformed in
one call, then trimmed, and packed into single contiguous arrays with an
offset index. The layout is the JAX package's, so either package's loader
reads the other's data directory.

Storage layout under ``data_dir``:
    vocab.json                 char -> id
    index.json                 [{id, text_offset, text_len, frame_offset, n_frames}]
    texts.npy    int32  (sum_text_len,)
    mels.npy     float16 (sum_frames, n_mels)      normalised [0,1]
    linears.npy  float16 (sum_frames, n_freq)
    config.json  audio config used
"""

from __future__ import annotations

import dataclasses
import json
import os
import wave

import numpy as np
import torch

from tacotron_tpu_torch.config import AudioConfig
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.dsp.audio import melspectrogram, spectrogram
from tacotron_tpu_torch.runtime import resolve_device


def load_wav(path: str, expect_rate: int | None = None) -> np.ndarray:
    """16-bit PCM mono wav -> float32 in [-1, 1].

    When the file's rate differs from ``expect_rate`` the signal is
    polyphase-resampled to it, as the reference's librosa load did."""
    with wave.open(path, "rb") as f:
        if f.getnchannels() != 1 or f.getsampwidth() != 2:
            raise ValueError(f"{path}: expected mono 16-bit PCM, got "
                             f"{f.getnchannels()} channel(s) of {8 * f.getsampwidth()} bits")
        rate = f.getframerate()
        data = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
    y = data.astype(np.float32) / 32768.0
    if expect_rate is not None and rate != expect_rate:
        y = resample(y, rate, expect_rate)
    return y


def resample(y: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Rate conversion by scipy's polyphase filter (windowed-sinc
    anti-aliasing)."""
    if orig_rate == target_rate:
        return y
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(orig_rate), int(target_rate))
    return resample_poly(y, target_rate // g, orig_rate // g).astype(np.float32)


def save_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Mono 16-bit PCM: ``wav`` clipped to [-1, 1], times 32767, truncated."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def read_metadata(corpus_dir: str, fmt: str = "ljspeech") -> list[tuple[str, str, str]]:
    """Corpus metadata -> [(id, wav_path, text)].

    Formats mirror the reference's per-dataset loaders (Nancy/Blizzard-2011,
    CMU ARCTIC and VCTK; LJSpeech is the primary target):
      ljspeech  metadata.csv `id|transcript|normalized`, wavs/<id>.wav
      vctk      txt/<spk>/<id>.txt one-transcript files, wav48/<spk>/<id>.wav
      arctic    etc/txt.done.data lines `( id "text" )`, wav/<id>.wav
      blizzard  prompts.gui / prompts.data style `( id "text" )`, wavn/<id>.wav
    """
    if fmt == "ljspeech":
        entries = []
        with open(os.path.join(corpus_dir, "metadata.csv"), encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) < 2:
                    continue
                utt_id = parts[0]
                text = parts[2] if len(parts) > 2 and parts[2] else parts[1]
                wav = os.path.join(corpus_dir, "wavs", utt_id + ".wav")
                entries.append((utt_id, wav, text))
        return entries

    if fmt == "vctk":
        entries = []
        txt_root = os.path.join(corpus_dir, "txt")
        for spk in sorted(os.listdir(txt_root)):
            spk_dir = os.path.join(txt_root, spk)
            if not os.path.isdir(spk_dir):
                continue
            for name in sorted(os.listdir(spk_dir)):
                if not name.endswith(".txt"):
                    continue
                utt_id = name[:-4]
                with open(os.path.join(spk_dir, name), encoding="utf-8") as f:
                    text = f.read().strip()
                wav = os.path.join(corpus_dir, "wav48", spk, utt_id + ".wav")
                if text and os.path.exists(wav):
                    entries.append((utt_id, wav, text))
        return entries

    if fmt in ("arctic", "blizzard"):
        import re

        if fmt == "arctic":
            meta = os.path.join(corpus_dir, "etc", "txt.done.data")
            wav_dir = os.path.join(corpus_dir, "wav")
        else:
            candidates = ["prompts.gui", "prompts.data",
                          os.path.join("etc", "prompts.data")]
            meta = next((os.path.join(corpus_dir, c) for c in candidates
                         if os.path.exists(os.path.join(corpus_dir, c))), None)
            if meta is None:
                raise FileNotFoundError(f"no prompts file found in {corpus_dir}")
            wav_dir = os.path.join(corpus_dir, "wavn")
        entries = []
        pat = re.compile(r'\(\s*(\S+)\s+"(.*)"\s*\)')
        with open(meta, encoding="utf-8", errors="replace") as f:
            for line in f:
                m = pat.search(line)
                if not m:
                    continue
                utt_id, text = m.group(1), m.group(2)
                wav = os.path.join(wav_dir, utt_id + ".wav")
                if os.path.exists(wav):
                    entries.append((utt_id, wav, text))
        return entries

    raise ValueError(f"unknown corpus format: {fmt}")


@torch.no_grad()
def _features_batched(wavs: list[np.ndarray], cfg: AudioConfig, chunk: int = 16,
                      device=None):
    """(mel, linear, n_frames) per wav, f32 numpy, computed a chunk at a time
    on ``device`` (None: the card).

    Pre-emphasis and the centre reflect padding are applied PER UTTERANCE on
    the host before batching, and the STFT then runs with ``center=False``,
    so the reflected tail frames mirror the utterance's own samples: batch
    zero-padding never reaches the ``len(w) // hop + 1`` frames kept, and the
    features do not depend on how utterances are grouped into chunks. The
    padded length is rounded up to hop * 64, as the JAX package rounds it.
    """
    dev = resolve_device(device)
    pad = cfg.n_fft // 2
    q = cfg.hop_length * 64
    out = []
    for i in range(0, len(wavs), chunk):
        group = wavs[i : i + chunk]
        prepped = [np.pad(np.concatenate([w[:1], w[1:] - cfg.preemphasis * w[:-1]]), pad,
                          mode="reflect") for w in group]
        max_len = -(-max(len(p) for p in prepped) // q) * q
        padded = np.zeros((len(group), max_len), np.float32)
        for j, p in enumerate(prepped):
            padded[j, : len(p)] = p
        y = torch.from_numpy(padded).to(dev)
        mel = melspectrogram(y, cfg, preemph=False, center=False).cpu().numpy()
        lin = spectrogram(y, cfg, preemph=False, center=False).cpu().numpy()
        for j, w in enumerate(group):
            n_frames = len(w) // cfg.hop_length + 1
            out.append((mel[j, :n_frames], lin[j, :n_frames], n_frames))
    return out


def preprocess(corpus_dir: str, data_dir: str, cfg: AudioConfig,
               limit: int | None = None, chunk: int = 16,
               fmt: str = "ljspeech", device=None) -> dict:
    """The full offline prep (reference: python preprocess.py <dataset>),
    with the features computed on ``device`` (None: the card, raising
    without one; ``"cpu"``: the CPU)."""
    dev = resolve_device(device)
    os.makedirs(data_dir, exist_ok=True)
    entries = read_metadata(corpus_dir, fmt)
    if limit:
        entries = entries[:limit]

    vocab = Vocab.build([t for _, _, t in entries])
    vocab.save(os.path.join(data_dir, "vocab.json"))

    wavs = [load_wav(p, cfg.sample_rate) for _, p, _ in entries]
    feats = _features_batched(wavs, cfg, chunk, dev)

    index = []
    text_parts, mel_parts, lin_parts = [], [], []
    text_off = frame_off = 0
    for (utt_id, _, text), (mel, lin, n_frames) in zip(entries, feats):
        ids = vocab.encode(text)
        index.append({
            "id": utt_id,
            "text_offset": text_off, "text_len": int(len(ids)),
            "frame_offset": frame_off, "n_frames": int(n_frames),
        })
        text_parts.append(ids)
        mel_parts.append(mel.astype(np.float16))
        lin_parts.append(lin.astype(np.float16))
        text_off += len(ids)
        frame_off += n_frames

    np.save(os.path.join(data_dir, "texts.npy"), np.concatenate(text_parts))
    np.save(os.path.join(data_dir, "mels.npy"), np.concatenate(mel_parts, axis=0))
    np.save(os.path.join(data_dir, "linears.npy"), np.concatenate(lin_parts, axis=0))
    with open(os.path.join(data_dir, "index.json"), "w") as f:
        json.dump(index, f)
    with open(os.path.join(data_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return {"n_utterances": len(index), "vocab_size": len(vocab),
            "total_frames": frame_off}


def generate_char_tone_corpus(corpus_dir: str, n: int = 8,
                              sample_rate: int = 22050, seed: int = 0,
                              char_sec: float = 0.06, text_len: int = 12,
                              alphabet_size: int = 10,
                              char_sec_jitter: float = 0.0) -> None:
    """Synthetic corpus where audio IS the text: each character renders as a
    fixed-duration tone whose pitch encodes the character. Attention has a
    ground-truth monotonic alignment to learn — used by the overfit-alignment
    health check (SURVEY.md §4.3).

    ``alphabet_size`` (2..26): with a larger alphabet and enough utterances
    the decoder cannot memorise per-utterance outputs from its autoregressive
    state alone, so attention MUST resolve text position — which is exactly
    what the alignment probe needs to demonstrate (VERDICT.md r1 item 2: a
    small repeated-character corpus overfits with near-flat attention).

    ``char_sec_jitter`` (0..1): each character's duration is drawn uniformly
    from char_sec * [1-j, 1+j]. With fixed durations the decoder can learn
    the boundary SCHEDULE by counting steps (and solve the rest by copying
    the teacher-forced previous frame); random per-character durations make
    boundary timing observable only through the text — i.e. through
    attention. The ground-truth alignment stays monotonic, just not
    uniform-slope, so the monotonicity/diag-corr scores still apply."""
    rs = np.random.default_rng(seed)
    os.makedirs(os.path.join(corpus_dir, "wavs"), exist_ok=True)
    alphabet = "abcdefghijklmnopqrstuvwxyz"[:alphabet_size]
    lines = []
    for i in range(n):
        utt_id = f"CT-{i:04d}"
        chars = rs.choice(list(alphabet), size=text_len)
        text = "".join(chars)
        segs = []
        for c in chars:
            dur = char_sec
            if char_sec_jitter > 0:
                dur = char_sec * float(rs.uniform(1 - char_sec_jitter,
                                                  1 + char_sec_jitter))
            f0 = 180.0 + 55.0 * (ord(c) - ord("a"))
            t = np.arange(int(dur * sample_rate)) / sample_rate
            ramp = min(0.008, dur / 4)
            env = np.minimum(1.0, np.minimum(t / ramp, (dur - t) / ramp).clip(0))
            segs.append(0.6 * np.sin(2 * np.pi * f0 * t) * env)
        save_wav(os.path.join(corpus_dir, "wavs", utt_id + ".wav"),
                 np.concatenate(segs).astype(np.float32), sample_rate)
        lines.append(f"{utt_id}|{text}|{text}")
    with open(os.path.join(corpus_dir, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")


def decode_char_tones(wav: np.ndarray, sample_rate: int = 22050,
                      alphabet_size: int = 26, win: int = 512,
                      n_fft: int = 2048, hop: int = 64,
                      min_run: int = 4, grid_tol_hz: float = 15.0) -> str:
    """Inverse of generate_char_tone_corpus: wav -> text (pure numpy).

    Per analysis frame (window ~1 char long so adjacent tones don't smear;
    zero-padded FFT for frequency resolution below the 55 Hz pitch spacing),
    the dominant frequency is snapped to the corpus pitch grid
    (f0 = 180 + 55*k); frames whose dominant frequency sits further than
    ``grid_tol_hz`` from the grid are dropped (synthesized audio glides
    between tones — off-grid transition frames would otherwise register as
    phantom characters); low-energy frames (silence/padding tails) are
    dropped. The surviving frame runs are cleaned with three content-blind,
    physics-based rules before collapsing to characters (all thresholds in
    frames, derived from ``min_run``):

      1. single-frame runs are never characters (a rendered tone spans
         >= min_run analysis frames);
      2. a short run sandwiched between two runs of one same character is
         a rendering *wobble* of that character (the synthesized pitch
         momentarily crossing a grid neighbour), not a new symbol — it is
         deleted and its flanks merged;
      3. a short run whose pitch lies strictly BETWEEN its neighbours'
         pitches is a *pass-through* glide artifact (a monotonic pitch
         transition crosses every intermediate grid frequency exactly),
         not a character.

    Used by the end-to-end audio-evidence gate: synthesized audio is machine-
    checkable back to its prompt — the objective stand-in for the reference
    author listening to TensorBoard audio summaries (SURVEY.md §4.1)."""
    if len(wav) < win:
        return ""
    n_frames = 1 + (len(wav) - win) // hop
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(win)
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1))   # (T, F)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    # restrict to the tone band (alphabet pitches span 180..180+55*25 Hz)
    band = (freqs >= 120.0) & (freqs <= 180.0 + 55.0 * alphabet_size)
    band_idx = np.nonzero(band)[0]
    peak = spec[:, band_idx].max(axis=1)
    voiced = peak > 0.1 * (peak.max() + 1e-9)
    dom = freqs[band_idx[spec[:, band_idx].argmax(axis=1)]]
    k = np.round((dom - 180.0) / 55.0)
    if grid_tol_hz is not None:
        voiced &= np.abs(dom - (180.0 + 55.0 * k)) < grid_tol_hz
    chars = np.clip(k, 0, alphabet_size - 1).astype(int)
    # contiguous runs over voiced, on-grid frames: [char, n_frames, start, end)
    runs = []
    for i, (c, v) in enumerate(zip(chars, voiced)):
        if not v:
            continue
        if runs and runs[-1][0] == c and i == runs[-1][3]:
            runs[-1][1] += 1
            runs[-1][3] = i + 1
        else:
            runs.append([c, 1, i, i + 1])
    # rule 1: single-frame runs are never characters
    runs = [r for r in runs if r[1] >= 2]
    # merge same-char runs split by a short gap (dropped glide/silence frames)
    merged = []
    for r in runs:
        if merged and merged[-1][0] == r[0] and r[2] - merged[-1][3] <= min_run:
            merged[-1][1] += r[1]
            merged[-1][3] = r[3]
        else:
            merged.append(r)
    runs = merged
    # rule 2: wobble — short run between two same-char flanks
    changed = True
    while changed:
        changed = False
        for i in range(1, len(runs) - 1):
            if (runs[i][1] < min_run
                    and runs[i - 1][0] == runs[i + 1][0]
                    and runs[i][0] != runs[i - 1][0]
                    and runs[i + 1][2] - runs[i - 1][3] < 3 * min_run):
                runs[i - 1][1] += runs[i + 1][1]
                runs[i - 1][3] = runs[i + 1][3]
                del runs[i:i + 2]
                changed = True
                break
    # rule 3: pass-through glides; other short (>=2 frame) runs are kept —
    # the model compresses some character durations below min_run
    kept = []
    for i, (c, ln, _s, _e) in enumerate(runs):
        if ln < min_run:
            nb = [runs[j][0] for j in (i - 1, i + 1) if 0 <= j < len(runs)]
            if nb and min(nb) < c < max(nb):
                continue
        kept.append(c)
    out = []
    for c in kept:
        if not out or out[-1] != c:
            out.append(c)
    return "".join(chr(ord("a") + c) for c in out)


def char_accuracy(ref: str, hyp: str) -> float:
    """1 - levenshtein(ref, hyp)/len(ref) (floored at 0)."""
    m, n = len(ref), len(hyp)
    d = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        prev_diag, d[0] = d[0], i
        for j in range(1, n + 1):
            prev_diag, d[j] = d[j], min(
                d[j] + 1, d[j - 1] + 1,
                prev_diag + (ref[i - 1] != hyp[j - 1]))
    return max(0.0, 1.0 - d[n] / max(m, 1))


def generate_synthetic_corpus(corpus_dir: str, n: int = 8, sample_rate: int = 22050,
                              seed: int = 0, min_sec: float = 0.4,
                              max_sec: float = 1.2) -> None:
    """Synthetic LJSpeech-format corpus for tests/CI (no LJSpeech on disk —
    SURVEY.md §0). Each utterance is a tone chord keyed to its text."""
    rs = np.random.default_rng(seed)
    os.makedirs(os.path.join(corpus_dir, "wavs"), exist_ok=True)
    words = ["the quick brown fox", "jumps over", "a lazy dog", "hello world",
             "text to speech", "on tensor processing units", "griffin lim",
             "mel spectrogram", "attention alignment", "teacher forcing"]
    lines = []
    for i in range(n):
        utt_id = f"SYN-{i:04d}"
        text = words[i % len(words)] + f" number {i}"
        dur = float(rs.uniform(min_sec, max_sec))
        t = np.arange(int(dur * sample_rate)) / sample_rate
        f0 = 150.0 + 35.0 * (i % 7)
        wav = (0.45 * np.sin(2 * np.pi * f0 * t)
               + 0.25 * np.sin(2 * np.pi * 2.5 * f0 * t)
               + 0.02 * rs.standard_normal(len(t)))
        env = np.minimum(1.0, np.minimum(t / 0.05, (dur - t) / 0.05).clip(0))
        save_wav(os.path.join(corpus_dir, "wavs", utt_id + ".wav"),
                 (wav * env).astype(np.float32), sample_rate)
        lines.append(f"{utt_id}|{text}|{text}")
    with open(os.path.join(corpus_dir, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
