"""One served call in the reference: prompts to mel, linear spectrogram,
alignments, end frames and the Griffin-Lim spectrum, as the served recipe
states it (``cfg``: the configuration's model and audio sections and the
recipe's ``infer`` section, as plain dicts).

The decode is feed-previous for ``n_steps`` steps. With ``early_exit`` it
stops after the step at which every row has been silent (all r frames
below ``silence_threshold``) for ``ceil(min_silence_frames / r)`` steps;
later frames and alignments are zero. End frames come from the mel; with
``trim_before_gl`` Griffin-Lim runs on the frames up to the batch's
largest end frame, rounded up to ``gl_length_quantum``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import audio
from benchmark.reference.masks import ServeMasks
from benchmark.reference.model import F32, Model, Precision


def synthesize(cfg: dict, w: dict, stats: dict, ids, lengths, seed: int, *, n_steps: int,
               gl_iters: int, keep_fn=None, precision: Precision = F32,
               gl_precision: Precision = F32, decode_precision: Precision | None = None) -> dict:
    """-> {mel, linear, alignments, end_frames, t_gl, magnitude, re, im}
    (tensors on the inputs' device, end frames numpy; ``gl_iters`` 0 runs
    no Griffin-Lim and gives ``re``, ``im`` None). ``keep_fn(masks,
    step)`` gives the decoder pre-net's masks of a step (default: the next
    draws of ``masks``). ``decode_precision`` (default ``precision``): the
    decoder steps' products."""
    m, a, inf = cfg["model"], cfg["audio"], cfg["infer"]
    dev = ids.device
    b, t_in = ids.shape
    rate = m["prenet_dropout"]
    masks = ServeMasks(seed, b, t_in, m["prenet_dims"], rate, dev)
    model = Model(m, w, {k: (stats[f"{k}.running_mean"], stats[f"{k}.running_var"])
                         for k in _bn_names(stats)}, precision=precision,
                  decode_precision=decode_precision)
    memory, keys = model.encode(ids, lengths, masks.encoder)
    mask = torch.arange(t_in, device=dev)[None, :] < lengths[:, None]
    step_keep = keep_fn(masks) if keep_fn is not None else (lambda s: masks.step())
    r, n = m["r"], m["n_mels"]
    min_steps = max(1, -(-inf["min_silence_frames"] // r))
    state = model.init_state(b, dev)
    frames = torch.zeros(b, n_steps, r * n, device=dev)
    aligns = torch.zeros(b, n_steps, t_in, device=dev)
    run = torch.zeros(b, dtype=torch.int64, device=dev)
    for s in range(n_steps):
        state, f, al = model.decoder_step(state, state[3], keys, memory, mask, step_keep(s))
        frames[:, s], aligns[:, s] = f, al
        if inf["early_exit"]:
            silent = f.amax(-1) < inf["silence_threshold"]
            run = torch.where(silent, run + 1, 0)
            if bool((run >= min_steps).all()):
                break
    mel = frames.reshape(b, n_steps * r, n)
    linear = model.postnet(mel)
    ends = audio.end_frames(mel.cpu().numpy(), inf["silence_threshold"], inf["min_silence_frames"])
    t_gl = mel.shape[1]
    if inf["trim_before_gl"]:
        q = inf["gl_length_quantum"]
        t_gl = min(int(-(-max(int(ends.max()), q) // q) * q), t_gl)
    mag = audio.magnitude(linear[:, :t_gl], a)
    re = im = None
    if gl_iters:
        re, im = audio.griffin_lim(mag, a, gl_iters, a["gl_momentum"], gl_precision)
    return {"mel": mel, "linear": linear, "alignments": aligns, "end_frames": ends,
            "t_gl": t_gl, "magnitude": mag, "re": re, "im": im}


def _bn_names(stats: dict) -> list[str]:
    return [k[:-len(".running_mean")] for k in stats if k.endswith(".running_mean")]


def fused_keep_fn(m: dict, b: int):
    """The fused decode's masks: a seed drawn after the encoder's masks
    (``randint(0, 2**31 - 1)``); on the card the kernel keeps unit ``u`` of
    pre-net layer ``l`` at row ``i`` and step ``s`` where a murmur3-finalised
    hash of (seed, i, s, l, u) is below ``(1 - rate) 2^32``; on the CPU its
    plain version draws each step's masks from the generator after it."""
    rate = m["prenet_dropout"]
    threshold = min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)

    def make(masks):
        seed = masks.seed_draw() & 0xFFFFFFFF
        dev = masks.device
        if torch.device(dev).type == "cpu":
            return lambda s: masks.step()
        rows = torch.arange(b, dtype=torch.int64, device=dev)
        units = [torch.arange(d, dtype=torch.int64, device=dev) for d in m["prenet_dims"]]
        h0 = _fmix32(torch.tensor((seed + 0x9E3779B9) & 0xFFFFFFFF, device=dev))
        h_row = _fmix32(h0 ^ _mul32(rows, 0x85EBCA6B))

        def step(s):
            h = _fmix32(h_row ^ ((s * 0xC2B2AE35) & 0xFFFFFFFF))
            return tuple(_fmix32(h[:, None] ^ ((layer << 20) ^ u)[None, :]) < threshold
                         for layer, u in enumerate(units))

        return step

    return make


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), without overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def sample_gaps(prog: dict, ref: dict, a: dict, hop: int, wav: bool = True) -> dict:
    """The numbers one served call is compared by (see ``benchmark/compare.py``);
    ``wav``: with the served waveforms' (``wav_sc_excess``)."""
    def rel(x, y):
        if x.shape != y.shape:
            return float("inf")
        y = y.float()
        return float((x.float() - y).abs().max() / y.abs().max().clamp_min(1e-6))

    dev = ref["mel"].device
    mel_p = torch.from_numpy(prog["mel"]).to(dev)
    lin_p = torch.from_numpy(prog["linear"]).to(dev)
    al_p = torch.from_numpy(prog["alignments"]).to(dev)
    wav_p = torch.from_numpy(prog["wavs"]).to(dev)
    ends_p = np.asarray(prog["end_frames"])
    ends_bad = (int((ends_p != ref["end_frames"]).sum()) if ends_p.shape == ref["end_frames"].shape
                else len(ref["end_frames"]))
    ends_bad += int(wav_p.shape[1] != hop * (ref["t_gl"] - 1))
    ends_bad += int((~torch.isfinite(wav_p)).any(-1).sum())
    return {"mel_gap": rel(mel_p, ref["mel"]), "linear_gap": rel(lin_p, ref["linear"]),
            "align_gap": (float((al_p - ref["alignments"]).abs().max())
                          if al_p.shape == ref["alignments"].shape else float("inf")),
            "end_frames_wrong": ends_bad, **(wav_sc_excess(lin_p, wav_p, a) if wav else {})}


def wav_sc_excess(linear, wav, a: dict) -> dict:
    """The served waveforms held to the served spectrogram: Griffin-Lim,
    the final inverse transform and de-emphasis, as served. The target is
    the magnitude of the served linear spectrogram over the waveform's
    frames; the reference runs its own Griffin-Lim on that same target.
    -> {wav_sc_excess: the served waveform's spectral convergence less the
    reference's, the mean over the rows; wav_sc_ref: the reference's}. A
    waveform cannot be followed sample by sample (Griffin-Lim multiplies a
    difference 3-10 times an iteration); the mean over the rows keeps what
    the arithmetic adds to every row."""
    hop = a["hop_length"]
    t_gl = wav.shape[1] // hop + 1
    if not torch.isfinite(wav).all() or t_gl > linear.shape[1]:
        return {"wav_sc_excess": float("inf"), "wav_sc_ref": float("nan")}
    mag = audio.magnitude(linear[:, :t_gl], a)
    re, im = audio.griffin_lim(mag, a, a["griffin_lim_iters"], a["gl_momentum"])
    sc_ref = audio.spectral_convergence(audio.Stft(a, mag.device).synthesis(re, im), mag, a, None)
    sc = audio.spectral_convergence(wav, mag, a, a["preemphasis"])
    return {"wav_sc_excess": float((sc - sc_ref).mean()), "wav_sc_ref": float(sc_ref.mean())}


def gl_stage(a: dict, linear, wav, gl_iters: int, gl_precision: Precision = F32) -> dict:
    """Griffin-Lim held by itself: ``wav`` is what the served stage made of
    the normalised spectrogram ``linear`` (made by the benchmark from a
    speech-like waveform); the reference runs its own Griffin-Lim on the
    same input. -> {gl_sc_excess: the served waveform's spectral
    convergence against the target magnitude less the reference's, the
    mean over the rows}. One row's difference swings with the path each
    side's rounding sends Griffin-Lim down; the mean over the batch keeps
    what the arithmetic adds to every row."""
    mag = audio.magnitude(linear, a)
    re, im = audio.griffin_lim(mag, a, gl_iters, a["gl_momentum"], gl_precision)
    sc_ref = audio.spectral_convergence(audio.Stft(a, mag.device).synthesis(re, im), mag, a, None)
    sc = audio.spectral_convergence(wav, mag, a, a["preemphasis"])
    return {"gl_sc_excess": float((sc - sc_ref).mean()), "gl_sc_ref": float(sc_ref.mean())}
