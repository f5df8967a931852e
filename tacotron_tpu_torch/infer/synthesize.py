"""Synthesis: text -> autoregressive decode -> post-net -> Griffin-Lim -> wav.

Port of the JAX package's ``infer/synthesize.py``. Throughput is measured
as audio-seconds synthesized per second, so the API is batch-first.

``fused=True`` decodes through the fused decode kernel (``ops/
decode_loop.py``) instead of the step-by-step ``Decoder``; both paths
share the parameters. Griffin-Lim runs on the backend ``cfg.audio``
names (the Griffin-Lim kernel in its bf16 mode by default).

``cfg.infer`` holds the mitigations for the missing stop token, all off by
default: ``early_exit`` decodes with ``decode_while``, which stops once the
whole batch has gone silent; ``trim_before_gl`` cuts the linear spectrogram
to the batch's largest detected end frame, rounded up to
``gl_length_quantum``, before Griffin-Lim, so the dominant cost is not
spent on padding. The trimming metadata (end_frames, wav_lengths, trimmed
audio seconds) is returned whatever the flags.

``mesh=`` (``parallel.make_mesh``) is data-parallel synthesis over the
processes of the mesh's data axis: every process holds the whole prompt
list, pads the batch with length-1 rows to a multiple of the data size and
takes its slice (its data index's, in process order). Each process runs
the step-by-step decode, the post-net and Griffin-Lim (the kernel on the
card) on its slice, with the dropout masks of the global batch; the
outputs are all-gathered, so every process returns the whole batch, and
the pad rows are cut off. As in JAX, the fused decode and early exit /
trimming (host-driven) are refused on a mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.dsp.audio import gl_spectrum, spectrogram_magnitude, spectrum_to_wav
from tacotron_tpu_torch.infer.early_exit import decode_while, end_frames_device
from tacotron_tpu_torch.models.tacotron import Tacotron, length_mask
from tacotron_tpu_torch.ops.decode_loop import decode_loop, pack_decoder_weights
from tacotron_tpu_torch.parallel.collectives import all_gather_cat
from tacotron_tpu_torch.runtime import resolve_device

STAGES = ("encoder", "decode", "postnet", "griffin_lim", "istft_inv_preemphasis")


class _StageClock:
    """Milliseconds per stage; synchronises the device at each mark so a
    stage's time is its own. Off unless asked for."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device, self.enabled = device, enabled
        self.ms: dict[str, float] = {}
        self._t = self._now() if enabled else 0.0

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, stage: str):
        if self.enabled:
            now = self._now()
            self.ms[stage] = (now - self._t) * 1e3
            self._t = now


class Synthesizer:
    """``Synthesizer(cfg, params, batch_stats, vocab, fused=..., mesh=None,
    device=None)``.

    ``params``/``batch_stats`` are the port's state-dict entries
    (``weights.from_flax``), full on every process of a mesh.
    ``cfg.model.compute_dtype`` "bfloat16" runs the model's products in
    bf16, the attention keys included, on every decode path. ``device=None``
    means the mesh's device, else the GPU, and raises when there is none;
    pass ``device="cpu"`` for the plain PyTorch versions.
    """

    def __init__(self, cfg: Config, params, batch_stats, vocab: Vocab,
                 fused: bool = False, mesh=None, device=None):
        icfg = cfg.infer
        if fused and (icfg.early_exit or icfg.trim_before_gl):
            # refusing beats silently decoding the full fixed length (the
            # compute saving the flags promise would never happen)
            raise ValueError("fused decode cannot combine with "
                             "early_exit/trim_before_gl (host-driven paths); "
                             "turn one off")
        if mesh is not None:
            if fused:
                raise ValueError("mesh synthesis uses the scan decode "
                                 "(GSPMD); drop fused=True")
            if icfg.early_exit or icfg.trim_before_gl:
                raise ValueError("mesh synthesis: early-exit/trim are "
                                 "host-driven; turn them off for DP")
            if device is None:
                device = mesh.device
        self.cfg = cfg
        self.vocab = vocab
        self.fused = fused
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = Tacotron(cfg.model, device=self.device)
        self.model.load_state_dict({**params, **batch_stats}, strict=True)
        self.model.eval()

    def encode_texts(self, texts: list[str], pad_to: int | None = None):
        """-> (ids (B, T) int64, lengths (B,)) on the device; T is the longest
        prompt's length, or ``pad_to`` if that is longer."""
        if not texts:
            raise ValueError("no prompts: texts is empty")
        ids = [self.vocab.encode(t) for t in texts]
        max_len = max(len(i) for i in ids)
        if pad_to is not None:
            max_len = max(max_len, pad_to)
        text = np.zeros((len(ids), max_len), np.int64)
        lengths = np.zeros((len(ids),), np.int64)
        for j, a in enumerate(ids):
            text[j, :len(a)] = a
            lengths[j] = len(a)
        return (torch.from_numpy(text).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    @torch.no_grad()
    def __call__(self, texts: list[str], n_steps: int | None = None,
                 gl_iters: int | None = None, seed: int = 0,
                 peak_normalize: bool = True, stage_ms: bool = False):
        """Synthesize a batch. Returns a dict with mel, linear, alignments,
        wavs (B, T_samples), end_frames (first detected-silence frame),
        wav_lengths (samples), audio_seconds (padded total) and
        trimmed_audio_seconds, as numpy; with ``stage_ms`` also the
        milliseconds of each of ``STAGES``."""
        cfg, m = self.cfg, self.model
        mcfg, icfg = cfg.model, cfg.infer
        n_steps = mcfg.max_decode_steps if n_steps is None else n_steps
        gl_iters = cfg.audio.griffin_lim_iters if gl_iters is None else gl_iters
        text, lengths = self.encode_texts(texts)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        clock = _StageClock(self.device, stage_ms)
        n_real, mesh = text.shape[0], self.mesh
        if mesh is not None:
            # pad to a multiple of the data size with length-1 rows (a real
            # mask; the rows are cut off below) and keep this rank's slice
            nd = mesh.data_size
            pad = -n_real % nd
            text = torch.cat([text, text.new_zeros(pad, text.shape[1])])
            lengths = torch.cat([lengths, lengths.new_ones(pad)])
            per = text.shape[0] // nd
            lo = mesh.data_index * per
            text, lengths = text[lo:lo + per], lengths[lo:lo + per]
            gen = mesh.batch_shard(gen)

        mask = length_mask(text.shape[1], lengths)
        memory = m.encoder(text, lengths, gen)
        keys = m.memory_proj(memory)
        clock.mark("encoder")
        if self.fused:
            kernel_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                            device=self.device).item())
            frames, align = decode_loop(
                memory, keys, mask, pack_decoder_weights(m.decoder.cell),
                n_steps=n_steps, seed=kernel_seed,
                dropout=mcfg.prenet_dropout > 0,
                dropout_rate=mcfg.prenet_dropout, generator=gen)
            mel = frames.reshape(text.shape[0], n_steps * mcfg.r, mcfg.n_mels)
        elif icfg.early_exit:
            # the stop unit is a decoder step = r frames
            mel, align, _ = decode_while(
                memory, keys, mask, pack_decoder_weights(m.decoder.cell), gen,
                n_steps=n_steps, r=mcfg.r, n_mels=mcfg.n_mels,
                dropout_rate=mcfg.prenet_dropout,
                silence_threshold=icfg.silence_threshold,
                min_silence_steps=max(1, -(-icfg.min_silence_frames // mcfg.r)))
        else:
            mel, align = m.decoder(memory, keys, mask, n_steps, gen)
        clock.mark("decode")
        linear = m.postnet(mel)
        clock.mark("postnet")
        gl_in = linear
        if mesh is None:
            ends = end_frames_device(mel, threshold=icfg.silence_threshold,
                                     min_run=icfg.min_silence_frames).cpu().numpy()
        if icfg.trim_before_gl:
            q = icfg.gl_length_quantum
            t_gl = min(int(-(-max(int(ends.max()), q) // q) * q), linear.shape[1])
            gl_in = linear[:, :t_gl]
        re, im = gl_spectrum(spectrogram_magnitude(gl_in, cfg.audio), cfg.audio,
                             gl_iters)
        clock.mark("griffin_lim")
        wav = spectrum_to_wav(re, im, cfg.audio)
        if mesh is not None:
            if mesh.data_group is not None:
                mel, linear, align, wav = (all_gather_cat(x, mesh.data_group)
                                           for x in (mel, linear, align, wav))
            mel, linear, align, wav = (x[:n_real] for x in (mel, linear, align, wav))
            ends = end_frames_device(mel, threshold=icfg.silence_threshold,
                                     min_run=icfg.min_silence_frames).cpu().numpy()
        if peak_normalize:
            peak = wav.abs().amax(dim=-1, keepdim=True)
            wav = wav / torch.clamp(peak, min=1e-3)
        clock.mark("istft_inv_preemphasis")

        wav = wav.cpu().numpy()
        wav_lengths = np.minimum(ends * cfg.audio.hop_length, wav.shape[1])
        out = {
            "mel": mel.cpu().numpy(),
            "linear": linear.cpu().numpy(),
            "alignments": align.cpu().numpy(),
            "wavs": wav,
            "end_frames": ends,
            "wav_lengths": wav_lengths,
            "audio_seconds": wav.shape[0] * wav.shape[1] / cfg.audio.sample_rate,
            "trimmed_audio_seconds": float(wav_lengths.sum()) / cfg.audio.sample_rate,
        }
        if stage_ms:
            out["stage_ms"] = dict(clock.ms)
        return out
