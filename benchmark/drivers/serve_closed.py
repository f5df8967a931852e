"""Closed-loop serving: one client sends a batch of prompts to
``Synthesizer.__call__`` and sends the next when its wavs are on the host.

Traffic parameters (``traffic/<name>.json``): ``preset`` (the port's
serving recipe), ``fused`` (the fused decode), ``batch``, ``buckets``
([shortest, longest] characters; each call draws one, and every run of
``len(buckets)`` calls holds each once), ``sample`` (calls the reference
follows: the first ``first``, ``random`` more drawn from the seed below
``below``, and the last) and ``trace_calls`` (calls profiled in a traced
run, from the window's second call on).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.signal import lfilter

from benchmark import harness, inputs
from benchmark.counts import flops
from benchmark.reference import audio
from benchmark.reference import serve as ref_serve
from benchmark.reference.model import Precision
from benchmark.trace import SPAN, graph_nodes


class Run:
    def __init__(self, cell, seed: int, device, overrides=None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.t = cell.traffic
        self.cfg = harness.port_config(cell, overrides)
        self.plain = harness.plain(self.cfg)
        self.b = self.t["batch"]
        self.buckets = [tuple(x) for x in self.t["buckets"]]

    # ------------------------------------------------------------ set-up
    def build(self):
        """The kernels, the weights and the ``Synthesizer``, no call yet."""
        from tacotron_tpu_torch import runtime
        from tacotron_tpu_torch.data.vocab import Vocab
        from tacotron_tpu_torch.infer.synthesize import Synthesizer

        if self.device.type == "cuda":
            runtime.build()
        self.weights, self.stats = inputs.make_weights(self.plain["model"], self.seed, self.device)
        vocab = Vocab.build([inputs.charset()])
        self.synth = Synthesizer(self.cfg, {k: v.clone() for k, v in self.weights.items()},
                                 {k: v.clone() for k, v in self.stats.items()}, vocab,
                                 fused=self.t["fused"], device=self.device)

    def setup(self):
        self.build()
        # every shape of the traffic: its eager first call, its capture, a replay
        warm = inputs.call_schedule(self.seed ^ 0x5EED, 3 * len(self.buckets), self.b,
                                    self.buckets)
        for texts, s in sorted(warm, key=lambda c: max(map(len, c[0]))):
            self.synth(texts, seed=s)
        self.graph_nodes = {}
        for key, entry in self.synth.graphs.items():
            self.graph_nodes[key[2]] = {
                name: sum(graph_nodes(g.graph).values()) for name, g in entry.captured()}

    # ------------------------------------------------------------ window
    def window(self, seconds: float, profile=None) -> dict:
        """Calls back to back until ``seconds`` have passed; ``profile``: a
        ``torch.profiler.profile``, started before the window's second call
        and stopped after its last traced one. Each traced call's ``info``
        gets ``wall_s``, the mean latency of the window's untraced calls of
        its shape: the profiler lengthens the calls it traces."""
        sample = self.t["sample"]
        rng = np.random.default_rng(self.seed)
        keep = set(range(sample["first"])) | set(
            int(x) for x in rng.integers(sample["first"], sample["below"], sample["random"]))
        n_trace = self.t["trace_calls"] if profile is not None else 0
        self.kept, self.span_info = {}, []
        lat, shapes, audio_s, k = [], [], 0.0, 0
        stream = inputs.calls(self.seed, self.b, self.buckets)
        start = time.perf_counter()
        while True:
            texts, s = next(stream)
            traced = 1 <= k <= n_trace
            if traced and k == 1:
                profile.start()
            t0 = time.perf_counter()
            if traced:
                with torch.profiler.record_function(SPAN):
                    out = self.synth(texts, seed=s)
            else:
                out = self.synth(texts, seed=s)
            t1 = time.perf_counter()
            if traced:
                self.span_info.append(self._info(texts, out))
                if k == n_trace:
                    profile.stop()
            lat.append(t1 - t0)
            shapes.append(max(map(len, texts)))
            audio_s += out["trimmed_audio_seconds"]
            if k in keep:
                self.kept[k] = (texts, s, out)
            last = (k, texts, s, out)
            k += 1
            if k > n_trace and t1 - start >= seconds:
                break
        self.kept[last[0]] = last[1:]
        for info in self.span_info:
            own = [x for j, x in enumerate(lat) if shapes[j] == info["t_in"] and not 1 <= j <= n_trace]
            if own:
                info["wall_s"] = sum(own) / len(own)
        elapsed = t1 - start
        return {"attempted": k, "failed": 0, "window_s": elapsed,
                "audio_s_per_s": audio_s / elapsed,
                "synth_p90_ms": float(np.percentile(np.array(lat) * 1e3, 90))}

    def _info(self, texts, out) -> dict:
        m, a = self.plain["model"], self.plain["audio"]
        t_in = max(map(len, texts))
        n_steps, t_gl = m["max_decode_steps"], out["wavs"].shape[1] // a["hop_length"] + 1
        return {"b": self.b, "t_in": t_in, "n_steps": n_steps, "t_gl": t_gl,
                "gl_iters": a["griffin_lim_iters"], "fused": self.t["fused"],
                "flops": flops.synth_call_flops(m, a, self.b, t_in, n_steps, t_gl,
                                                a["griffin_lim_iters"]),
                "graph_nodes": self.graph_nodes.get(t_in, {}), "model": m, "audio": a}

    def release(self):
        """Frees the program; first, where the cell compares the served
        Griffin-Lim stage held by itself (``gl_sc_excess``), the program's
        side of it runs (``gl_stage``)."""
        if "gl_sc_excess" in self.cell.checks["limits"]:
            self.stage = self.gl_stage(self._t_gl())
        del self.synth
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def _reference(self, texts, s, model="f32", gl=None, decode=None) -> dict:
        """The reference's call; Griffin-Lim only with a ``gl`` precision
        (a served call's waveform is held to its own spectrogram:
        ``reference/serve.py::wav_sc_excess``)."""
        ids, lengths = inputs.encode(texts)
        ids = torch.from_numpy(ids).to(self.device)
        lengths = torch.from_numpy(lengths).to(self.device)
        m, a = self.plain["model"], self.plain["audio"]
        keep_fn = ref_serve.fused_keep_fn(m, self.b) if self.t["fused"] else None
        with torch.no_grad():
            return ref_serve.synthesize(
                self.plain, self.weights, self.stats, ids, lengths, s,
                n_steps=m["max_decode_steps"], gl_iters=a["griffin_lim_iters"] if gl else 0,
                keep_fn=keep_fn, precision=Precision(model), gl_precision=Precision(gl or "f32"),
                decode_precision=Precision(decode or model))

    def _gaps(self, served: dict, ref: dict) -> dict:
        a = self.plain["audio"]
        with torch.no_grad():
            return ref_serve.sample_gaps(served, ref, a, a["hop_length"],
                                         wav="wav_sc_excess" in self.cell.checks["limits"])

    def _t_gl(self) -> int:
        """The window's largest Griffin-Lim length."""
        hop = self.plain["audio"]["hop_length"]
        return max(prog["wavs"].shape[1] for _, _, prog in self.kept.values()) // hop + 1

    def check(self) -> list[dict]:
        """The numbers of each call the reference follows, and where the
        cell compares it, of the Griffin-Lim stage held by itself."""
        out = [self._gaps(prog, self._reference(texts, s))
               for texts, s, prog in (self.kept[k] for k in sorted(self.kept))]
        if "gl_sc_excess" in self.cell.checks["limits"]:
            out.append(self._stage_gap(*self.stage))
        return out

    def control(self, model: str, gl: str, decode: str | None = None) -> list[dict]:
        """The reference in the lower precisions put in the program's place,
        held to the reference, on the calls the check follows."""
        out = []
        for k in sorted(self.kept):
            texts, s, _ = self.kept[k]
            low = _served(self._reference(texts, s, model, gl, decode), self.plain["audio"])
            out.append(self._gaps(low, self._reference(texts, s)))
        if "gl_sc_excess" in self.cell.checks["limits"]:
            out.append(self._stage_gap(*self.gl_stage(self._t_gl(), gl)))
        return out

    def wav_readings(self, control: dict | None = None) -> dict:
        """``wav_sc_excess`` alone, of each call the check follows, and with
        ``control`` (the cell's control precisions) of the reference in
        those precisions put in the program's place."""
        a = self.plain["audio"]

        def number(out):
            with torch.no_grad():
                return ref_serve.wav_sc_excess(torch.from_numpy(out["linear"]).to(self.device),
                                               torch.from_numpy(out["wavs"]).to(self.device), a)

        calls = [self.kept[k] for k in sorted(self.kept)]
        line = {"program_samples": [number(prog) for _, _, prog in calls]}
        if control is not None:
            line["control_samples"] = [number(_served(self._reference(texts, s, **control), a))
                                       for texts, s, _ in calls]
        return line

    def gl_stage(self, t_gl: int, control: str | None = None) -> tuple:
        """The served Griffin-Lim stage held by itself: the ``Synthesizer``'s
        own ``_gl`` (Griffin-Lim, the final inverse transform, de-emphasis,
        the scaling to the peak; the split path runs it as it is, after its
        graphs) on the normalised spectrogram of a speech-like waveform
        drawn from the seed, (batch, ``t_gl``) frames, on which Griffin-Lim
        converges; with ``control``, the reference's Griffin-Lim in that
        precision in its place. -> (spectrogram, waveform)."""
        a = self.plain["audio"]
        y = inputs.speech_like(self.seed, self.b, a["hop_length"] * (t_gl - 1), a["sample_rate"],
                               self.device)
        linear = audio.normalized_spectrogram(y, a)
        with torch.no_grad():
            if control is None:
                return linear, self.synth._gl(linear, a["griffin_lim_iters"])[1]
            re, im = audio.griffin_lim(audio.magnitude(linear, a), a, a["griffin_lim_iters"],
                                       a["gl_momentum"], Precision(control))
            return linear, torch.from_numpy(_served({"re": re, "im": im}, a)["wavs"]).to(self.device)

    def _stage_gap(self, linear, wav) -> dict:
        with torch.no_grad():
            return ref_serve.gl_stage(self.plain["audio"], linear, wav,
                                      self.plain["audio"]["griffin_lim_iters"])


def _served(ref: dict, a: dict) -> dict:
    """A reference call's outputs in the form ``Synthesizer`` returns them:
    the waveform through the final inverse transform, de-emphasis (an exact
    first-order recurrence in f64) and scaling to its peak."""
    y = audio.Stft(a, ref["re"].device).synthesis(ref["re"], ref["im"]).double().cpu().numpy()
    y = lfilter([1.0], [1.0, -a["preemphasis"]], y, axis=-1)
    y = y / np.maximum(np.abs(y).max(-1, keepdims=True), 1e-3)
    out = {k: ref[k].cpu().numpy() for k in ("mel", "linear", "alignments") if k in ref}
    return {**out, "end_frames": ref.get("end_frames"), "wavs": y.astype(np.float32)}
