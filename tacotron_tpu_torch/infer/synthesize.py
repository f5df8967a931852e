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

On one CUDA device a call runs as JAX runs it: each of the JAX
``Synthesizer``'s jits is a CUDA graph, captured per shape (``Synthesizer``
says when). The fixed-length path (JAX's ``_synth``) is one graph, text to
normalised waveform. The split path (``early_exit`` and/or
``trim_before_gl``; JAX's ``_model`` and ``_gl``) is a preamble graph
(encoder, keys, mask, packed weights, the zeroed early-exit carry; with
trimming alone the whole step-by-step decode), ``decode_while``'s chunk
graph replayed until the device says the batch is done, a post-net graph
over the full mel buffer with the end frames, then only the (B,) end
frames reach the host, and Griffin-Lim runs eagerly at the trimmed length
(``GRAPH_SHAPES`` says why).

``mesh=`` (``parallel.make_mesh``) is data-parallel synthesis over the
processes of the mesh's data axis: every process holds the whole prompt
list, pads the batch with length-1 rows to a multiple of the data size and
takes its slice (its data index's, in process order). Each process runs
the step-by-step decode, the post-net and Griffin-Lim (the kernel on the
card) on its slice, with the dropout masks of the global batch; the
outputs are all-gathered, so every process returns the whole batch, and
the pad rows are cut off. As in JAX, the fused decode and early exit /
trimming (host-driven) are refused on a mesh. On a mesh whose collectives
can be captured (NCCL groups, or none: ``parallel.collectives.capturable``)
a call runs as JAX's mesh synthesis runs its two jits: a model graph (the
step-by-step decode and the post-net on this process's rows) and a
Griffin-Lim graph (the kernel, the final iSTFT and inverse pre-emphasis on
those rows), captured per shape. The pad and the slice of the prompts come
before them, and the gather, the cut of the pad rows and the end frames
after them, eagerly, as JAX's gather to the host follows its jits. With no
trimming, Griffin-Lim's length is fixed by the shape. A mesh over gloo runs
eagerly: gloo's collectives go through host copies
(``parallel/collectives.py``), which no graph can capture.

``cfg.tacotron2`` set serves Tacotron 2 (``models/tacotron2.py``) on the
split path with its stop gate: the preamble graph (encoder, keys, mask, the
zeroed carry), the chunk graph of ``DECODE_CHUNK`` Tacotron 2 steps in
library operations, replayed until every row's gate has opened or the cap,
and the post-net graph (the conv post-net and ``mel_to_linear``); the end
frames, and with them Griffin-Lim's length, come from the gate. The fused
decode and a mesh are refused.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.dsp.audio import gl_spectrum, spectrogram_magnitude, spectrum_to_wav
from tacotron_tpu_torch.infer.early_exit import WhileDecode, end_frames_device, run_until_done
from tacotron_tpu_torch.models.tacotron import Tacotron, length_mask
from tacotron_tpu_torch.models.tacotron2 import Tacotron2
from tacotron_tpu_torch.ops.decode_loop import decode_loop, pack_decoder_weights
from tacotron_tpu_torch.parallel.collectives import all_gather_cat
from tacotron_tpu_torch.runtime import resolve_device
from tacotron_tpu_torch.utils import profiling

STAGES = ("encoder", "decode", "postnet", "griffin_lim", "istft_inv_preemphasis")
# what a call's record (utils.profiling) times: the stages, then the outputs'
# copies to the host; beside them ``chunk_gap``, the device's idle between
# the early-exit decode's chunks (the exit-flag reads)
RECORD_STAGES = (*STAGES, "to_host")
# shapes whose graphs a Synthesizer keeps; a new shape past them drops the
# least recently used one's
GRAPH_SHAPES = 8
# The split path's Griffin-Lim (JAX's ``_gl``, jitted per trimmed length
# ``t_gl``) runs eagerly and keeps no graph: a shape holds only its model
# graphs, whatever lengths it meets. A graph per length held a private pool
# of 44 MiB at ``t_gl`` 64 to 472 MiB at 1000 (B 8, n_fft 2048, GL 100),
# 3,900 MiB after 16 lengths in one shape, to save 15-19 ms of a 103-129
# ms call of a length seen before (H100 80GB HBM3, 700 W;
# tools/gl_graph_memory.py, PERF.md sections 5 and 6); a cap on the graphs
# kept would save it only for lengths that recur before the cap drops them.
# A mesh refuses trimming, so its Griffin-Lim length is fixed by the shape
# and a mesh shape keeps its Griffin-Lim graph beside its model graph: two
# pools a shape, GRAPH_SHAPES shapes at most.


@dataclasses.dataclass
class ShapeGraphs:
    """One shape's graphs. ``model``: each graph's ``runtime.CapturedGraph``
    by name ("synth" on the fixed-length path; "preamble", "chunk" with
    early exit, "postnet" on the split path; "model", "gl" on a mesh), empty
    until the shape's second call. ``inputs``: the static (text, lengths)
    the graphs read (on a mesh, this process's rows)."""

    model: dict = dataclasses.field(default_factory=dict)
    inputs: tuple = ()

    def captured(self):
        """-> [(name, CapturedGraph)] of every graph captured so far."""
        return list(self.model.items())


class Synthesizer:
    """``Synthesizer(cfg, params, batch_stats, vocab, fused=..., mesh=None,
    device=None)``.

    ``params``/``batch_stats`` are the port's state-dict entries
    (``weights.from_flax``), full on every process of a mesh.
    ``cfg.model.compute_dtype`` "bfloat16" runs the model's products in
    bf16, the attention keys included, on every decode path. ``device=None``
    means the mesh's device, else the GPU, and raises when there is none;
    pass ``device="cpu"`` for the plain PyTorch versions.

    On one CUDA device each shape (``shape_key``: the device, B, T_in,
    ``n_steps``, ``gl_iters``, as JAX's jit cache keys them) runs its first
    call eagerly on the Synthesizer's own stream: a real call, which fills
    every lazy cache (the kernels' libraries and residency tables, cuBLAS's
    and cuDNN's workspaces, the DSP constants). The second call captures
    the shape's graphs (``runtime.capture_graph``: a private memory pool
    each, the Synthesizer's CUDA generator registered) and replays them;
    later calls copy their prompts into the graphs' static inputs and
    replay; the split path's Griffin-Lim runs eagerly after its model
    graphs, at the length their end frames give. Each call reseeds the
    generator with ``seed``, so a replay draws the dropout masks (and K3's
    seed) an eager call with that seed draws. With deterministic algorithms
    (``torch.use_deterministic_algorithms``) a replay is bit-equal to the
    eager call. A ``mesh`` whose collectives can be captured (NCCL, or no
    process group) runs its model and Griffin-Lim graphs per shape the same
    way, then gathers eagerly. The eager path runs on the CPU, under
    ``stage_ms=True`` (the eager reference the graphs are held against) and
    on a mesh over gloo; the returned ``"graphed"`` says whether the call
    replayed the shape's graphs. A failed capture raises.

    Each call is one record of the stage clock (``utils.profiling``) when
    it is on: device ms of ``RECORD_STAGES`` and ``chunk_gap_ms``, host
    spans, and the counters ``chunks`` (early-exit chunks run),
    ``decode_kernel_chunks`` (those run by the step decode's kernel), ``t_gl``
    (Griffin-Lim's frames), ``d2h_bytes`` (bytes read to the host) and
    ``graphed``; with Tacotron 2 also ``decode_steps`` (the steps the loop
    ran before its exit) and ``gate_rows`` (rows whose gate opened before
    the cap), read in the copy of the end frames. Each graph holds its
    stage marks as event nodes (none in the chunk graph, whose replays are
    marked from the host).

    Graphs point at the model's tensors: a ``load_state_dict`` into
    ``self.model`` copies in place and keeps them; when the tensors'
    addresses change, every graph is dropped. ``graphs`` maps each shape
    seen to its ``ShapeGraphs``, at most ``GRAPH_SHAPES`` of them: a new
    shape past them drops the least recently used one's graphs.
    """

    def __init__(self, cfg: Config, params, batch_stats, vocab: Vocab,
                 fused: bool = False, mesh=None, device=None):
        icfg = cfg.infer
        self.gate = cfg.tacotron2 is not None
        if self.gate and (fused or mesh is not None):
            raise ValueError("Tacotron 2 runs the early-exit decode on one device: "
                             "drop fused=True and the mesh")
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
        # Tacotron 2 always decodes until its gate (``WhileDecode``)
        self.exit_loop = icfg.early_exit or self.gate
        self.split = self.exit_loop or icfg.trim_before_gl
        self.device = resolve_device(device)
        self.model = (Tacotron2(cfg.model, cfg.tacotron2, cfg.audio, device=self.device)
                      if self.gate else Tacotron(cfg.model, device=self.device))
        self.model.load_state_dict({**params, **batch_stats}, strict=True)
        self.model.eval()
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self._gen = torch.Generator(device=self.device)
        self._stream = None
        self._bound = None            # addresses of the tensors the graphs read

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

    def shape_key(self, device, b: int, t_in: int, n_steps: int, gl_iters: int) -> tuple:
        """What the graphs of one shape are valid for, as JAX's jit cache
        keys its jits (``cfg`` is fixed per Synthesizer)."""
        return (torch.device(device), int(b), int(t_in), int(n_steps), int(gl_iters))

    @torch.no_grad()
    def __call__(self, texts: list[str], n_steps: int | None = None,
                 gl_iters: int | None = None, seed: int = 0,
                 peak_normalize: bool = True, stage_ms: bool = False):
        """Synthesize a batch. Returns a dict with mel, linear, alignments,
        wavs (B, T_samples), end_frames (first detected-silence frame),
        wav_lengths (samples), audio_seconds (padded total),
        trimmed_audio_seconds, as numpy, and ``graphed``; with ``stage_ms``
        (an eager call) also the device milliseconds of each of ``STAGES``
        (``decode`` with the gaps between its chunks)."""
        cfg = self.cfg
        n_steps = cfg.model.max_decode_steps if n_steps is None else n_steps
        gl_iters = cfg.audio.griffin_lim_iters if gl_iters is None else gl_iters
        with profiling.clock("synthesize", self.device, RECORD_STAGES, force=stage_ms) as clock:
            if (self.device.type == "cuda" and not stage_ms
                    and (self.mesh is None or self.mesh.capturable)):
                res, graphed = self._on_stream(texts, seed, n_steps, gl_iters)
            else:
                with profiling.span("inputs"):
                    text, lengths = self.encode_texts(texts)
                self._gen.manual_seed(seed)
                with profiling.span("eager"):
                    res = self._eager(text, lengths, n_steps, gl_iters)
                graphed = False
            mel, linear, align, ends, wav, wav_norm = res
            with profiling.span("to_host"):
                wav = _to_host(wav_norm if peak_normalize else wav)
                ends = _to_host(ends) if isinstance(ends, torch.Tensor) else ends
                mel, linear, align = _to_host(mel), _to_host(linear), _to_host(align)
                profiling.mark("to_host")
            if clock is not None:
                clock.counters["graphed"] = graphed
                if not self.split:          # Griffin-Lim ran over every frame
                    clock.counters["t_gl"] = linear.shape[1]
        wav_lengths = np.minimum(ends * cfg.audio.hop_length, wav.shape[1])
        out = {
            "mel": mel,
            "linear": linear,
            "alignments": align,
            "wavs": wav,
            "end_frames": ends,
            "wav_lengths": wav_lengths,
            "audio_seconds": wav.shape[0] * wav.shape[1] / cfg.audio.sample_rate,
            "trimmed_audio_seconds": float(wav_lengths.sum()) / cfg.audio.sample_rate,
            "graphed": graphed,
        }
        if stage_ms:
            rec = clock.record()
            out["stage_ms"] = {k: rec["stage_ms"][k] for k in STAGES}
            out["stage_ms"]["decode"] += rec.get("chunk_gap_ms", 0.0)
        return out

    # ------------------------------------------------- the passes, eager or captured

    def _encode(self, text, lengths, gen):
        """The encoder, keys and mask; marks the start of a call's device work."""
        m = self.model
        profiling.mark(None)
        memory = m.encoder(text, lengths, gen)
        return memory, m.memory_proj(memory), length_mask(text.shape[1], lengths)

    def _model_pass(self, text, lengths, gen, n_steps):
        """Encoder and the fixed-length decode -> (mel, alignments)."""
        m, mcfg = self.model, self.cfg.model
        memory, keys, mask = self._encode(text, lengths, gen)
        profiling.mark("encoder")
        if self.fused:
            # drawn on the device, as JAX draws it inside its jit; K3 reads it there
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=self.device)
            frames, align = decode_loop(
                memory, keys, mask, pack_decoder_weights(m.decoder.cell),
                n_steps=n_steps, seed=seed, dropout=mcfg.prenet_dropout > 0,
                dropout_rate=mcfg.prenet_dropout, generator=gen)
            mel = frames.reshape(text.shape[0], n_steps * mcfg.r, mcfg.n_mels)
        else:
            mel, align = m.decoder(memory, keys, mask, n_steps, gen)
        profiling.mark("decode")
        return mel, align

    def _while_decode(self, text, lengths, gen, n_steps) -> WhileDecode:
        """Encoder, keys, mask, packed weights and the zeroed carry of the
        early-exit decode (JAX's ``decode_while``)."""
        mcfg, icfg = self.cfg.model, self.cfg.infer
        memory, keys, mask = self._encode(text, lengths, gen)
        dec = self.model.decoder
        loop = WhileDecode(
            memory, keys, mask, dec.step_weights() if self.gate else pack_decoder_weights(dec.cell),
            gen, n_steps=n_steps, r=mcfg.r, n_mels=mcfg.n_mels, dropout_rate=mcfg.prenet_dropout,
            silence_threshold=icfg.silence_threshold,
            # the stop unit is a decoder step = r frames
            min_silence_steps=max(1, -(-icfg.min_silence_frames // mcfg.r)))
        profiling.mark("encoder")
        return loop

    def _decode_chunks(self, run_chunk, loop: WhileDecode) -> None:
        """The early-exit loop (``run_until_done``), each chunk between two
        host marks when the clock is on: the time before a chunk is
        ``chunk_gap`` (the previous exit-flag read), the chunk ``decode``.
        Counts ``chunks``, and ``decode_kernel_chunks``: those the step
        decode's kernel ran (all on the card, none on the CPU)."""
        def marked():
            profiling.mark("chunk_gap")
            done = run_chunk()
            profiling.mark("decode")
            return done

        with profiling.span("chunk_loop"):
            n = run_until_done(marked if profiling.recording() else run_chunk, loop.n_steps,
                               loop.chunk)
            profiling.count("chunks", n)
            profiling.count("decode_kernel_chunks", n if loop.kernel else 0)

    def _exit_post(self, loop: WhileDecode):
        """The early-exit decode's outputs through the post-net -> (mel,
        alignments, linear, end frames); the time since the last chunk is
        ``chunk_gap``."""
        profiling.mark("chunk_gap")
        mel, align = loop.outputs()
        return (mel, align, *self._post(mel, loop.gate_ends()))

    def _post(self, mel, ends=None):
        """-> (linear, end frames on the device: ``ends`` when given (the
        gate's, ``WhileDecode.gate_ends``), else (B,) from silence)."""
        icfg = self.cfg.infer
        out = self.model.postnet(mel), ends if ends is not None else end_frames_device(
            mel, threshold=icfg.silence_threshold, min_run=icfg.min_silence_frames)
        profiling.mark("postnet")
        return out

    def _ends_to_host(self, ends) -> np.ndarray:
        """The (B,) end frames read to the host: the split path's one read
        before Griffin-Lim. With the gate the same copy brings the loop's
        steps and the rows whose gate opened (counted as ``decode_steps``
        and ``gate_rows``)."""
        ends = _to_host(ends)
        profiling.mark("to_host")
        if self.gate:
            profiling.count("decode_steps", int(ends[-2]))
            profiling.count("gate_rows", int(ends[-1]))
            ends = ends[:-2]
        return ends

    def _gl(self, linear, gl_iters):
        """Griffin-Lim, the final iSTFT and inverse pre-emphasis -> (wav,
        wav peak-normalised)."""
        acfg = self.cfg.audio
        re, im = gl_spectrum(spectrogram_magnitude(linear, acfg), acfg, gl_iters)
        profiling.mark("griffin_lim")
        wav = spectrum_to_wav(re, im, acfg)
        out = wav, _normalized(wav)
        profiling.mark("istft_inv_preemphasis")
        return out

    def _t_gl(self, ends: np.ndarray, frames: int) -> int:
        """The split path's Griffin-Lim length (counted as ``t_gl``): with
        ``trim_before_gl`` the batch's largest end frame rounded up to the
        quantum, else every frame."""
        icfg = self.cfg.infer
        t_gl = frames
        if icfg.trim_before_gl:
            q = icfg.gl_length_quantum
            t_gl = min(int(-(-max(int(ends.max()), q) // q) * q), frames)
        profiling.count("t_gl", t_gl)
        return t_gl

    def _eager(self, text, lengths, n_steps, gl_iters):
        """One call, eagerly -> (mel, linear, alignments, ends, wav, wav
        peak-normalised)."""
        gen = self._gen
        if self.mesh is not None:
            text, lengths, n_real = self._mesh_rows(text, lengths)
            mel, align, linear = self._mesh_model(text, lengths, gen, n_steps)
            return self._mesh_gather(n_real, mel, align, linear, self._gl(linear, gl_iters)[0])
        if self.exit_loop:
            loop = self._while_decode(text, lengths, gen, n_steps)
            self._decode_chunks(loop.run_chunk, loop)
            mel, align, linear, ends = self._exit_post(loop)
        else:
            mel, align = self._model_pass(text, lengths, gen, n_steps)
            linear, ends = self._post(mel)
        t_gl = linear.shape[1]
        if self.split:
            ends = self._ends_to_host(ends)
            t_gl = self._t_gl(ends, t_gl)
        return (mel, linear, align, ends, *self._gl(linear[:, :t_gl], gl_iters))

    def _mesh_rows(self, text, lengths):
        """The batch padded to a multiple of the data size with length-1 rows
        (a real mask; the rows are cut off after the gather) -> (this
        process's rows of text and lengths, the real row count)."""
        mesh = self.mesh
        n_real, nd = text.shape[0], mesh.data_size
        pad = -n_real % nd
        text = torch.cat([text, text.new_zeros(pad, text.shape[1])])
        lengths = torch.cat([lengths, lengths.new_ones(pad)])
        per = text.shape[0] // nd
        lo = mesh.data_index * per
        return text[lo:lo + per], lengths[lo:lo + per], n_real

    def _mesh_model(self, text, lengths, gen, n_steps):
        """The model pass on this process's rows, with the dropout masks of
        the global batch -> (mel, alignments, linear)."""
        mel, align = self._model_pass(text, lengths, self.mesh.batch_shard(gen), n_steps)
        linear = self.model.postnet(mel)
        profiling.mark("postnet")
        return mel, align, linear

    def _mesh_gather(self, n_real, mel, align, linear, wav):
        """Every process's rows gathered, the pad rows cut off, the end
        frames -> (mel, linear, alignments, ends, wav, wav peak-normalised)."""
        group = self.mesh.data_group
        if group is not None:
            mel, linear, align, wav = (all_gather_cat(x, group) for x in (mel, linear, align, wav))
        mel, linear, align, wav = (x[:n_real] for x in (mel, linear, align, wav))
        icfg = self.cfg.infer
        ends = end_frames_device(mel, threshold=icfg.silence_threshold,
                                 min_run=icfg.min_silence_frames)
        return mel, linear, align, ends, wav, _normalized(wav)

    # ------------------------------------------------------------------ graphs

    def _tensors(self) -> tuple:
        m = self.model
        return tuple(t.data_ptr() for t in (*m.parameters(), *m.buffers()))

    def _drop_if_moved(self) -> None:
        """Drop every graph when the model's tensors are not those the
        graphs were captured on."""
        if self._tensors() != self._bound:
            self.graphs.clear()
            self._bound = self._tensors()

    def _entry(self, key) -> ShapeGraphs | None:
        """``key``'s graphs, now the most recently used; None for a shape not
        seen yet, which gets an empty entry (the least recently used one
        goes when ``GRAPH_SHAPES`` are kept)."""
        if key in self.graphs:
            self.graphs.move_to_end(key)
            return self.graphs[key]
        if len(self.graphs) >= GRAPH_SHAPES:
            self.graphs.popitem(last=False)
        self.graphs[key] = ShapeGraphs()
        return None

    def _on_stream(self, texts, seed, n_steps, gl_iters):
        """One call on the Synthesizer's stream: eager for a shape's first
        call, else through its graphs -> (outputs, every stage replayed)."""
        dev = self.device
        self._drop_if_moved()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            with profiling.span("inputs"):
                text, lengths = self.encode_texts(texts)
            key = self.shape_key(dev, *text.shape, n_steps, gl_iters)
            self._gen.manual_seed(seed)
            entry = self._entry(key)
            if entry is None:
                with profiling.span("eager"):
                    res = self._eager(text, lengths, n_steps, gl_iters)
                graphed = False
            else:
                if self.mesh is not None:
                    text, lengths, n_real = self._mesh_rows(text, lengths)
                if not entry.model:
                    with profiling.span("capture"):
                        self._capture(entry, text, lengths, n_steps, gl_iters)
                with profiling.span("inputs"):
                    for dst, src in zip(entry.inputs, (text, lengths)):
                        dst.copy_(src)
                res, graphed = self._replay(entry, n_steps, gl_iters)
                if self.mesh is not None:
                    res = self._mesh_gather(n_real, *res)
        cur.wait_stream(self._stream)
        return res, graphed

    def _capture(self, entry: ShapeGraphs, text, lengths, n_steps, gl_iters):
        """Capture a shape's model graphs into ``entry``, all of them or
        (when a capture raises) none."""
        inputs = (torch.empty_like(text), torch.empty_like(lengths))
        gen, stream, graphs = self._gen, self._stream, {}

        def capture(name, fn):
            graphs[name] = runtime.capture_graph(fn, stream, gen)
            return graphs[name].outputs

        def started(fn):
            """``fn`` after a mark that starts its graph's first stage."""
            def run():
                profiling.mark(None)
                return fn()
            return run

        if self.mesh is not None:
            _, _, linear = capture("model", lambda: self._mesh_model(*inputs, gen, n_steps))
            capture("gl", started(lambda: self._gl(linear, gl_iters)[0]))
        elif not self.split:
            def synth():
                mel, align = self._model_pass(*inputs, gen, n_steps)
                linear, ends = self._post(mel)
                return (mel, linear, align, ends, *self._gl(linear, gl_iters))

            capture("synth", synth)
        elif self.exit_loop:
            loop = capture("preamble", lambda: self._while_decode(*inputs, gen, n_steps))
            capture("chunk", loop.run_chunk)
            capture("postnet", lambda: self._exit_post(loop))
        else:
            mel, align = capture("preamble", lambda: self._model_pass(*inputs, gen, n_steps))
            capture("postnet", started(lambda: (mel, align, *self._post(mel))))
        entry.inputs, entry.model = inputs, graphs

    def _replay(self, entry: ShapeGraphs, n_steps, gl_iters):
        """-> (the outputs, True); on a mesh (mel, alignments, linear, wav)
        of this process's rows, which ``_mesh_gather`` completes."""
        g = entry.model
        if self.mesh is not None:
            for name in ("model", "gl"):
                with profiling.span(name):
                    runtime.replay_graph(g[name])
            return (*g["model"].outputs, g["gl"].outputs), True
        if not self.split:
            with profiling.span("synth"):
                runtime.replay_graph(g["synth"])
            return g["synth"].outputs, True
        with profiling.span("preamble"):
            runtime.replay_graph(g["preamble"])
        if "chunk" in g:
            chunk = g["chunk"]

            def run_chunk():
                runtime.replay_graph(chunk)
                return chunk.outputs

            self._decode_chunks(run_chunk, g["preamble"].outputs)
        with profiling.span("postnet"):
            runtime.replay_graph(g["postnet"])
            mel, align, linear, ends = g["postnet"].outputs
            ends = self._ends_to_host(ends)
        t_gl = self._t_gl(ends, linear.shape[1])
        with profiling.span("griffin_lim"):
            wav = self._gl(linear[:, :t_gl], gl_iters)
        return (mel, linear, align, ends, *wav), True


def _to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` read to the host; its bytes count as ``d2h_bytes``."""
    profiling.count("d2h_bytes", x.element_size() * x.numel())
    return x.cpu().numpy()


def _normalized(wav):
    """Each waveform over its peak (at least 1e-3)."""
    return wav / torch.clamp(wav.abs().amax(dim=-1, keepdim=True), min=1e-3)
