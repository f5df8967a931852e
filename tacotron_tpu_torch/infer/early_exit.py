"""Early-exit decode and per-utterance end frames from silence (Tacotron
has no stop token).

Port of the JAX package's ``infer/early_exit.py``: ``decode_while``, a
feed-previous decode that stops once every utterance of the batch has been
silent long enough, and ``end_frames`` / ``end_frames_device``, the
per-utterance end-frame detector used for wav trimming and for the slice
before Griffin-Lim.

The loop's step, ``while_decoder_step``, is JAX ``decode_while``'s own body
over the packed decoder weights. Like JAX's, it takes the attention's two
reductions in the forms of the step-by-step cell (``models/decoder.py``),
not those of the fused decode's kernel: the scores as a product of the tanh
with ``v``, the context as an ``einsum`` over the memory. The two decodes
then run the same operations, and the early exit with a threshold that
never trips gives the fixed decode's output bit for bit.

On a CUDA device a chunk of the loop is one launch of the step decode's
kernel (``ops/decode_chunk.py``) after the chunk's dropout draws, and the
launch applies the exit rule too; ``WhileDecode.run_chunk_plain`` is its
plain counterpart. The fixed decode on the device runs the same kernel, so
the two decodes stay bit-equal there.

Given Tacotron 2's step weights (``models/tacotron2.py`` ``StepWeights``),
``while_decoder_step`` makes Tacotron 2's step and ``WhileDecode`` exits by
its stop gate instead of silence; on a CUDA device its chunk is the draws
and one launch of Tacotron 2's own step decode kernel
(``ops/t2_decode_chunk.py``), which applies the gate's rule too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tacotron_tpu_torch.models import tacotron2
from tacotron_tpu_torch.ops.attn_energy import energy_contract, energy_tanh
from tacotron_tpu_torch.ops.decode_chunk import (DecodeChunk, ExitCarry, decode_inputs,
                                                 draw_masks, zero_state)
from tacotron_tpu_torch.ops.decode_loop import DecoderWeights
from tacotron_tpu_torch.ops.gru import gru_cell_step
from tacotron_tpu_torch.ops.modules import dense, dropout
from tacotron_tpu_torch.ops.t2_decode_chunk import GateCarry, T2DecodeChunk


def end_frames(mel: np.ndarray, threshold: float = 0.05,
               min_run: int = 12) -> np.ndarray:
    """Per-utterance end frame from a normalized mel (B, T, n_mels): the
    first frame t such that frames [t, t + min_run) ALL have peak value <
    threshold, or T if no such run exists."""
    mel = np.asarray(mel)
    b, t, _ = mel.shape
    silent = mel.max(axis=-1) < threshold
    if t < min_run:
        return np.full((b,), t, np.int64)
    c = np.concatenate([np.zeros((b, 1), np.int64),
                        np.cumsum(silent, axis=1)], axis=1)
    run_all = (c[:, min_run:] - c[:, :-min_run]) == min_run
    idx = np.argmax(run_all, axis=1)
    return np.where(run_all.any(axis=1), idx, t)


def end_frames_device(mel: torch.Tensor, threshold: float = 0.05,
                      min_run: int = 12) -> torch.Tensor:
    """``end_frames`` on the tensor's device, so only the (B,) result has to
    reach the host."""
    b, t, _ = mel.shape
    if t < min_run:
        return torch.full((b,), t, dtype=torch.int64, device=mel.device)
    silent = (mel.amax(dim=-1) < threshold).long()
    c = torch.nn.functional.pad(torch.cumsum(silent, dim=1), (1, 0))
    run_all = (c[:, min_run:] - c[:, :-min_run]) == min_run
    idx = torch.argmax(run_all.int(), dim=1)
    return torch.where(run_all.any(dim=1), idx, torch.full_like(idx, t))


def while_decoder_step(memory, keys, mask, w: DecoderWeights | tacotron2.StepWeights, *,
                       dropout_rate: float,
                       generator: torch.Generator | None):
    """(initial state, ``step``) of JAX ``decode_while``'s loop body, in f32.
    ``state, frames, alpha = step(state)`` runs one feed-previous step; the
    state is (h_att, h0, h1, context, previous frame).

    Every operation is the step-by-step cell's (``DecoderCell`` with the
    ``"xla"`` energy) on the same parameter tensors: ``dense`` and
    ``gru_cell_step`` for the prenet, the GRUs and the projections, the
    scores ``energy_contract(energy_tanh(keys, q), v)``, the context
    ``einsum("bt,btd->bd", alpha, memory)``. The mask is added as 0 /
    ``NEG_INF``, as JAX adds it; the cell's ``where`` gives the same
    alignment. Dropout draws the prenet's two masks per step from
    ``generator``, as the cell does.

    As in JAX, the step uses the ``"xla"`` energy whatever the model's
    ``attention_energy``: under ``"fused"`` the fixed decode runs K1 on a
    CUDA tensor and the two decodes part by K1's summation order. It is f32
    whatever the compute dtype (JAX's loop runs over the packed f32
    parameters): bf16 keys are widened, as ``keys + q`` promotes them in JAX,
    so under bf16 compute it follows JAX's ``decode_while``, not the bf16
    cell. Nothing in the step reads the host or sizes an allocation from
    data, so it can be captured in a CUDA graph.

    Given Tacotron 2's ``StepWeights`` it is ``tacotron2.decoder_step``:
    the state is then Tacotron 2's, its last entry the step's gate logit.
    """
    if isinstance(w, tacotron2.StepWeights):
        return tacotron2.decoder_step(memory, keys, mask, w, dropout_rate=dropout_rate,
                                      generator=generator)
    b, t_in, m_dim = memory.shape
    n_mels = w.p_w0.shape[1]
    r = w.f_w.shape[0] // n_mels
    mem, keys, bias = decode_inputs(memory, keys, mask)
    v = w.at_v.reshape(-1, 1)

    def step(state):
        h_att, h0, h1, ctx, prev = state
        x = dropout(torch.relu(dense(prev, w.p_w0, w.p_b0)), dropout_rate, generator)
        x = dropout(torch.relu(dense(x, w.p_w1, w.p_b1)), dropout_rate, generator)
        h_att = gru_cell_step(h_att, torch.cat([x, ctx], -1), w.ag_wg, w.ag_bg, w.ag_wc, w.ag_bc)
        q = dense(h_att, w.at_wq)
        alpha = torch.softmax(energy_contract(energy_tanh(keys, q), v) + bias, dim=-1)
        ctx = torch.einsum("bt,btd->bd", alpha, mem)
        h = dense(torch.cat([h_att, ctx], -1), w.ip_w, w.ip_b)
        h0 = gru_cell_step(h0, h, w.d0_wg, w.d0_bg, w.d0_wc, w.d0_bc)
        h = h + h0
        h1 = gru_cell_step(h1, h, w.d1_wg, w.d1_bg, w.d1_wc, w.d1_bc)
        h = h + h1
        frames = dense(h, w.f_w, w.f_b)
        return (h_att, h0, h1, ctx, frames[:, (r - 1) * n_mels:]), frames, alpha

    return zero_state(b, m_dim, w, memory.device), step


# decoder steps per chunk: the host reads the exit flag once per chunk. Read
# when a WhileDecode is made. 8 decodes 500 steps as fast as 16 on an H100
# and wastes half as many steps past an exit (chip_smoke.py [fast-graph] (e))
DECODE_CHUNK = 8


class WhileDecode:
    """``decode_while``'s loop as a carry and a chunk of steps over it, the
    counterpart of JAX's ``lax.while_loop`` body and condition.

    The carry is tensors that ``run_chunk`` reads at its start and writes at
    its end: the decoder state (``state``: h_att, h0, h1, context, previous
    frame), ``silent_run`` (B,), the slot counter ``slot`` and the steps-done
    counter ``t``, and the frame and alignment buffers of ``n_steps +
    chunk`` slots. ``run_chunk`` runs ``chunk`` (``DECODE_CHUNK``) steps.
    Each step is active while JAX's condition holds (``t < n_steps`` and not every row's
    ``silent_run >= min_silence_steps``); it writes ``where(active, frames,
    0)`` and the same of the alignment into slot ``slot`` (a device index),
    advances ``silent_run`` only when active, adds ``active`` to ``t`` and
    one to ``slot``. Steps past the exit change no output: frames and
    alignments past it are zero, and ``t`` is the exit step. ``run_chunk``
    returns the device flag "done" and reads nothing on the host, so the
    chunk can be captured into a CUDA graph and replayed
    (``infer.synthesize.Synthesizer``); the carry then lives at fixed
    addresses, and making the ``WhileDecode`` zeroes it.

    On a CUDA device (``kernel``) ``run_chunk`` draws the chunk's dropout
    masks (``draw_masks``) and launches the step decode's kernel once: it
    runs the chunk's steps, writes each step's raw frames and alignments
    into its slot, and applies the rule above to the steps in order,
    zeroing the inactive steps' slots and writing ``t``, ``silent_run``,
    ``slot`` and the flag ``done``. ``run_chunk_plain`` is that launch in
    plain PyTorch, in the kernel's order, its steps drawing the masks that
    ``draw_masks`` draws: what ``run_chunk`` runs on the CPU, and the
    kernel's reference on the card.

    Tacotron 2 (``gate``: its ``StepWeights``) ends each row by its stop
    gate: a row is active from the start until the step, included, whose
    gate logit is over logit(``w.gate_threshold``); its slots after that are
    zero, and ``lengths`` (B,) counts its active steps. A step is active
    for the loop while ``t < n_steps`` and some row is, and ``t`` counts
    those steps; the loop is done when ``t`` reaches ``n_steps`` or every
    row has ended (``ended`` (B,) bool). On a CUDA device ``run_chunk``
    draws the chunk's masks and launches Tacotron 2's kernel
    (``ops/t2_decode_chunk.py``), which applies this rule too; a shape
    outside its limits raises its ``ValueError`` here, as the Tacotron 1
    kernel's does. ``run_chunk_plain`` runs on the CPU.
    """

    def __init__(self, memory, keys, mask, w: DecoderWeights | tacotron2.StepWeights,
                 generator=None, *, n_steps: int, r: int, n_mels: int, dropout_rate: float = 0.0,
                 silence_threshold: float = 0.05, min_silence_steps: int = 3):
        b, t_in, _ = memory.shape
        if w.f_w.shape[0] != r * n_mels:
            raise ValueError(f"frame projection width {w.f_w.shape[0]} != r * n_mels "
                             f"({r} * {n_mels})")
        chunk = DECODE_CHUNK
        self.n_steps, self.r, self.n_mels, self.chunk = n_steps, r, n_mels, chunk
        self.threshold, self.min_steps = silence_threshold, min_silence_steps
        self.state, self._step = while_decoder_step(
            memory, keys, mask, w, dropout_rate=dropout_rate, generator=generator)
        dev = memory.device
        self.silent_run = torch.zeros(b, dtype=torch.int64, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.frames = memory.new_zeros(b, n_steps + chunk, r * n_mels)
        self.aligns = memory.new_zeros(b, n_steps + chunk, t_in)
        self._w, self._gen, self.rate = w, generator, dropout_rate
        self.gate = isinstance(w, tacotron2.StepWeights)
        if self.gate:
            self.logit = math.log(w.gate_threshold / (1.0 - w.gate_threshold))
            self.ended = torch.zeros(b, dtype=torch.bool, device=dev)
            self.lengths = torch.zeros(b, dtype=torch.int64, device=dev)
        self.kernel = dev.type == "cuda"
        if self.kernel:
            self.done = torch.zeros((), dtype=torch.bool, device=dev)
            inputs = decode_inputs(memory, keys, mask)
            if self.gate:
                self._launch = T2DecodeChunk(
                    *inputs, w, self.state, self.frames, self.aligns, GateCarry(
                        self.t, self.ended, self.lengths, self.slot, self.done, self.logit,
                        n_steps), dropout_rate=dropout_rate)
            else:
                self._launch = DecodeChunk(
                    *inputs, w, self.state, self.frames, self.aligns, dropout_rate=dropout_rate,
                    exit=ExitCarry(self.t, self.silent_run, self.slot, self.done,
                                   threshold=silence_threshold, min_steps=min_silence_steps,
                                   n_steps=n_steps))

    def _done(self, t, run):
        """``run``: the silent runs, or with the gate the rows' ``ended``."""
        return (t >= self.n_steps) | (run.all() if self.gate else (run >= self.min_steps).all())

    def draw_masks(self) -> list:
        """The chunk's dropout draws, as its steps draw them one by one: per
        step the pre-net's (B, P0) then (B, P1) uniform draw (none at rate 0)."""
        return draw_masks(self.frames.shape[0], self._w, self.chunk, self.rate, self._gen,
                          self.frames.device)

    def run_chunk(self) -> torch.Tensor:
        """``chunk`` steps from the carry, written back to it -> the device
        flag (0-d bool): the loop has exited or run ``n_steps``."""
        if self.kernel:
            self._launch.launch(self.draw_masks(), self.chunk)
            return self.done
        return self.run_chunk_plain()

    def run_chunk_plain(self) -> torch.Tensor:
        """The kernel's launch in plain PyTorch: the chunk's steps, each
        drawing its pre-net masks as ``draw_masks`` draws them, every step's
        raw frames and alignments into its slot, then the exit rule over the
        chunk's steps in order (the inactive ones' slots zeroed), the carry
        written back -> the flag "done"."""
        state, slot0 = self.state, self.slot
        silent = []
        for k in range(self.chunk):
            state, frames, align = self._step(state)
            self.frames.index_copy_(1, slot0 + k, frames[:, None])
            self.aligns.index_copy_(1, slot0 + k, align[:, None])
            silent.append(state[-1] > self.logit if self.gate
                          else frames.amax(dim=-1) < self.threshold)
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        if self.gate:
            return self._gate_rule(slot0, silent)
        t, run = self.t, self.silent_run
        for k in range(self.chunk):
            active = ~self._done(t, run)
            for buf in (self.frames, self.aligns):
                buf.index_copy_(1, slot0 + k, torch.where(active, buf.index_select(1, slot0 + k),
                                                          0.0))
            run = torch.where(active, torch.where(silent[k], run + 1, 0), run)
            t = t + active
        self.t.copy_(t)
        self.slot.copy_(slot0 + self.chunk)
        self.silent_run.copy_(run)
        return self._done(t, run)

    def _gate_rule(self, slot0, opened) -> torch.Tensor:
        """The stop gate's exit rule over the chunk's steps in order;
        ``opened[k]``: the rows whose gate opened at step k."""
        t, ended, lengths = self.t, self.ended, self.lengths
        for k in range(self.chunk):
            live = ~self._done(t, ended)
            active = live & ~ended
            for buf in (self.frames, self.aligns):
                buf.index_copy_(1, slot0 + k, torch.where(
                    active[:, None, None], buf.index_select(1, slot0 + k), 0.0))
            lengths = lengths + active
            ended = ended | (active & opened[k])
            t = t + live
        self.t.copy_(t)
        self.slot.copy_(slot0 + self.chunk)
        self.ended.copy_(ended)
        self.lengths.copy_(lengths)
        return self._done(t, ended)

    def gate_ends(self) -> torch.Tensor | None:
        """With the gate, (B + 2,) int64 on the device: each row's end frame
        (its active steps times r), then ``t`` and the rows whose gate
        opened, so one copy takes all three to the host; else None."""
        if not self.gate:
            return None
        return torch.cat([self.lengths * self.r, self.t[None], self.ended.sum()[None]])

    def outputs(self):
        """-> (mel (B, n_steps*r, n_mels), alignments (B, n_steps, T_in)) of
        the steps run so far."""
        b, n = self.frames.shape[0], self.n_steps
        return (self.frames[:, :n].reshape(b, n * self.r, self.n_mels),
                self.aligns[:, :n].contiguous())


def decode_while(memory, keys, mask, w: DecoderWeights, generator=None, *,
                 n_steps: int, r: int, n_mels: int, dropout_rate: float = 0.0,
                 silence_threshold: float = 0.05, min_silence_steps: int = 3):
    """Feed-previous decode with silence early exit, in f32 over the packed
    decoder weights (``while_decoder_step``: JAX ``decode_while``'s body,
    the step-by-step cell's operations).

    memory (B, T_in, D_mem), keys (B, T_in, attn_dim), mask (B, T_in) bool;
    bf16 keys (bf16 compute) are widened, as JAX's f32 loop promotes them.
    Returns (mel (B, n_steps*r, n_mels), alignments (B, n_steps, T_in),
    steps_done). The loop stops after the step at which every row's
    ``silent_run`` (consecutive steps whose r frames all peak below
    ``silence_threshold``) has reached ``min_silence_steps``; frames and
    alignments past the exit step are zero. ``silence_threshold < 0``
    never exits and gives the fixed-length decode (``Decoder``'s output
    bit for bit, with the ``"xla"`` energy in f32). Prenet dropout draws
    from ``generator``.

    The loop runs on the device in chunks of ``DECODE_CHUNK`` steps
    (``WhileDecode``), and the host reads the exit flag once per chunk.
    A chunk's steps past the exit draw their dropout masks (the generator
    ends further on than at the exit) and change no output.
    """
    loop = WhileDecode(memory, keys, mask, w, generator, n_steps=n_steps, r=r, n_mels=n_mels,
                       dropout_rate=dropout_rate, silence_threshold=silence_threshold,
                       min_silence_steps=min_silence_steps)
    run_until_done(loop.run_chunk, n_steps, loop.chunk)
    mel, align = loop.outputs()
    return mel, align, int(loop.t)


def run_until_done(run_chunk, n_steps: int, chunk: int) -> int:
    """Call ``run_chunk()`` (``chunk`` steps -> the device's done flag)
    until the flag is set, at most ceil(n_steps / chunk) times: one host
    read per chunk. -> the number of chunks run."""
    n = -(-n_steps // chunk)
    for i in range(n):
        if bool(run_chunk()):
            return i + 1
    return n
