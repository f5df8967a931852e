"""Attention decoder: r mel frames per step, teacher-forced or feed-previous.

Port of the JAX package's ``models/decoder.py``. Per step: prenet(previous
r-th frame) feeds the attention GRU, whose state queries Bahdanau
attention; [attention-GRU output, context] is projected to
``decoder_gru_dim`` and passed through residual GRUs; a final Dense emits
r*n_mels. No stop token: inference runs a fixed number of steps (paper
§3.2). The attention keys are computed once outside the loop.

On a CUDA device the feed-previous decode in f32 with the ``"xla"`` energy
runs through the step decode's kernel (``ops/decode_chunk.py``), the one the
early-exit decode's chunks run (``Decoder._on_kernel`` says when).

Teacher forcing (training) feeds the last ground-truth frame of the
previous group instead of the last prediction, in one of two forms that
share the parameters (``ModelConfig.tf_decoder``):

* ``"scan"``: ``DecoderCell`` step by step, as in inference;
* ``"hoisted"``: ``hoisted_teacher_forced``, the same math with every
  state-independent product taken out of the loop.

``remat_decoder`` recomputes each step in the backward pass
(``torch.utils.checkpoint``) instead of keeping its activations. Dropout
masks are drawn outside the recomputed step, so the recomputation sees the
same masks without touching the generator.

``remat_policy`` (with ``remat_decoder``) is the JAX package's: ``"all"``
recomputes everything; ``"save_attn"`` keeps each step's (B, T_in,
attention_dim) Bahdanau tanh and recomputes the rest. As in JAX the tanh
exists as a tensor only on the hoisted form with the ``"xla"`` energy: the
``"scan"`` form ignores the policy (JAX's ``nn.remat`` cell takes none),
and the ``"fused"`` energy keeps its tanh inside K1/K2 (nothing is named,
so nothing is saved). There the step is split at the tanh: the attention
GRU and the query are one recomputed region, the tanh is taken between
the regions, so autograd keeps it as the tanh's saved output, and the rest
of the step is a second recomputed region that takes it as an input. This
keeps exactly the one tensor and recomputes no part of it: selective
checkpointing (``create_selective_checkpoint_contexts`` with a policy that
saves the 3-D ``tanh``) would keep the same tensor but still recompute
``keys + q`` and, in bf16, the tanh's f32 copy. Values equal ``"all"``'s.

With a bf16 ``compute_dtype`` the two forms keep JAX's two kinds of weight
cast: the step-by-step cell casts its f32 parameters in every step (flax
``Dense``), so their gradients sum in f32; the hoisted form casts them once,
before the loop, so autograd sums each bf16 copy's per-step gradients in
bf16, as JAX's scan does for its bf16 constants (``keys`` among them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tacotron_tpu_torch.config import ModelConfig
from tacotron_tpu_torch.ops.attention import NEG_INF, BahdanauAttention, energy_scores
from tacotron_tpu_torch.ops.attn_energy import energy_contract, energy_tanh
from tacotron_tpu_torch.ops.decode_chunk import decode_steps
from tacotron_tpu_torch.ops.decode_loop import pack_decoder_weights
from tacotron_tpu_torch.ops.gru import GRUCell, gru_cell_step
from tacotron_tpu_torch.ops.modules import Dense, Prenet, dense, dropout

TF_DECODER_FORMS = ("scan", "hoisted")


class DecoderState(NamedTuple):
    h_att: torch.Tensor              # attention GRU state (B, attention_gru_dim)
    h_dec: tuple                     # decoder GRU states, each (B, decoder_gru_dim)
    context: torch.Tensor            # previous attention context (B, memory_dim)
    prev_frame: torch.Tensor         # last emitted mel frame (B, n_mels)


def _remat(fn, *args):
    # the step draws no random numbers (its dropout masks are arguments),
    # so the global RNG state need not be saved for the recomputation
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class DecoderCell(nn.Module):
    """One decode step, shared by the feed-previous and teacher-forced
    modes."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=cfg.cdtype)
        self.cfg = cfg
        p1 = cfg.prenet_dims[-1]
        self.prenet = Prenet(cfg.n_mels, cfg.prenet_dims, cfg.prenet_dropout, **kw)
        self.attention_gru = GRUCell(p1 + cfg.memory_dim, cfg.attention_gru_dim, **kw)
        self.attention = BahdanauAttention(cfg.attention_gru_dim, cfg.attention_dim,
                                           energy=cfg.attention_energy, **kw)
        self.decoder_input_proj = Dense(cfg.attention_gru_dim + cfg.memory_dim,
                                        cfg.decoder_gru_dim, **kw)
        for i in range(cfg.decoder_depth):
            self.add_module(f"decoder_gru{i}",
                            GRUCell(cfg.decoder_gru_dim, cfg.decoder_gru_dim, **kw))
        self.frame_proj = Dense(cfg.decoder_gru_dim, cfg.r * cfg.n_mels, **kw)

    def forward(self, state: DecoderState, keys, memory, mask,
                generator: torch.Generator | None = None, frame_in=None, keep=None):
        """Feed-previous when ``frame_in`` is None (the input is the last
        emitted frame), teacher-forced otherwise. ``keep``: the prenet's
        dropout masks, drawn ahead (``Prenet.draw_keep``)."""
        cfg = self.cfg
        x = state.prev_frame if frame_in is None else frame_in
        x = self.prenet(x, generator, keep)
        h_att = self.attention_gru(state.h_att, torch.cat([x, state.context], dim=-1))
        context, alignment = self.attention(h_att, keys, memory, mask)
        h = self.decoder_input_proj(torch.cat([h_att, context], dim=-1)).float()
        new_h_dec = []
        for i, h_prev in enumerate(state.h_dec):
            h_i = getattr(self, f"decoder_gru{i}")(h_prev, h)
            h = h + h_i                                  # residual connection
            new_h_dec.append(h_i)
        frames = self.frame_proj(h).float()              # (B, r*n_mels)
        last = frames[:, (cfg.r - 1) * cfg.n_mels:]
        return DecoderState(h_att, tuple(new_h_dec), context, last), (frames, alignment)


def hoisted_teacher_forced(cell: DecoderCell, frames_in, keys, memory, mask,
                           generator: torch.Generator | None = None):
    """Teacher-forced decode on ``cell``'s parameters with every
    state-independent product hoisted out of the step loop (JAX
    ``_hoisted_teacher_forced``):

    * the prenet over all steps at once, one dropout draw of shape
      (B, S, d) per layer;
    * the prenet rows of the attention-GRU weights pre-multiplied over all
      steps; only the [context, h] rows stay in the loop;
    * the r-frame projection once on the stacked states after the loop;
    * in bf16, every weight the loop uses cast once, before it.

    frames_in: (B, S, n_mels) shifted last-of-group ground-truth frames.
    Returns (mel (B, S*r, n_mels), alignments (B, S, T_in)).
    """
    cfg = cell.cfg
    cd = cfg.cdtype
    b, s, _ = frames_in.shape
    p1 = cfg.prenet_dims[-1]
    pn = cell.prenet

    def cast(w):
        return w if cd is None else w.to(cd)

    x = frames_in
    for i in range(pn.n):
        x = dropout(torch.relu(getattr(pn, f"fc{i}")(x)), pn.active_rate, generator)
    pre = x                                             # (B, S, p1)

    # weights are (out, in): the [prenet | context | h] split is on axis 1
    ag = cell.attention_gru
    wg, wc = ag.gates.weight, ag.candidate.weight
    gx = dense(pre, wg[:, :p1], ag.gates.bias, cd).float()      # (B, S, 2d)
    cx = dense(pre, wc[:, :p1], ag.candidate.bias, cd).float()  # (B, S, d)
    wg_ch, wc_ch = cast(wg[:, p1:]), cast(wc[:, p1:])
    att = cell.attention
    wq = cast(att.query.weight)
    ip = cell.decoder_input_proj
    wp, bp = cast(ip.weight), cast(ip.bias)
    keys_c = cast(keys)
    mem_f = memory.float()
    grus = [tuple(cast(w) for w in (g.gates.weight, g.gates.bias,
                                    g.candidate.weight, g.candidate.bias))
            for g in (getattr(cell, f"decoder_gru{i}") for i in range(cfg.decoder_depth))]

    def gru_query(h_att, ctx, gx_t, cx_t):
        ch = torch.cat([ctx, h_att], dim=-1)
        ru = torch.sigmoid(gx_t + dense(ch, wg_ch, None, cd).float())
        r, u = ru.chunk(2, dim=-1)
        cand = torch.tanh(cx_t + dense(torch.cat([ctx, r * h_att], dim=-1), wc_ch,
                                       None, cd).float())
        h_att = u * h_att + (1.0 - u) * cand
        return h_att, dense(h_att, wq, None, cd)

    def after_scores(scores, h_att, h_dec):
        if mask is not None:
            scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        align = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bt,btd->bd", align, mem_f)
        h = dense(torch.cat([h_att, ctx], dim=-1), wp, bp, cd).float()
        new_hd = []
        for w, h_prev in zip(grus, h_dec):
            h_i = gru_cell_step(h_prev, h, *w, cd)
            h = h + h_i
            new_hd.append(h_i)
        return ctx, tuple(new_hd), h, align

    def step(h_att, ctx, h_dec, gx_t, cx_t):
        h_att, q = gru_query(h_att, ctx, gx_t, cx_t)
        scores = energy_scores(keys_c, q, att.v, att.energy)
        return (h_att, *after_scores(scores, h_att, h_dec))

    def after_tanh(e, h_att, h_dec):
        return after_scores(energy_contract(e, att.v), h_att, h_dec)

    def step_saving_tanh(h_att, ctx, h_dec, gx_t, cx_t):
        # two recomputed regions around the tanh, which autograd keeps
        h_att, q = _remat(gru_query, h_att, ctx, gx_t, cx_t)
        return (h_att, *_remat(after_tanh, energy_tanh(keys_c, q), h_att, h_dec))

    saves_tanh = (cfg.remat_decoder and cfg.remat_policy == "save_attn"
                  and att.energy == "xla")

    dev = memory.device
    h_att = torch.zeros(b, cfg.attention_gru_dim, device=dev)
    ctx = torch.zeros(b, cfg.memory_dim, device=dev)
    h_dec = tuple(torch.zeros(b, cfg.decoder_gru_dim, device=dev)
                  for _ in range(cfg.decoder_depth))
    hs, aligns = [], []
    for t in range(s):
        args = (h_att, ctx, h_dec, gx[:, t], cx[:, t])
        if saves_tanh:
            h_att, ctx, h_dec, h, a = step_saving_tanh(*args)
        else:
            h_att, ctx, h_dec, h, a = _remat(step, *args) if cfg.remat_decoder else step(*args)
        hs.append(h)
        aligns.append(a)
    frames = cell.frame_proj(torch.stack(hs, 1)).float()  # (B, S, r*n_mels)
    return frames.reshape(b, s * cfg.r, cfg.n_mels), torch.stack(aligns, 1)


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.tf_decoder not in TF_DECODER_FORMS:
            raise ValueError(f"tf_decoder must be one of {TF_DECODER_FORMS}, "
                             f"got {cfg.tf_decoder!r}")
        self.cfg = cfg
        self.cell = DecoderCell(cfg, device=device, dtype=dtype)

    def _init_state(self, b: int, dev) -> DecoderState:
        cfg = self.cfg
        return DecoderState(
            torch.zeros(b, cfg.attention_gru_dim, device=dev),
            tuple(torch.zeros(b, cfg.decoder_gru_dim, device=dev)
                  for _ in range(cfg.decoder_depth)),
            torch.zeros(b, cfg.memory_dim, device=dev),
            torch.zeros(b, cfg.n_mels, device=dev),
        )

    def _on_kernel(self, memory, keys) -> bool:
        """The feed-previous decode runs through the step decode's kernel
        (``ops/decode_chunk.py``): on a CUDA device, in f32 with the
        ``"xla"`` energy, two decoder GRUs, and no gradient to keep. The
        early-exit decode's chunks run the same kernel, so the two decodes
        stay bit-equal on the card."""
        cfg = self.cfg
        return (memory.device.type == "cuda" and cfg.cdtype is None
                and cfg.attention_energy == "xla" and cfg.decoder_depth == 2
                and all(p.dtype == torch.float32 for p in self.parameters())
                and not (torch.is_grad_enabled()
                         and any(t.requires_grad for t in (memory, keys, *self.parameters()))))

    def forward(self, memory, keys, mask, n_steps: int | None = None,
                generator: torch.Generator | None = None, gt_frames=None):
        """Teacher-forced when ``gt_frames`` (B, T_out, n_mels) is given
        (T_out a multiple of r; the input at step t is the last ground-truth
        frame of group t-1, a zero frame at t=0), else autoregressive for
        ``n_steps``. Returns (mel (B, n_steps*r, n_mels), alignments
        (B, n_steps, T_in))."""
        if gt_frames is not None:
            return self._teacher_forced(memory, keys, mask, gt_frames, generator)
        cfg = self.cfg
        b = memory.shape[0]
        if self._on_kernel(memory, keys):
            frames, aligns = decode_steps(
                memory, keys, mask, pack_decoder_weights(self.cell), generator,
                n_steps=n_steps, dropout_rate=self.cell.prenet.active_rate)
            return frames.reshape(b, n_steps * cfg.r, cfg.n_mels), aligns
        state = self._init_state(b, memory.device)
        frames, aligns = [], []
        for _ in range(n_steps):
            state, (f, a) = self.cell(state, keys, memory, mask, generator)
            frames.append(f)
            aligns.append(a)
        mel = torch.stack(frames, 1).reshape(b, n_steps * cfg.r, cfg.n_mels)
        return mel, torch.stack(aligns, 1)

    def _teacher_forced(self, memory, keys, mask, gt_frames, generator):
        cfg = self.cfg
        b, t_out = gt_frames.shape[:2]
        if t_out % cfg.r:
            raise ValueError(f"T_out ({t_out}) must be padded to a multiple of r ({cfg.r})")
        n_steps = t_out // cfg.r
        last = gt_frames[:, cfg.r - 1::cfg.r]            # (B, n_steps, n_mels)
        shifted = torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], dim=1)
        if cfg.tf_decoder == "hoisted":
            return hoisted_teacher_forced(self.cell, shifted, keys, memory, mask, generator)
        state = self._init_state(b, memory.device)
        frames, aligns = [], []
        for t in range(n_steps):
            keep = self.cell.prenet.draw_keep((b,), generator, memory.device)
            args = (state, keys, memory, mask, None, shifted[:, t], keep)
            state, (f, a) = (_remat(self.cell, *args) if cfg.remat_decoder
                             else self.cell(*args))
            frames.append(f)
            aligns.append(a)
        mel = torch.stack(frames, 1).reshape(b, n_steps * cfg.r, cfg.n_mels)
        return mel, torch.stack(aligns, 1)
