"""Attention decoder, feed-previous (inference) mode: r mel frames per step.

Port of the JAX package's ``models/decoder.py`` (``DecoderCell`` and the
feed-previous ``Decoder`` loop; teacher forcing belongs to the training
slice). Per step: prenet(previous r-th frame) feeds the attention GRU,
whose state queries Bahdanau attention; [attention-GRU output, context] is
projected to ``decoder_gru_dim`` and passed through residual GRUs; a final
Dense emits r*n_mels. No stop token: inference runs a fixed number of steps
(paper §3.2). The attention keys are computed once outside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from tacotron_tpu_torch.config import ModelConfig
from tacotron_tpu_torch.ops.attention import BahdanauAttention
from tacotron_tpu_torch.ops.gru import GRUCell
from tacotron_tpu_torch.ops.modules import Dense, Prenet


class DecoderState(NamedTuple):
    h_att: torch.Tensor              # attention GRU state (B, attention_gru_dim)
    h_dec: tuple                     # decoder GRU states, each (B, decoder_gru_dim)
    context: torch.Tensor            # previous attention context (B, memory_dim)
    prev_frame: torch.Tensor         # last emitted mel frame (B, n_mels)


class DecoderCell(nn.Module):
    """One feed-previous decode step."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        p1 = cfg.prenet_dims[-1]
        self.prenet = Prenet(cfg.n_mels, cfg.prenet_dims, cfg.prenet_dropout, **kw)
        self.attention_gru = GRUCell(p1 + cfg.memory_dim, cfg.attention_gru_dim, **kw)
        self.attention = BahdanauAttention(cfg.attention_gru_dim, cfg.attention_dim, **kw)
        self.decoder_input_proj = Dense(cfg.attention_gru_dim + cfg.memory_dim,
                                        cfg.decoder_gru_dim, **kw)
        for i in range(cfg.decoder_depth):
            self.add_module(f"decoder_gru{i}",
                            GRUCell(cfg.decoder_gru_dim, cfg.decoder_gru_dim, **kw))
        self.frame_proj = Dense(cfg.decoder_gru_dim, cfg.r * cfg.n_mels, **kw)

    def forward(self, state: DecoderState, keys, memory, mask,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        x = self.prenet(state.prev_frame, generator)
        h_att = self.attention_gru(state.h_att, torch.cat([x, state.context], dim=-1))
        context, alignment = self.attention(h_att, keys, memory, mask)
        h = self.decoder_input_proj(torch.cat([h_att, context], dim=-1))
        new_h_dec = []
        for i, h_prev in enumerate(state.h_dec):
            h_i = getattr(self, f"decoder_gru{i}")(h_prev, h)
            h = h + h_i                                  # residual connection
            new_h_dec.append(h_i)
        frames = self.frame_proj(h)                      # (B, r*n_mels)
        last = frames[:, (cfg.r - 1) * cfg.n_mels:]
        return DecoderState(h_att, tuple(new_h_dec), context, last), (frames, alignment)


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.cell = DecoderCell(cfg, device=device, dtype=dtype)

    def forward(self, memory, keys, mask, n_steps: int,
                generator: torch.Generator | None = None):
        """Autoregressive decode -> (mel (B, n_steps*r, n_mels),
        alignments (B, n_steps, T_in))."""
        cfg = self.cfg
        b, dev = memory.shape[0], memory.device
        state = DecoderState(
            torch.zeros(b, cfg.attention_gru_dim, device=dev),
            tuple(torch.zeros(b, cfg.decoder_gru_dim, device=dev)
                  for _ in range(cfg.decoder_depth)),
            torch.zeros(b, cfg.memory_dim, device=dev),
            torch.zeros(b, cfg.n_mels, device=dev),
        )
        frames, aligns = [], []
        for _ in range(n_steps):
            state, (f, a) = self.cell(state, keys, memory, mask, generator)
            frames.append(f)
            aligns.append(a)
        mel = torch.stack(frames, 1).reshape(b, n_steps * cfg.r, cfg.n_mels)
        return mel, torch.stack(aligns, 1)
