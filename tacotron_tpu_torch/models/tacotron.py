"""Tacotron assembly: encoder + attention decoder + post-net.

Port of the JAX package's ``models/tacotron.py``. Shapes: text (B, T_in)
-> memory (B, T_in, 256) -> mel (B, T_out, 80) -> linear (B, T_out, 1025).
Training or evaluation is the module's mode (``model.train()`` /
``model.eval()``): it selects batch or running statistics in the batch
norms. ``cfg.compute_dtype`` sets the products' dtype throughout
(``ops/modules.py``); parameters and outputs stay f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from tacotron_tpu_torch.config import ModelConfig
from tacotron_tpu_torch.models.decoder import Decoder
from tacotron_tpu_torch.models.encoder import Encoder
from tacotron_tpu_torch.models.postnet import PostNet
from tacotron_tpu_torch.ops.modules import Dense


class TacotronOutput(NamedTuple):
    mel: torch.Tensor         # (B, T_out, n_mels)
    linear: torch.Tensor      # (B, T_out, n_freq)
    alignments: torch.Tensor  # (B, T_out/r, T_in)


def length_mask(t: int, lengths):
    """(B, T) bool, True where the position is inside the text."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


class Tacotron(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        # attention keys, hoisted out of the decode loop: one
        # (B, T_in, memory_dim) x (memory_dim, attention_dim) product
        self.memory_proj = Dense(cfg.memory_dim, cfg.attention_dim, bias=False,
                                 compute_dtype=cfg.cdtype, **kw)
        self.decoder = Decoder(cfg, **kw)
        self.postnet = PostNet(cfg, **kw)

    def forward(self, text_ids, text_lengths=None, n_steps: int | None = None,
                generator: torch.Generator | None = None,
                gt_mel=None) -> TacotronOutput:
        """Teacher-forced when ``gt_mel`` (B, T_out, n_mels) is given; else
        autoregressive decode of ``n_steps`` (default cfg.max_decode_steps)
        decoder steps. Dropout draws from ``generator``."""
        cfg = self.cfg
        mask = (length_mask(text_ids.shape[1], text_lengths)
                if text_lengths is not None else None)
        memory = self.encoder(text_ids, text_lengths, generator)
        keys = self.memory_proj(memory)
        if gt_mel is None and n_steps is None:
            n_steps = cfg.max_decode_steps
        mel, alignments = self.decoder(memory, keys, mask, n_steps, generator,
                                       gt_frames=gt_mel)
        return TacotronOutput(mel, self.postnet(mel), alignments)
