"""Post-processing net: mel -> CBHG(K=8) -> Dense(1025) linear spectrogram.

Port of the JAX package's ``models/postnet.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from tacotron_tpu_torch.config import ModelConfig
from tacotron_tpu_torch.ops.cbhg import CBHG
from tacotron_tpu_torch.ops.modules import Dense


class PostNet(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=cfg.cdtype)
        self.cbhg = CBHG(cfg.n_mels, cfg.postnet_bank_k, cfg.postnet_bank_channels,
                         cfg.postnet_proj_dims, cfg.highway_layers,
                         cfg.highway_dim, cfg.gru_dim, **kw)
        self.linear_proj = Dense(cfg.memory_dim, cfg.n_freq, **kw)

    def forward(self, mel, lengths=None):
        return self.linear_proj(self.cbhg(mel, lengths=lengths)).float()
