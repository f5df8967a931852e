"""Tacotron encoder: char embedding -> pre-net -> CBHG(K=16) -> memory.

Port of the JAX package's ``models/encoder.py``. Output memory is
(B, T_in, 2*gru_dim) = (B, T_in, 256) at full size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tacotron_tpu_torch.config import ModelConfig
from tacotron_tpu_torch.ops.cbhg import CBHG
from tacotron_tpu_torch.ops.modules import Prenet


class Embed(nn.Module):
    """Character embedding; the table keeps flax's name ``embedding``."""

    def __init__(self, num: int, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim, device=device,
                                                  dtype=dtype))

    def forward(self, ids):
        return F.embedding(ids, self.embedding)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = Embed(cfg.vocab_size, cfg.embed_dim, **kw)    # stays f32
        kw["compute_dtype"] = cfg.cdtype
        # paper: prenet dropout is always on
        self.prenet = Prenet(cfg.embed_dim, cfg.prenet_dims, cfg.prenet_dropout, **kw)
        self.cbhg = CBHG(cfg.prenet_dims[-1], cfg.encoder_bank_k,
                         cfg.encoder_bank_channels, cfg.encoder_proj_dims,
                         cfg.highway_layers, cfg.highway_dim, cfg.gru_dim, **kw)

    def forward(self, text_ids, text_lengths=None,
                generator: torch.Generator | None = None):
        x = self.prenet(self.embed(text_ids), generator)
        return self.cbhg(x, lengths=text_lengths)   # (B, T_in, 2*gru_dim)
