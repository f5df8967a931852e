"""CBHG: Conv Bank + Highway + bidirectional GRU (paper §3.1, Table 1).

Port of the JAX package's ``ops/cbhg.py``: conv bank(1..K) -> max-pool
(width 2, stride 1, SAME) -> width-3 conv projections -> residual add with
the input -> highway stack -> biGRU. Products run in ``compute_dtype``; the
pool sees the f32 batch-norm output, and the residual add widens a bf16
input to the projections' f32, as JAX's ``h + residual.astype(h.dtype)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tacotron_tpu_torch.ops.gru import bidirectional_gru
from tacotron_tpu_torch.ops.modules import ConvBank, Conv1dProjection, HighwayStack


def max_pool_same2(h):
    """Width-2, stride-1 SAME max-pool over time of (B, T, C): SAME pads
    the right end with -inf, so y[t] = max(h[t], h[t+1]) and y[T-1] =
    h[T-1]. ``nn.MaxPool1d`` has no SAME mode. On a tie the gradient goes
    to h[t], the window's first element, as XLA's select-and-scatter sends
    it (``torch.maximum`` would split it; bf16 activations tie often)."""
    nxt = F.pad(h[:, 1:], (0, 0, 0, 1), value=float("-inf"))
    return torch.where(h >= nxt, h, nxt)


class CBHG(nn.Module):
    def __init__(self, in_dim: int, k: int, bank_channels: int,
                 proj_dims: Sequence[int], highway_layers: int,
                 highway_dim: int, gru_dim: int, *, device=None,
                 dtype=torch.float32, compute_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.bank = ConvBank(k, in_dim, bank_channels, **kw)
        self.proj = Conv1dProjection(k * bank_channels, tuple(proj_dims), **kw)
        self.highway = HighwayStack(proj_dims[-1], highway_layers, highway_dim, **kw)
        self.bigru = bidirectional_gru(highway_dim, gru_dim, **kw)

    def forward(self, x, lengths=None):
        """x (B, T, C_in) -> (B, T, 2*gru_dim); proj_dims[-1] must equal C_in."""
        h = max_pool_same2(self.bank(x))
        h = self.proj(h) + x
        return self.bigru(self.highway(h), lengths=lengths)
