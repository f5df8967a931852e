"""LSTM cell step with test-time zoneout, and a bidirectional LSTM over
padded rows (Tacotron 2; the JAX package has no LSTM).

The cell is ``torch.nn.LSTMCell``'s: gates in the order i, f, g, o, two
biases, on explicit weights (``weight_ih`` (4H, D_in), ``weight_hh`` (4H,
H), ``bias_ih``, ``bias_hh``), the parameter names of ``torch.nn.LSTMCell``
and of NVIDIA's Tacotron 2 checkpoints:

    i, f, g, o = W_ih x + b_ih + W_hh h + b_hh
    c' = sigmoid(f) c + sigmoid(i) tanh(g)
    h' = sigmoid(o) tanh(c')

``torch.lstm_cell`` computes it (on a CUDA tensor: two products and one
fused kernel for the rest). Zoneout in its test-time form keeps a fixed
share of the previous state: ``h_t = z h_{t-1} + (1 - z) h'_t``, and the same
for ``c`` (Krueger et al. 2016, as Tacotron 2's paper regularises its
decoder LSTMs).
"""

from __future__ import annotations

import torch
from torch import nn

from tacotron_tpu_torch.ops.gru import _reverse_index, _take_time


def lstm_cell_step(x, h, c, w_ih, w_hh, b_ih, b_hh, zoneout: float):
    """One step -> (h, c), with test-time zoneout ``zoneout`` on both:
    ``h + (1 - zoneout) (h' - h)``."""
    h_new, c_new = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
    return torch.lerp(h, h_new, 1.0 - zoneout), torch.lerp(c, c_new, 1.0 - zoneout)


class LSTMCell(nn.Module):
    """The parameters of one LSTM cell, named as ``torch.nn.LSTMCell``'s."""

    def __init__(self, in_features: int, features: int, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight_ih = nn.Parameter(torch.empty(4 * features, in_features, **kw))
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features, **kw))
        self.bias_ih = nn.Parameter(torch.empty(4 * features, **kw))
        self.bias_hh = nn.Parameter(torch.empty(4 * features, **kw))

    @property
    def features(self) -> int:
        return self.weight_hh.shape[1]

    def weights(self) -> tuple:
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class BidirectionalLSTM(nn.Module):
    """Forward and backward LSTMs over (B, T, D_in) -> (B, T, 2 features),
    concatenated. With ``lengths`` the backward direction starts at each
    row's last valid position (its valid prefix reversed, the padding tail
    left in place, as ``ops/gru.py`` does for the GRU), so a row's valid
    outputs are those of the row run alone; the forward direction runs on
    over the padding, whose outputs the attention masks.

    Both directions run in one time loop: the input products are taken for
    every step at once (one (B*T, D_in) product a direction, biases
    included), and each step is one batched product of the two recurrent
    states with their weights."""

    def __init__(self, in_features: int, features: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.fwd = LSTMCell(in_features, features, device=device, dtype=dtype)
        self.bwd = LSTMCell(in_features, features, device=device, dtype=dtype)

    def forward(self, xs, lengths=None):
        b, t, _ = xs.shape
        d = self.fwd.features
        rev = _reverse_index(t, lengths, xs.device) if lengths is not None else None
        xs_r = _take_time(xs, rev) if rev is not None else xs.flip(1)
        gx = torch.stack([torch.nn.functional.linear(x, c.weight_ih, c.bias_ih + c.bias_hh)
                          for x, c in ((xs, self.fwd), (xs_r, self.bwd))])     # (2, B, T, 4d)
        w_hh = torch.stack([self.fwd.weight_hh, self.bwd.weight_hh]).transpose(1, 2)
        h = xs.new_zeros(2, b, d)
        c = xs.new_zeros(2, b, d)
        ys = []
        for i in range(t):
            gi, gf, gg, go = (gx[:, :, i] + torch.bmm(h, w_hh)).chunk(4, dim=-1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            ys.append(h)
        ys = torch.stack(ys, dim=2)                                            # (2, B, T, d)
        out_b = _take_time(ys[1], rev) if rev is not None else ys[1].flip(1)
        return torch.cat([ys[0], out_b], dim=-1)
