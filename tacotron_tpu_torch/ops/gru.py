"""GRU cell and sequence scans with TF1 GRUCell semantics.

Port of the JAX package's ``ops/gru.py``. The gate form is TF1's, which is
NOT ``torch.nn.GRU``'s (cuDNN applies the reset gate after the recurrent
product):

    r, u = sigmoid(W_g [x, h] + b_g)        # b_g initialised to 1.0
    c    = tanh(W_c [x, r * h] + b_c)
    h'   = u * h + (1 - u) * c

The state stays f32. ``_ScanGRU`` hoists the input half of both products
out of the time loop (one (B*T, D) product), so only the recurrent half runs
step by step.

With a bf16 ``compute_dtype`` the hoisted input products are bf16 (flax
``Dense``), while the recurrent products are accumulated and returned in
f32 (``preferred_element_type=f32`` in JAX): ``modules.widened`` operands.
Their weights are rounded to bf16 once, before the time loop, and widened
each step from that bf16 copy, so autograd sums the copy's per-step
gradients in bf16, as JAX's scan does for a bf16 constant.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tacotron_tpu_torch.ops.modules import Dense, dense, widened


class GRUCell(nn.Module):
    """One step: (h, x) -> h'. Fused [x, h] weight layout, as in JAX."""

    def __init__(self, in_features: int, features: int, *, device=None,
                 dtype=torch.float32, compute_dtype=None):
        super().__init__()
        d = features
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.gates = Dense(in_features + d, 2 * d, **kw)
        self.candidate = Dense(in_features + d, d, **kw)

    def forward(self, h, x):
        return gru_cell_step(h, x, self.gates.weight, self.gates.bias,
                             self.candidate.weight, self.candidate.bias,
                             self.gates.compute_dtype)


def gru_cell_step(h, x, wg, bg, wc, bc, compute_dtype=None):
    """``GRUCell`` on explicit weights (the hoisted decoder passes copies
    already in ``compute_dtype``): both products as flax ``Dense``, the
    gates and the state in f32."""
    h = h.float()
    ru = torch.sigmoid(dense(torch.cat([x, h], dim=-1), wg, bg, compute_dtype).float())
    r, u = ru.chunk(2, dim=-1)
    c = torch.tanh(dense(torch.cat([x, r * h], dim=-1), wc, bc, compute_dtype).float())
    return u * h + (1.0 - u) * c


def _reverse_index(t: int, lengths, device):
    """(B, T) index that reverses each row's valid prefix and leaves the
    padding tail in place (TF ``bidirectional_dynamic_rnn`` semantics)."""
    idx = torch.arange(t, device=device)[None, :]
    lens = lengths.to(device)[:, None]
    return torch.where(idx < lens, lens - 1 - idx, idx)


def _take_time(x, rev):
    return torch.gather(x, 1, rev[..., None].expand(-1, -1, x.shape[-1]))


class _ScanGRU(nn.Module):
    """Scan a GRU over time with the input projection hoisted.

    Parameters: ``gates_x`` (2d, D_in) + bias, ``cand_x`` (d, D_in) + bias,
    ``gates_h`` (2d, d) and ``cand_h`` (d, d) without bias.
    """

    def __init__(self, in_features: int, features: int, reverse: bool = False,
                 *, device=None, dtype=torch.float32, compute_dtype=None):
        super().__init__()
        d = features
        self.features = d
        self.reverse = reverse
        self.compute_dtype = compute_dtype
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.gates_x = Dense(in_features, 2 * d, **kw)
        self.cand_x = Dense(in_features, d, **kw)
        self.gates_h = Dense(d, 2 * d, bias=False, **kw)
        self.cand_h = Dense(d, d, bias=False, **kw)

    def forward(self, xs, h0=None, lengths=None):
        """xs (B, T, D_in) -> (ys (B, T, d), h_last (B, d))."""
        b, t, _ = xs.shape
        gx = self.gates_x(xs)          # (B, T, 2d): hoisted
        cx = self.cand_x(xs)           # (B, T, d)
        rev = None
        if self.reverse and lengths is not None:
            rev = _reverse_index(t, lengths, xs.device)
            gx, cx = _take_time(gx, rev), _take_time(cx, rev)
        elif self.reverse:
            gx, cx = gx.flip(1), cx.flip(1)

        h = (torch.zeros(b, self.features, device=xs.device) if h0 is None
             else h0.float())
        cd = self.compute_dtype
        wg, wc = (w if cd is None else w.to(cd)
                  for w in (self.gates_h.weight, self.cand_h.weight))
        ys = []
        for i in range(t):
            ru = torch.sigmoid(gx[:, i] + F.linear(widened(h, cd), widened(wg, cd)))
            r, u = ru.chunk(2, dim=-1)
            c = torch.tanh(cx[:, i] + F.linear(widened(r * h, cd), widened(wc, cd)))
            h = u * h + (1.0 - u) * c
            ys.append(h)
        ys = torch.stack(ys, dim=1)
        if rev is not None:
            ys = _take_time(ys, rev)
        elif self.reverse:
            ys = ys.flip(1)
        return ys, h


class unidirectional_gru(nn.Module):
    def __init__(self, in_features: int, features: int, *, device=None,
                 dtype=torch.float32, compute_dtype=None):
        super().__init__()
        self.fwd = _ScanGRU(in_features, features, device=device, dtype=dtype,
                            compute_dtype=compute_dtype)

    def forward(self, xs, h0=None):
        return self.fwd(xs, h0)


class bidirectional_gru(nn.Module):
    """Concat of forward and backward GRU outputs: (B, T, 2*features). The
    backward direction reverses only each row's valid prefix when
    ``lengths`` is given.

    Both directions run in ONE time loop, as in the JAX stacked form: the
    backward stream's projected inputs are time-reversed and the two
    recurrent products are one batched product per step, which halves the
    sequential chain. Parameters are the two ``_ScanGRU`` trees."""

    def __init__(self, in_features: int, features: int, *, device=None,
                 dtype=torch.float32, compute_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype
        self.fwd = _ScanGRU(in_features, features, **kw)
        self.bwd = _ScanGRU(in_features, features, reverse=True, **kw)

    def forward(self, xs, lengths=None):
        b, t, _ = xs.shape
        d = self.fwd.features
        cd = self.compute_dtype
        rev = (_reverse_index(t, lengths, xs.device) if lengths is not None
               else None)
        xs_r = _take_time(xs, rev) if rev is not None else xs.flip(1)
        gx = torch.stack([self.fwd.gates_x(xs), self.bwd.gates_x(xs_r)])  # (2, B, T, 2d)
        cx = torch.stack([self.fwd.cand_x(xs), self.bwd.cand_x(xs_r)])
        wg = torch.stack([self.fwd.gates_h.weight, self.bwd.gates_h.weight]).transpose(1, 2)
        wc = torch.stack([self.fwd.cand_h.weight, self.bwd.cand_h.weight]).transpose(1, 2)
        if cd is not None:
            wg, wc = wg.to(cd), wc.to(cd)
        h = torch.zeros(2, b, d, device=xs.device)
        ys = []
        for i in range(t):
            ru = torch.sigmoid(gx[:, :, i] + torch.bmm(widened(h, cd), widened(wg, cd)))
            r, u = ru.chunk(2, dim=-1)
            c = torch.tanh(cx[:, :, i] + torch.bmm(widened(r * h, cd), widened(wc, cd)))
            h = u * h + (1.0 - u) * c
            ys.append(h)
        ys = torch.stack(ys, dim=2)                      # (2, B, T, d)
        out_b = _take_time(ys[1], rev) if rev is not None else ys[1].flip(1)
        return torch.cat([ys[0], out_b], dim=-1)
