"""Reusable Tacotron building blocks: dense, conv, prenet, batch norm, conv
bank, conv projections, highway.

Port of the JAX package's ``ops/modules.py``. Activations keep the JAX
layout (B, T, C); convolutions transpose to PyTorch's (B, C, T) inside.
Parameters are created empty (``torch.empty``) with an explicit device and
dtype: weights come from ``weights.from_flax`` or ``weights.init_params``,
so constructing a module draws no random numbers.

``compute_dtype`` is flax's ``dtype=``: None (the default) computes in the
parameters' f32 and inserts no cast; ``torch.bfloat16`` rounds each
product's inputs to bf16 and returns the product in bf16, as flax does.
Parameters, batch-norm statistics and everything between the products stay
f32: the callers widen with ``.float()`` where the JAX code does
``.astype(f32)`` (a no-op on an f32 tensor).

On a mesh (``parallel/``) the batch is split over the ranks of a data
group. A ``BatchShard`` generator makes dropout draw the global batch's
masks and keep this rank's rows; the global batch statistics and the
tensor-parallel layers are the variants in ``parallel/layers.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def dense(x, weight, bias=None, compute_dtype=None):
    """flax ``Dense(dtype=compute_dtype)`` on a (out, in) weight. In bf16 the
    product of the rounded inputs is rounded to bf16 and the rounded bias is
    added in bf16, a second rounding, as in JAX (``F.linear`` with its bias
    would round once). A weight already in ``compute_dtype`` is not copied."""
    if compute_dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(compute_dtype), weight.to(compute_dtype))
    return y if bias is None else y + bias.to(compute_dtype)


def widened(x, compute_dtype):
    """``x`` rounded to ``compute_dtype`` and widened back to f32, the
    operand of a product that JAX accumulates and returns in f32
    (``preferred_element_type=f32``): products of bf16 values are exact in
    f32, so the product is the f32 sum of the exact ones. Identity when
    ``compute_dtype`` is None."""
    return x if compute_dtype is None else x.to(compute_dtype).float()


class Dense(nn.Module):
    """y = x W^T + b with W (out, in): flax ``Dense`` with its kernel
    transposed to PyTorch's Linear layout."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device=None, dtype=torch.float32, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device,
                                              dtype=dtype)) if bias else None)

    def forward(self, x):
        return dense(x, self.weight, self.bias, self.compute_dtype)


class Conv1d(nn.Module):
    """Bias-free stride-1 SAME conv over (B, T, C_in) -> (B, T, C_out).
    Weight (C_out, C_in, W); SAME pads (W-1)//2 on the left, like flax."""

    def __init__(self, in_ch: int, out_ch: int, width: int, *, device=None,
                 dtype=torch.float32, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, width,
                                               device=device, dtype=dtype))

    def forward(self, x):
        return conv1d_same(x, self.weight, self.compute_dtype)


def conv1d_same(x, weight, compute_dtype=None):
    """(B, T, C_in) x (C_out, C_in, W) -> (B, T, C_out), flax SAME padding;
    in ``compute_dtype`` (inputs rounded, output in it) when given."""
    if compute_dtype is not None:
        x, weight = x.to(compute_dtype), weight.to(compute_dtype)
    w = weight.shape[-1]
    left = (w - 1) // 2
    xt = F.pad(x.transpose(1, 2), (left, w - 1 - left))
    return F.conv1d(xt, weight).transpose(1, 2)


class BatchShard(NamedTuple):
    """A dropout generator that every rank of a data group shares, and this
    rank's place in the global batch: ``index`` of ``count`` equal shards of
    its leading axis. Dropout then draws the global batch's masks and keeps
    this rank's rows, so the masks do not depend on the split."""

    generator: torch.Generator
    index: int
    count: int


def dropout_uniform(shape, generator, device):
    """The uniform draw (f32, contiguous) that ``dropout_keep`` compares with
    1 - rate, for an input of ``shape``, from a ``torch.Generator`` (or None)
    or a ``BatchShard``."""
    if isinstance(generator, BatchShard):
        n = shape[0]
        return torch.rand((n * generator.count, *shape[1:]), generator=generator.generator,
                          device=device)[n * generator.index:n * (generator.index + 1)]
    return torch.rand(shape, generator=generator, device=device)


def dropout_keep(shape, rate: float, generator, device):
    """The keep mask (bool) that ``dropout`` draws for an input of
    ``shape``, from a ``torch.Generator`` (or None) or a ``BatchShard``.
    Inside a CUDA graph the generator must be registered with the graph
    (``CUDAGraph.register_generator_state``, as ``train.step`` does): each
    replay then draws the masks an eager call would and advances it alike.
    A ``BatchShard`` draws the global batch's rows in the graph as in the
    eager step, so a replayed mesh step advances the generator by what one
    process's step on the global batch does."""
    return dropout_uniform(shape, generator, device) < 1.0 - rate


def dropout(x, rate: float, generator: torch.Generator | None, keep=None):
    """Inverted dropout: keep with probability 1 - rate, scaled by
    1/(1 - rate); rate 0 is a no-op. The mask is ``keep`` when given, else
    drawn from ``generator``."""
    if rate <= 0.0:
        return x
    scale = 1.0 / (1.0 - rate) if rate < 1.0 else 0.0
    if keep is None:
        keep = dropout_keep(x.shape, rate, generator, x.device)
    return torch.where(keep, x * scale, torch.zeros_like(x))


class Prenet(nn.Module):
    """FC-ReLU-dropout stack; dropout is active at train AND inference
    (paper §3.2), unless ``deterministic``."""

    def __init__(self, in_dim: int, dims: Sequence[int] = (256, 128),
                 dropout: float = 0.5, deterministic: bool = False, *,
                 device=None, dtype=torch.float32, compute_dtype=None):
        super().__init__()
        self.rate = dropout
        self.deterministic = deterministic
        self.n = len(dims)
        d_in = in_dim
        for i, d in enumerate(dims):
            self.add_module(f"fc{i}", Dense(d_in, d, device=device, dtype=dtype,
                                            compute_dtype=compute_dtype))
            d_in = d

    @property
    def active_rate(self) -> float:
        return 0.0 if self.deterministic else self.rate

    def draw_keep(self, lead_shape, generator: torch.Generator | None, device):
        """The keep masks of one call on inputs of leading shape
        ``lead_shape``, drawn as ``forward`` draws them (None when dropout is
        off); a step recomputed under checkpointing takes them as input."""
        rate = self.active_rate
        if rate <= 0.0:
            return None
        return tuple(dropout_keep((*lead_shape, getattr(self, f"fc{i}").weight.shape[0]),
                                  rate, generator, device) for i in range(self.n))

    def forward(self, x, generator: torch.Generator | None = None, keep=None):
        rate = self.active_rate
        for i in range(self.n):
            x = dropout(torch.relu(getattr(self, f"fc{i}")(x)), rate, generator,
                        None if keep is None else keep[i])
        return x


class BatchNorm(nn.Module):
    """Batch norm over the channel axis of (B, T, C), as flax's with epsilon
    1e-3 and momentum 0.99. In training (``module.training``) it normalises
    by the batch's statistics over (B, T), padded frames included (there is
    no mask, as in JAX), with flax's biased variance E[x^2] - E[x]^2
    (clipped at 0), and updates the running statistics as
    ``ra = 0.99 ra + 0.01 stat``; in evaluation it uses the running ones.
    ``F.batch_norm`` differs in both: its running variance is the unbiased
    estimate and its momentum weighs the other way."""

    eps = 1e-3
    momentum = 0.99

    def __init__(self, features: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(features, device=device, dtype=dtype))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device, dtype=dtype))
        self.register_buffer("running_var",
                             torch.ones(features, device=device, dtype=dtype))

    def forward(self, x):
        if self.training:
            xf = x.float()
            axes = tuple(range(x.ndim - 1))
            mean, msq = self.moments(xf, axes)
            var = torch.clamp_min(msq - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # flax order: (x - mean) * (scale * rsqrt(var + eps)) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias

    def moments(self, xf, axes):
        """The batch's E[x] and E[x^2] over ``axes``."""
        return xf.mean(axes), (xf * xf).mean(axes)


def conv_bank_group_bounds(k: int, groups: int) -> list[tuple[int, int]]:
    """Contiguous width-range partition of the packed conv bank: group
    (lo, hi] is built as one width-hi conv with (hi-lo)*channels outputs.
    The JAX package's bank splits this way; ``ConvBank`` here always packs
    one group, so the function serves the roofline accounting
    (``utils/roofline.py``) only."""
    g = max(1, min(groups, k))
    bounds = [round(i * k / g) for i in range(g + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


class ConvBank(nn.Module):
    """K parallel SAME convs of widths 1..K, each ``channels`` wide, then a
    per-width batch norm and ReLU, concatenated on the channel axis.

    Parameters keep the JAX layout ``conv{w}`` / ``bn{w}``. The forward pass
    packs all K kernels into one width-K conv: each width's taps sit at the
    offset its own SAME padding implies, the rest are zeros."""

    def __init__(self, k: int, in_ch: int, channels: int, *, device=None,
                 dtype=torch.float32, compute_dtype=None):
        super().__init__()
        self.k, self.channels = k, channels
        self.compute_dtype = compute_dtype
        for w in range(1, k + 1):
            self.add_module(f"conv{w}", Conv1d(in_ch, channels, w,
                                               device=device, dtype=dtype))
            self.add_module(f"bn{w}", BatchNorm(channels, device=device,
                                                dtype=dtype))

    def packed_weight(self):
        k, ch = self.k, self.channels
        first = self.conv1.weight
        big = first.new_zeros(k * ch, first.shape[1], k)
        left_k = (k - 1) // 2
        for w in range(1, k + 1):
            off = left_k - (w - 1) // 2
            big[(w - 1) * ch:w * ch, :, off:off + w] = getattr(self, f"conv{w}").weight
        return big

    def forward(self, x):
        y = conv1d_same(x, self.packed_weight(), self.compute_dtype)
        ch = self.channels
        return torch.cat([torch.relu(getattr(self, f"bn{w}")(y[..., (w - 1) * ch:w * ch].float()))
                          for w in range(1, self.k + 1)], dim=-1)


class Conv1dProjection(nn.Module):
    """Width-3 conv projections after the bank: the first ReLU, the second
    linear, each batch-normed."""

    def __init__(self, in_ch: int, dims: Sequence[int],
                 activations: Sequence[str | None] = ("relu", None), *,
                 device=None, dtype=torch.float32, compute_dtype=None):
        super().__init__()
        self.activations = tuple(activations)
        self.n = len(dims)
        c = in_ch
        for i, d in enumerate(dims):
            self.add_module(f"proj{i}", Conv1d(c, d, 3, device=device, dtype=dtype,
                                               compute_dtype=compute_dtype))
            self.add_module(f"bn{i}", BatchNorm(d, device=device, dtype=dtype))
            c = d

    def forward(self, x):
        for i, act in zip(range(self.n), self.activations):
            x = getattr(self, f"bn{i}")(getattr(self, f"proj{i}")(x).float())
            if act == "relu":
                x = torch.relu(x)
        return x


class HighwayStack(nn.Module):
    """N highway layers, H(x)*T(x) + x*(1-T(x)); a Dense resize precedes the
    stack when the input width differs from ``dim``."""

    def __init__(self, in_dim: int, layers: int = 4, dim: int = 128, *,
                 device=None, dtype=torch.float32, compute_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.layers = layers
        self.resize = Dense(in_dim, dim, **kw) if in_dim != dim else None
        for i in range(layers):
            self.add_module(f"H{i}", Dense(dim, dim, **kw))
            self.add_module(f"T{i}", Dense(dim, dim, **kw))

    def forward(self, x):
        if self.resize is not None:
            x = self.resize(x)
        for i in range(self.layers):
            h = torch.relu(getattr(self, f"H{i}")(x).float())
            t = torch.sigmoid(getattr(self, f"T{i}")(x).float())
            x = x.float()
            x = h * t + x * (1.0 - t)
        return x
