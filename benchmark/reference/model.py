"""Plain PyTorch Tacotron: the benchmark's reference for the served and the
trained model (arXiv 1703.10135, Table 1 and sections 3.1-3.3).

Written from the paper's equations, in float32, over a flat dict of
weights keyed by state-dict names (``param_spec`` lists them). It imports
nothing of the program under test and takes nothing the program made: the
benchmark draws the weights, the inputs and the dropout masks and hands the
same to both sides.

* Encoder: character embedding, pre-net (FC-ReLU-dropout 256, 128), CBHG-16
  (a bank of SAME convolutions of widths 1..16, each batch-normed and
  ReLU'd; width-2 stride-1 max-pool; width-3 projections, the first ReLU'd;
  a residual add; a highway stack; a bidirectional GRU whose backward
  direction reverses each row's text only).
* Attention decoder, one step: pre-net on the previous step's last frame,
  attention GRU on [pre-net, previous context], Bahdanau energies
  ``v . tanh(keys + W_q h)`` masked to the text, softmax, context, an input
  projection, two residual GRUs, r frames out.
* Post-net: CBHG-8 over the mel frames and a Dense to 1025 bins.
* GRUs are TF1's ``GRUCell``: ``r, u = sigmoid(W_g [x, h] + b_g)``,
  ``c = tanh(W_c [x, r h] + b_c)``, ``h' = u h + (1 - u) c``.
* Batch norm: epsilon 1e-3; in training the batch's biased statistics over
  (batch, time), in serving the running ones.
* Dropout is inverted dropout at rate 0.5 on both pre-nets, in training and
  in serving (paper section 3.2), with masks given as inputs.

``Precision`` rounds both operands of every product (dense, convolution,
energy contraction, context, DFT) before an f32 product: ``"f32"`` rounds
nothing; ``"tf32"`` keeps 10 bits of mantissa, as a TF32 tensor core does;
``"fp8"`` scales each operand to float8 e4m3's range and rounds to it. The
two lower ones are the benchmark's controls; the reference proper is f32.
The decoder steps can take a precision of their own (a fused decode that
stores its operands in bf16 is controlled a step below that).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

NEG_INF = -1e9
BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def _tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & ~0x1FFF
    return i.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    peak = x.abs().amax()
    s = torch.where(peak > 0, 448.0 / peak, torch.ones_like(peak))
    return (x * s).to(torch.float8_e4m3fn).float() / s


class _Round(torch.autograd.Function):
    """Rounds a product's operand on the way in and the gradient that
    reaches it on the way back, so both passes' products see rounded
    operands (as a training step computed in that format does)."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10 mantissa bits, to nearest even."""
    return _Round.apply(x, _tf32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Scale to float8 e4m3's largest value by the tensor's peak, round to
    e4m3, scale back."""
    return _Round.apply(x, _fp8)


@dataclass(frozen=True)
class Precision:
    """What a product's operands are rounded to before an f32 product."""

    name: str = "f32"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x.float()
        if self.name == "tf32":
            return round_tf32(x)
        if self.name == "fp8":
            return round_fp8(x)
        raise ValueError(f"unknown precision {self.name!r}")


F32 = Precision("f32")


def linear(x, w, b, p: Precision):
    y = p(x) @ p(w).t()
    return y if b is None else y + b


def conv_same(x, w, p: Precision):
    """(B, T, C_in) x (C_out, C_in, W) -> (B, T, C_out), SAME: (W - 1) // 2
    zeros on the left, the rest on the right."""
    width = w.shape[-1]
    left = (width - 1) // 2
    xt = F.pad(p(x).transpose(1, 2), (left, width - 1 - left))
    return F.conv1d(xt, p(w)).transpose(1, 2)


def param_spec(m: dict) -> dict[str, tuple]:
    """{state-dict name: shape} of the model ``m`` (the model section of a
    benchmark configuration)."""
    spec: dict[str, tuple] = {}

    def dense(name, n_in, n_out, bias=True):
        spec[f"{name}.weight"] = (n_out, n_in)
        if bias:
            spec[f"{name}.bias"] = (n_out,)

    def bn(name, c):
        spec[f"{name}.weight"] = (c,)
        spec[f"{name}.bias"] = (c,)

    def gru_cell(name, n_in, d):
        dense(f"{name}.gates", n_in + d, 2 * d)
        dense(f"{name}.candidate", n_in + d, d)

    def cbhg(name, c_in, k, ch, proj, hw_layers, hw_dim, gru):
        for w in range(1, k + 1):
            spec[f"{name}.bank.conv{w}.weight"] = (ch, c_in, w)
            bn(f"{name}.bank.bn{w}", ch)
        c = k * ch
        for i, d in enumerate(proj):
            spec[f"{name}.proj.proj{i}.weight"] = (d, c, 3)
            bn(f"{name}.proj.bn{i}", d)
            c = d
        if proj[-1] != hw_dim:
            dense(f"{name}.highway.resize", proj[-1], hw_dim)
        for i in range(hw_layers):
            dense(f"{name}.highway.H{i}", hw_dim, hw_dim)
            dense(f"{name}.highway.T{i}", hw_dim, hw_dim)
        for d in ("fwd", "bwd"):
            dense(f"{name}.bigru.{d}.gates_x", hw_dim, 2 * gru)
            dense(f"{name}.bigru.{d}.cand_x", hw_dim, gru)
            dense(f"{name}.bigru.{d}.gates_h", gru, 2 * gru, bias=False)
            dense(f"{name}.bigru.{d}.cand_h", gru, gru, bias=False)

    mem = 2 * m["gru_dim"]
    p0, p1 = m["prenet_dims"]
    spec["encoder.embed.embedding"] = (m["vocab_size"], m["embed_dim"])
    dense("encoder.prenet.fc0", m["embed_dim"], p0)
    dense("encoder.prenet.fc1", p0, p1)
    cbhg("encoder.cbhg", p1, m["encoder_bank_k"], m["encoder_bank_channels"],
         m["encoder_proj_dims"], m["highway_layers"], m["highway_dim"], m["gru_dim"])
    dense("memory_proj", mem, m["attention_dim"], bias=False)
    c = "decoder.cell"
    dense(f"{c}.prenet.fc0", m["n_mels"], p0)
    dense(f"{c}.prenet.fc1", p0, p1)
    gru_cell(f"{c}.attention_gru", p1 + mem, m["attention_gru_dim"])
    spec[f"{c}.attention.v"] = (m["attention_dim"], 1)
    dense(f"{c}.attention.query", m["attention_gru_dim"], m["attention_dim"], bias=False)
    dense(f"{c}.decoder_input_proj", m["attention_gru_dim"] + mem, m["decoder_gru_dim"])
    for i in range(m["decoder_depth"]):
        gru_cell(f"{c}.decoder_gru{i}", m["decoder_gru_dim"], m["decoder_gru_dim"])
    dense(f"{c}.frame_proj", m["decoder_gru_dim"], m["r"] * m["n_mels"])
    cbhg("postnet.cbhg", m["n_mels"], m["postnet_bank_k"], m["postnet_bank_channels"],
         m["postnet_proj_dims"], m["highway_layers"], m["highway_dim"], m["gru_dim"])
    dense("postnet.linear_proj", mem, m["n_freq"])
    return spec


def batch_norm_names(m: dict) -> list[str]:
    """The batch norms' module names (each has running statistics)."""
    return [k[:-len(".weight")] for k, s in param_spec(m).items()
            if len(s) == 1 and k.endswith(".weight")]


class Model:
    """The reference over weights ``w`` ({name: f32 tensor}) and batch-norm
    running statistics ``stats`` ({bn name: (mean, var)}). ``train``
    selects batch statistics (and updates ``stats`` as a training step
    does). All tensors on one device."""

    def __init__(self, m: dict, w: dict, stats: dict, *, train: bool = False,
                 precision: Precision = F32, decode_precision: Precision | None = None):
        self.m, self.w, self.stats, self.train = m, w, stats, train
        self.p = self.p_model = precision
        self.p_decode = precision if decode_precision is None else decode_precision

    # ------------------------------------------------------------ blocks
    def dense(self, name, x, bias=True):
        return linear(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias") if bias else None,
                      self.p)

    def bn(self, name, x):
        scale, shift = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        if self.train:
            mean = x.mean((0, 1))
            var = ((x - mean) ** 2).mean((0, 1))
            rm, rv = self.stats[name]
            with torch.no_grad():
                self.stats[name] = (BN_MOMENTUM * rm + (1 - BN_MOMENTUM) * mean.detach(),
                                    BN_MOMENTUM * rv + (1 - BN_MOMENTUM) * var.detach())
        else:
            mean, var = self.stats[name]
        return (x - mean) / torch.sqrt(var + BN_EPS) * scale + shift

    def prenet(self, name, x, keep):
        for i in range(2):
            x = torch.relu(self.dense(f"{name}.fc{i}", x))
            x = torch.where(keep[i], x * 2.0, torch.zeros_like(x))
        return x

    def gru_step(self, wg, bg, wc, bc, h, gx, cx):
        """TF1 GRU step from the input halves ``gx``/``cx`` already taken
        (with their biases) and the recurrent weights ``wg``/``wc``."""
        ru = torch.sigmoid(gx + linear(h, wg, None, self.p))
        r, u = ru.chunk(2, dim=-1)
        c = torch.tanh(cx + linear(r * h, wc, None, self.p))
        return u * h + (1.0 - u) * c

    def gru_cell(self, name, h, x):
        """``GRUCell`` with fused [x, h] weights."""
        wg, bg = self.w[f"{name}.gates.weight"], self.w[f"{name}.gates.bias"]
        wc, bc = self.w[f"{name}.candidate.weight"], self.w[f"{name}.candidate.bias"]
        n_in = x.shape[-1]
        gx = linear(x, wg[:, :n_in], bg, self.p)
        cx = linear(x, wc[:, :n_in], bc, self.p)
        return self.gru_step(wg[:, n_in:], None, wc[:, n_in:], None, h, gx, cx)

    def bigru(self, name, x, lengths):
        b, t, _ = x.shape
        ts = torch.arange(t, device=x.device)[None, :]
        if lengths is None:
            order = (t - 1 - ts).expand(b, t)
        else:
            lens = lengths[:, None]
            order = torch.where(ts < lens, lens - 1 - ts, ts)
        outs = []
        for d in ("fwd", "bwd"):
            pre = f"{name}.{d}"
            gx = self.dense(f"{pre}.gates_x", x)
            cx = self.dense(f"{pre}.cand_x", x)
            if d == "bwd":
                idx = order[..., None]
                gx = torch.gather(gx, 1, idx.expand(-1, -1, gx.shape[-1]))
                cx = torch.gather(cx, 1, idx.expand(-1, -1, cx.shape[-1]))
            wg, wc = self.w[f"{pre}.gates_h.weight"], self.w[f"{pre}.cand_h.weight"]
            h = x.new_zeros(b, wc.shape[0])
            ys = []
            for i in range(t):
                h = self.gru_step(wg, None, wc, None, h, gx[:, i], cx[:, i])
                ys.append(h)
            ys = torch.stack(ys, 1)
            if d == "bwd":
                ys = torch.gather(ys, 1, order[..., None].expand(-1, -1, ys.shape[-1]))
            outs.append(ys)
        return torch.cat(outs, -1)

    def cbhg(self, name, x, k, lengths):
        bank = [torch.relu(self.bn(f"{name}.bank.bn{w}",
                                   conv_same(x, self.w[f"{name}.bank.conv{w}.weight"], self.p)))
                for w in range(1, k + 1)]
        h = torch.cat(bank, -1)
        nxt = F.pad(h[:, 1:], (0, 0, 0, 1), value=float("-inf"))
        h = torch.where(h >= nxt, h, nxt)                   # width 2, stride 1, SAME
        h = torch.relu(self.bn(f"{name}.proj.bn0", conv_same(h, self.w[f"{name}.proj.proj0.weight"],
                                                            self.p)))
        h = self.bn(f"{name}.proj.bn1", conv_same(h, self.w[f"{name}.proj.proj1.weight"], self.p))
        h = h + x
        if f"{name}.highway.resize.weight" in self.w:
            h = self.dense(f"{name}.highway.resize", h)
        for i in range(self.m["highway_layers"]):
            hh = torch.relu(self.dense(f"{name}.highway.H{i}", h))
            tt = torch.sigmoid(self.dense(f"{name}.highway.T{i}", h))
            h = hh * tt + h * (1.0 - tt)
        return self.bigru(f"{name}.bigru", h, lengths)

    # ------------------------------------------------------------ model
    def encode(self, ids, lengths, keep):
        """-> (memory (B, T_in, 256), keys (B, T_in, A))."""
        x = self.w["encoder.embed.embedding"][ids]
        x = self.prenet("encoder.prenet", x, keep)
        memory = self.cbhg("encoder.cbhg", x, self.m["encoder_bank_k"], lengths)
        return memory, self.dense("memory_proj", memory, bias=False)

    def init_state(self, b, device):
        m = self.m
        z = lambda n: torch.zeros(b, n, device=device)  # noqa: E731
        return (z(m["attention_gru_dim"]), [z(m["decoder_gru_dim"]) for _ in range(m["decoder_depth"])],
                z(2 * m["gru_dim"]), z(m["n_mels"]))

    def decoder_step(self, state, x_in, keys, memory, mask, keep):
        """One step from the frame ``x_in`` -> (state, frames (B, r n_mels),
        alignment (B, T_in)), its products in the decoder's precision."""
        self.p = self.p_decode
        try:
            return self._decoder_step(state, x_in, keys, memory, mask, keep)
        finally:
            self.p = self.p_model

    def _decoder_step(self, state, x_in, keys, memory, mask, keep):
        c = "decoder.cell"
        h_att, h_dec, ctx, _ = state
        x = self.prenet(f"{c}.prenet", x_in, keep)
        h_att = self.gru_cell(f"{c}.attention_gru", h_att, torch.cat([x, ctx], -1))
        q = self.dense(f"{c}.attention.query", h_att, bias=False)
        e = torch.tanh(keys + q[:, None, :])
        scores = (self.p(e) @ self.p(self.w[f"{c}.attention.v"])).squeeze(-1)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        alpha = torch.softmax(scores, -1)
        ctx = (self.p(alpha)[:, None, :] @ self.p(memory)).squeeze(1)
        h = self.dense(f"{c}.decoder_input_proj", torch.cat([h_att, ctx], -1))
        new = []
        for i, hp in enumerate(h_dec):
            hi = self.gru_cell(f"{c}.decoder_gru{i}", hp, h)
            h = h + hi
            new.append(hi)
        frames = self.dense(f"{c}.frame_proj", h)
        n = self.m["n_mels"]
        return (h_att, new, ctx, frames[:, -n:]), frames, alpha

    def postnet(self, mel):
        h = self.cbhg("postnet.cbhg", mel, self.m["postnet_bank_k"], None)
        return self.dense("postnet.linear_proj", h)

    def teacher_forced(self, ids, lengths, mel_gt, enc_keep, dec_keep):
        """Training forward -> (mel, linear, alignments). ``dec_keep``: the
        decoder pre-net's masks over all steps, (B, S, 256) and (B, S, 128)."""
        m = self.m
        memory, keys = self.encode(ids, lengths, enc_keep)
        mask = torch.arange(ids.shape[1], device=ids.device)[None, :] < lengths[:, None]
        b, t_out, n = mel_gt.shape
        r = m["r"]
        last = mel_gt[:, r - 1::r]
        frames_in = torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], 1)
        state = self.init_state(b, ids.device)
        frames, aligns = [], []
        for s in range(t_out // r):
            state, f, a = self.decoder_step(state, frames_in[:, s], keys, memory, mask,
                                            (dec_keep[0][:, s], dec_keep[1][:, s]))
            frames.append(f)
            aligns.append(a)
        mel = torch.stack(frames, 1).reshape(b, t_out, n)
        return mel, self.postnet(mel), torch.stack(aligns, 1)


def l1_loss(mel, linear_, mel_gt, linear_gt):
    """-> (total, mel L1, linear L1): means over every element (the paper
    trains on padded frames unmasked)."""
    ml = (mel - mel_gt).abs().mean()
    ll = (linear_ - linear_gt).abs().mean()
    return ml + ll, ml, ll


class Adam:
    """Adam (Kingma and Ba) with both bias corrections, eps outside the
    square root, after clipping by the global norm: g * max / norm when
    norm >= max."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float, eps: float,
                 clip: float | None):
        self.lr, self.b1, self.b2, self.eps, self.clip = lr, b1, b2, eps, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict) -> dict:
        """Update ``params`` in place -> the gradients as clipped."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if self.clip is not None and norm >= self.clip:
            grads = {k: g / norm * self.clip for k, g in grads.items()}
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.data -= self.lr / bc1 * self.m[k] / denom
        return grads
