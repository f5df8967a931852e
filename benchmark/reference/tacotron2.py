"""Plain PyTorch Tacotron 2: the benchmark's reference for the served model
(Shen et al. 2018, "Natural TTS Synthesis by Conditioning WaveNet on Mel
Spectrogram Predictions", arXiv 1712.05884, sections 2.2-2.3; widths as
NVIDIA's public implementation sets them, github.com/NVIDIA/tacotron2).

Written from the paper's equations, in float32, over a flat dict of weights
keyed by state-dict names (``param_spec``), with no cache, no graphs and no
batching tricks. It imports nothing of the program under test; the benchmark
draws the weights, the inputs and the dropout masks and hands the same to
both sides. TF32 is off while it runs (``tf32_off``).

* Encoder: character embedding; 3 x [conv1d, k 5, SAME, batch norm with its
  running statistics, ReLU]; a bidirectional LSTM whose backward direction
  reverses each row's text only.
* Location-sensitive attention: ``e_j = v . tanh(W_q h_a + W_m m_j + W_l
  f_j)``, ``f = conv1d([alpha_{t-1}; sum of the alphas before], k, zeros
  (k - 1) / 2 a side)``, masked softmax over the text.
* Decoder step: pre-net (2 x [dense, ReLU, dropout 0.5, at inference too])
  on the previous frame; the attention LSTM on [pre-net, previous
  context]; attention; the decoder LSTM on [attention LSTM, context]; a
  frame ``W_f [h_d; ctx] + b_f`` and a gate logit ``w_g . [h_d; ctx] +
  b_g``. LSTMs in ``torch.nn.LSTMCell``'s form (gates i, f, g, o; two
  biases) with test-time zoneout ``h = z h_prev + (1 - z) h_new``, the same
  for ``c``. A row ends at its first step whose gate logit is over
  logit(gate_threshold); its later frames and alignments are zero. The
  decode stops when every row has ended or after ``n_steps`` steps.
* Post-net: ``mel + convs(mel)``, 5 x [conv1d k 5, batch norm, tanh on all
  but the last]; then to the linear spectrogram: the normalised mel to
  amplitude, the pseudo-inverse of the Slaney mel filterbank (computed in
  float64), the amplitude floor 1e-5, back to normalised dB.

Departures from NVIDIA's code, as the program's: zoneout in place of the
decoder LSTMs' dropout, biases on the pre-net, none on the convolutions,
batch-norm epsilon 1e-3; a batch decodes with a gate per row.

``Precision`` (``model.py``) rounds both operands of every product (dense,
LSTM, convolution, energy contraction, context, the pseudo-inverse) for the
benchmark's controls; the reference proper is f32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import audio
from benchmark.reference.masks import prenet_keep
from benchmark.reference.model import BN_EPS, F32, NEG_INF, Precision, conv_same, linear


@contextlib.contextmanager
def tf32_off():
    """f32 products in f32 while the block runs (torch lets cuDNN take TF32
    by default)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def param_spec(m: dict, t2: dict) -> dict[str, tuple]:
    """{state-dict name: shape} of the model (``m``: a configuration's model
    section, ``t2``: its ``tacotron2`` section)."""
    spec: dict[str, tuple] = {}
    mem, ch = 2 * t2["encoder_lstm_dim"], t2["encoder_channels"]
    ha, hd, att = t2["attention_lstm_dim"], t2["decoder_lstm_dim"], m["attention_dim"]
    p0, p1 = m["prenet_dims"]

    def lstm(name, n_in, h):
        spec[f"{name}.weight_ih"] = (4 * h, n_in)
        spec[f"{name}.weight_hh"] = (4 * h, h)
        spec[f"{name}.bias_ih"] = (4 * h,)
        spec[f"{name}.bias_hh"] = (4 * h,)

    def conv_bn(name, i, c_in, c_out, k):
        spec[f"{name}.conv{i}.weight"] = (c_out, c_in, k)
        spec[f"{name}.bn{i}.weight"] = (c_out,)
        spec[f"{name}.bn{i}.bias"] = (c_out,)

    spec["encoder.embed.embedding"] = (m["vocab_size"], m["embed_dim"])
    for i in range(t2["encoder_convs"]):
        conv_bn("encoder", i, m["embed_dim"] if i == 0 else ch, ch, t2["encoder_kernel"])
    for d in ("fwd", "bwd"):
        lstm(f"encoder.lstm.{d}", ch, t2["encoder_lstm_dim"])
    spec["memory_proj.weight"] = (att, mem)
    c = "decoder"
    spec[f"{c}.prenet.fc0.weight"], spec[f"{c}.prenet.fc0.bias"] = (p0, m["n_mels"]), (p0,)
    spec[f"{c}.prenet.fc1.weight"], spec[f"{c}.prenet.fc1.bias"] = (p1, p0), (p1,)
    lstm(f"{c}.attention_rnn", p1 + mem, ha)
    spec[f"{c}.attention.query.weight"] = (att, ha)
    spec[f"{c}.attention.v"] = (att, 1)
    spec[f"{c}.attention.location_conv.weight"] = (t2["location_filters"], 2,
                                                   t2["location_kernel"])
    spec[f"{c}.attention.location_dense.weight"] = (att, t2["location_filters"])
    lstm(f"{c}.decoder_rnn", ha + mem, hd)
    spec[f"{c}.frame_proj.weight"] = (m["r"] * m["n_mels"], hd + mem)
    spec[f"{c}.frame_proj.bias"] = (m["r"] * m["n_mels"],)
    spec[f"{c}.gate.weight"], spec[f"{c}.gate.bias"] = (1, hd + mem), (1,)
    n = t2["postnet_layers"]
    for i in range(n):
        conv_bn("postnet", i, m["n_mels"] if i == 0 else t2["postnet_channels"],
                m["n_mels"] if i == n - 1 else t2["postnet_channels"], t2["postnet_kernel"])
    return spec


def batch_norm_names(m: dict, t2: dict) -> list[str]:
    """The batch norms' module names (each has running statistics)."""
    return [k[:-len(".weight")] for k, s in param_spec(m, t2).items()
            if len(s) == 1 and k.endswith(".weight")]


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, n_fft / 2 + 1) float64 Slaney filterbank: triangles evenly
    spaced on the Slaney mel scale (linear below 1 kHz, logarithmic above),
    each scaled to area 2 / its bandwidth (librosa's ``norm="slaney"``)."""
    f_sp, brk = 200.0 / 3, 1000.0
    step = math.log(6.4) / 27.0

    def to_mel(f):
        return np.where(f >= brk, brk / f_sp + np.log(np.maximum(f, 1e-10) / brk) / step, f / f_sp)

    def to_hz(x):
        return np.where(x >= brk / f_sp, brk * np.exp(step * (x - brk / f_sp)), f_sp * x)

    bins = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = to_hz(np.linspace(to_mel(np.float64(fmin)), to_mel(np.float64(fmax)), n_mels + 2))
    up = (bins[None, :] - hz[:-2, None]) / (hz[1:-1] - hz[:-2])[:, None]
    down = (hz[2:, None] - bins[None, :]) / (hz[2:] - hz[1:-1])[:, None]
    return np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hz[2:] - hz[:-2]))[:, None]


class Tacotron2:
    """The reference over weights ``w`` ({name: f32 tensor}) and batch-norm
    running statistics ``stats`` ({bn name: (mean, var)}); ``a``: the audio
    section. All tensors on one device."""

    def __init__(self, m: dict, t2: dict, a: dict, w: dict, stats: dict, *,
                 precision: Precision = F32):
        self.m, self.t2, self.a, self.w, self.stats, self.p = m, t2, a, w, stats, precision
        dev = w["memory_proj.weight"].device
        fb = mel_filterbank(a["sample_rate"], a["n_fft"], m["n_mels"], a["fmin"],
                            a["fmax"] if a["fmax"] is not None else a["sample_rate"] / 2.0)
        self.pinv = torch.from_numpy(np.linalg.pinv(fb)).float().to(dev)     # (n_freq, n_mels)

    # ------------------------------------------------------------ blocks
    def dense(self, name, x, bias=True):
        return linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"] if bias else None,
                      self.p)

    def bn(self, name, x):
        mean, var = self.stats[name]
        return (x - mean) / torch.sqrt(var + BN_EPS) * self.w[f"{name}.weight"] + self.w[
            f"{name}.bias"]

    def conv_bn(self, name, i, x):
        return self.bn(f"{name}.bn{i}", conv_same(x, self.w[f"{name}.conv{i}.weight"], self.p))

    def lstm_gates(self, name, x, h):
        return (linear(x, self.w[f"{name}.weight_ih"], self.w[f"{name}.bias_ih"], self.p)
                + linear(h, self.w[f"{name}.weight_hh"], self.w[f"{name}.bias_hh"], self.p))

    @staticmethod
    def lstm_update(gates, c):
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def lstm_cell(self, name, x, h, c):
        """One step with test-time zoneout on ``h`` and ``c``."""
        z = self.t2["zoneout"]
        h_new, c_new = self.lstm_update(self.lstm_gates(name, x, h), c)
        return z * h + (1.0 - z) * h_new, z * c + (1.0 - z) * c_new

    def bilstm(self, name, x, lengths):
        b, t, _ = x.shape
        ts = torch.arange(t, device=x.device)[None, :]
        lens = lengths[:, None]
        order = torch.where(ts < lens, lens - 1 - ts, ts)[..., None]
        outs = []
        for d in ("fwd", "bwd"):
            xs = torch.gather(x, 1, order.expand(-1, -1, x.shape[-1])) if d == "bwd" else x
            h = c = x.new_zeros(b, self.w[f"{name}.{d}.weight_hh"].shape[1])
            ys = []
            for i in range(t):
                h, c = self.lstm_update(self.lstm_gates(f"{name}.{d}", xs[:, i], h), c)
                ys.append(h)
            ys = torch.stack(ys, 1)
            if d == "bwd":
                ys = torch.gather(ys, 1, order.expand(-1, -1, ys.shape[-1]))
            outs.append(ys)
        return torch.cat(outs, -1)

    # ------------------------------------------------------------ model
    def encode(self, ids, lengths):
        """-> (memory (B, T_in, 512), keys (B, T_in, A))."""
        x = self.w["encoder.embed.embedding"][ids]
        for i in range(self.t2["encoder_convs"]):
            x = torch.relu(self.conv_bn("encoder", i, x))
        memory = self.bilstm("encoder.lstm", x, lengths)
        return memory, self.dense("memory_proj", memory, bias=False)

    def init_state(self, b, t_in, device):
        t2, m = self.t2, self.m
        z = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
        ha, hd = t2["attention_lstm_dim"], t2["decoder_lstm_dim"]
        return {"h_a": z(b, ha), "c_a": z(b, ha), "h_d": z(b, hd), "c_d": z(b, hd),
                "ctx": z(b, 2 * t2["encoder_lstm_dim"]), "alpha": z(b, t_in),
                "alpha_cum": z(b, t_in), "prev": z(b, m["n_mels"])}

    def decoder_step(self, s, keys, memory, mask, keep):
        """One step from state ``s`` -> (state, frames (B, r n_mels),
        alignment (B, T_in), gate logit (B,))."""
        c, p = "decoder", self.p
        x = s["prev"]
        for i in range(2):
            x = torch.relu(self.dense(f"{c}.prenet.fc{i}", x))
            x = torch.where(keep[i], x * 2.0, torch.zeros_like(x))
        h_a, c_a = self.lstm_cell(f"{c}.attention_rnn", torch.cat([x, s["ctx"]], -1), s["h_a"],
                                  s["c_a"])
        conv_w = self.w[f"{c}.attention.location_conv.weight"]
        k = conv_w.shape[-1]
        f = F.conv1d(p(torch.stack([s["alpha"], s["alpha_cum"]], 1)), p(conv_w),
                     padding=(k - 1) // 2).transpose(1, 2)
        loc = linear(f, self.w[f"{c}.attention.location_dense.weight"], None, p)
        q = self.dense(f"{c}.attention.query", h_a, bias=False)
        e = torch.tanh(q[:, None, :] + keys + loc)
        scores = (p(e) @ p(self.w[f"{c}.attention.v"])).squeeze(-1)
        alpha = torch.softmax(torch.where(mask, scores, torch.full_like(scores, NEG_INF)), -1)
        ctx = (p(alpha)[:, None, :] @ p(memory)).squeeze(1)
        h_d, c_d = self.lstm_cell(f"{c}.decoder_rnn", torch.cat([h_a, ctx], -1), s["h_d"],
                                  s["c_d"])
        y = torch.cat([h_d, ctx], -1)
        frames = self.dense(f"{c}.frame_proj", y)
        gate = self.dense(f"{c}.gate", y)[:, 0]
        state = {"h_a": h_a, "c_a": c_a, "h_d": h_d, "c_d": c_d, "ctx": ctx, "alpha": alpha,
                 "alpha_cum": s["alpha_cum"] + alpha, "prev": frames[:, -self.m["n_mels"]:]}
        return state, frames, alpha, gate

    def postnet(self, mel):
        """The mel's residual through the conv post-net, then the linear
        spectrogram."""
        x, n = mel, self.t2["postnet_layers"]
        for i in range(n):
            x = self.conv_bn("postnet", i, x)
            if i < n - 1:
                x = torch.tanh(x)
        return self.mel_to_linear(mel + x)

    def mel_to_linear(self, mel):
        a = self.a
        db = torch.clamp(mel, 0.0, 1.0) * -a["min_level_db"] + a["min_level_db"] + a["ref_level_db"]
        amp = linear(torch.pow(10.0, db * 0.05), self.pinv, None, self.p)
        db = 20.0 * torch.log10(torch.clamp(amp, min=1e-5)) - a["ref_level_db"]
        return torch.clamp((db - a["min_level_db"]) / -a["min_level_db"], 0.0, 1.0)


def synthesize(cfg: dict, t2: dict, w: dict, stats: dict, ids, lengths, seed: int, *,
               n_steps: int, gl_iters: int, precision: Precision = F32,
               gl_precision: Precision = F32) -> dict:
    """One served call -> {mel, linear, alignments, gates (B, steps run),
    end_frames, t_gl, magnitude, re, im} (tensors on the inputs' device, end
    frames numpy; ``gl_iters`` 0 runs no Griffin-Lim and gives ``re``,
    ``im`` None). ``cfg``: the model, audio and infer sections as plain
    dicts. The decoder's pre-net masks: per step the next (B, P0) and (B,
    P1) uniform draws of a generator seeded with ``seed``, kept below 1 -
    rate (the encoder draws none)."""
    m, a, inf = cfg["model"], cfg["audio"], cfg["infer"]
    dev = ids.device
    b, t_in = ids.shape
    r, n = m["r"], m["n_mels"]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    stats = {k[:-len(".running_mean")]: (v, stats[k[:-len("mean")] + "var"])
             for k, v in stats.items() if k.endswith(".running_mean")}
    logit = math.log(t2["gate_threshold"] / (1.0 - t2["gate_threshold"]))
    with tf32_off():
        model = Tacotron2(m, t2, a, w, stats, precision=precision)
        memory, keys = model.encode(ids, lengths)
        mask = torch.arange(t_in, device=dev)[None, :] < lengths[:, None]
        state = model.init_state(b, t_in, dev)
        frames = torch.zeros(b, n_steps, r * n, device=dev)
        aligns = torch.zeros(b, n_steps, t_in, device=dev)
        gates = []
        ended = torch.zeros(b, dtype=torch.bool, device=dev)
        steps = torch.zeros(b, dtype=torch.int64, device=dev)
        for s in range(n_steps):
            keep = prenet_keep(gen, (b,), m["prenet_dims"], m["prenet_dropout"], dev)
            state, f, al, g = model.decoder_step(state, keys, memory, mask, keep)
            live = ~ended
            frames[:, s] = torch.where(live[:, None], f, 0.0)
            aligns[:, s] = torch.where(live[:, None], al, 0.0)
            gates.append(g)
            steps += live
            ended |= live & (g > logit)
            if bool(ended.all()):
                break
        mel = frames.reshape(b, n_steps * r, n)
        linear_ = model.postnet(mel)
        ends = (steps * r).cpu().numpy()
        t_gl = mel.shape[1]
        if inf["trim_before_gl"]:
            q = inf["gl_length_quantum"]
            t_gl = min(int(-(-max(int(ends.max()), q) // q) * q), t_gl)
        mag = audio.magnitude(linear_[:, :t_gl], a)
        re = im = None
        if gl_iters:
            re, im = audio.griffin_lim(mag, a, gl_iters, a["gl_momentum"], gl_precision)
    return {"mel": mel, "linear": linear_, "alignments": aligns, "gates": torch.stack(gates, 1),
            "end_frames": ends, "t_gl": t_gl, "magnitude": mag, "re": re, "im": im}
