"""Tacotron 2 for serving: encoder, decoder step and assembly (Shen et al.
2018, "Natural TTS Synthesis by Conditioning WaveNet on Mel Spectrogram
Predictions", arXiv 1712.05884, sections 2.2-2.3), forward only, in f32.
The JAX package has no Tacotron 2; ``benchmark/reference/tacotron2.py`` is
its plain reference.

* Encoder: ``E = embed(ids)``; 3 x [conv1d 512, k 5, SAME, batch norm with
  its running statistics, ReLU]; a bidirectional LSTM, 256 a direction,
  over each row's valid length (``ops/lstm.py``) -> the memory ``M`` (B,
  T_in, 512). ``Tacotron2.memory_proj`` takes the keys ``P = M W_m`` once
  a call.
* Decoder step (``decoder_step``), all state zero at the start and the
  previous frame the zero "go" frame:

      x = prenet(prev)                      2 x [dense 256, ReLU, dropout 0.5]
      h_a, c_a = LSTM_a([x; ctx])           1024, zoneout
      f = conv1d([alpha; alpha_cum])        32 filters, k 31, (k - 1) / 2 zeros a side
      e_j = v . tanh(W_q h_a + P_j + W_l f_j)
      alpha = masked softmax(e); ctx = sum_j alpha_j M_j; alpha_cum += alpha
      h_d, c_d = LSTM_d([h_a; ctx])         1024, zoneout
      y = [h_d; ctx]; frame = W_f y + b_f (r n_mels); gate = w_g . y + b_g

  The decode stops a row at its first step whose gate logit is over
  logit(``gate_threshold``) (``infer.early_exit.WhileDecode``).
* Post-net: ``models/postnet.py``'s ``PostNet`` with the ``tacotron2``
  section (the conv post-net, then the filterbank's pseudo-inverse to the
  linear spectrogram).

Departures from NVIDIA's public implementation (github.com/NVIDIA/tacotron2):

* zoneout 0.1 on both decoder LSTMs' ``h`` and ``c`` in its test-time form,
  ``h_t = 0.1 h_{t-1} + 0.9 h'_t`` (the paper's regulariser), where NVIDIA's
  code applies dropout 0.1 to their outputs in training only;
* the pre-net's layers have biases; the convolutions have none (a batch norm
  follows each); the batch norms' epsilon is the port's 1e-3, NVIDIA's
  1e-5;
* a batch: each row stops at its own gate, and the decode at the last row's
  (NVIDIA's inference loop decodes one utterance and tests its gate).

Dropout runs only in the pre-net, at inference too (as in NVIDIA's code),
drawn per step from the call's generator as ``WhileDecode.draw_masks``
lists the draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from tacotron_tpu_torch.config import AudioConfig, ModelConfig, Tacotron2Config
from tacotron_tpu_torch.models.encoder import Embed
from tacotron_tpu_torch.models.postnet import PostNet
from tacotron_tpu_torch.ops.attention import location_scores, location_term
from tacotron_tpu_torch.ops.decode_chunk import decode_inputs
from tacotron_tpu_torch.ops.lstm import BidirectionalLSTM, LSTMCell, lstm_cell_step
from tacotron_tpu_torch.ops.modules import BatchNorm, Conv1d, Dense, Prenet, dense, dropout


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, t2: Tacotron2Config, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = Embed(cfg.vocab_size, cfg.embed_dim, **kw)
        self.n = t2.encoder_convs
        c_in = cfg.embed_dim
        for i in range(self.n):
            self.add_module(f"conv{i}", Conv1d(c_in, t2.encoder_channels, t2.encoder_kernel, **kw))
            self.add_module(f"bn{i}", BatchNorm(t2.encoder_channels, **kw))
            c_in = t2.encoder_channels
        self.lstm = BidirectionalLSTM(c_in, t2.encoder_lstm_dim, **kw)

    def forward(self, text_ids, text_lengths=None, generator=None):
        """-> memory (B, T_in, 2 encoder_lstm_dim); ``generator`` is unused
        (no dropout here at inference)."""
        x = self.embed(text_ids)
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.lstm(x, text_lengths)


class StepWeights(NamedTuple):
    """The tensors one decoder step reads (the model's own parameters, no
    copies), the zoneout share and the stop gate's threshold (a probability;
    ``WhileDecode`` ends a row at its first step whose gate logit is over
    its logit). The pre-net's and the frame projection's fields are named
    as ``ops/decode_loop.py``'s ``DecoderWeights`` names Tacotron 1's."""

    p_w0: torch.Tensor
    p_b0: torch.Tensor
    p_w1: torch.Tensor
    p_b1: torch.Tensor
    a_lstm: tuple            # attention LSTM: (weight_ih, weight_hh, bias_ih, bias_hh)
    q_w: torch.Tensor        # (A, attention_lstm_dim)
    v: torch.Tensor          # (A, 1)
    l_conv: torch.Tensor     # (location_filters, 2, location_kernel)
    l_dense: torch.Tensor    # (A, location_filters)
    d_lstm: tuple            # decoder LSTM
    f_w: torch.Tensor        # (r n_mels, decoder_lstm_dim + memory)
    f_b: torch.Tensor
    g_w: torch.Tensor        # (1, decoder_lstm_dim + memory)
    g_b: torch.Tensor
    zoneout: float
    gate_threshold: float


class LocationAttention(nn.Module):
    """The attention's parameters: ``query`` (W_q), ``v``, the location
    convolution's (F, 2, K) weights and its Dense F -> A (W_l), all without
    bias; the memory's ``W_m`` is ``Tacotron2.memory_proj``."""

    def __init__(self, query_dim: int, dim: int, filters: int, kernel: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.query = Dense(query_dim, dim, bias=False, **kw)
        self.v = nn.Parameter(torch.empty(dim, 1, **kw))
        self.location_conv = Conv1d(2, filters, kernel, **kw)
        self.location_dense = Dense(filters, dim, bias=False, **kw)


class Decoder(nn.Module):
    """The decoder's parameters; ``decoder_step`` runs a step over
    ``step_weights()``."""

    def __init__(self, cfg: ModelConfig, t2: Tacotron2Config, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mem, p1 = t2.memory_dim, cfg.prenet_dims[-1]
        self.zoneout, self.gate_threshold = t2.zoneout, t2.gate_threshold
        self.prenet = Prenet(cfg.n_mels, cfg.prenet_dims, cfg.prenet_dropout, **kw)
        self.attention_rnn = LSTMCell(p1 + mem, t2.attention_lstm_dim, **kw)
        self.attention = LocationAttention(t2.attention_lstm_dim, cfg.attention_dim,
                                           t2.location_filters, t2.location_kernel, **kw)
        self.decoder_rnn = LSTMCell(t2.attention_lstm_dim + mem, t2.decoder_lstm_dim, **kw)
        self.frame_proj = Dense(t2.decoder_lstm_dim + mem, cfg.r * cfg.n_mels, **kw)
        self.gate = Dense(t2.decoder_lstm_dim + mem, 1, **kw)

    def step_weights(self) -> StepWeights:
        att = self.attention
        return StepWeights(
            self.prenet.fc0.weight, self.prenet.fc0.bias, self.prenet.fc1.weight,
            self.prenet.fc1.bias, self.attention_rnn.weights(), att.query.weight, att.v,
            att.location_conv.weight, att.location_dense.weight, self.decoder_rnn.weights(),
            self.frame_proj.weight, self.frame_proj.bias, self.gate.weight, self.gate.bias,
            self.zoneout, self.gate_threshold)


def decoder_step(memory, keys, mask, w: StepWeights, *, dropout_rate: float,
                 generator: torch.Generator | None):
    """(initial state, ``step``) of the feed-previous decode, in f32.
    ``state, frames, alpha = step(state)`` runs one step; the state is
    (h_a, c_a, h_d, c_d, context, alpha, alpha_cum, previous frame, gate
    logit (B,)), all zero at the start. The mask is added as 0 /
    ``NEG_INF``. Nothing reads the host or sizes an allocation from data,
    so the step can be captured in a CUDA graph."""
    mem, keys, bias = decode_inputs(memory, keys, mask)
    b, t_in, m_dim = mem.shape
    n_mels = w.p_w0.shape[1]
    z = w.zoneout

    def step(state):
        h_a, c_a, h_d, c_d, ctx, alpha, alpha_cum, prev, _ = state
        x = dropout(torch.relu(dense(prev, w.p_w0, w.p_b0)), dropout_rate, generator)
        x = dropout(torch.relu(dense(x, w.p_w1, w.p_b1)), dropout_rate, generator)
        h_a, c_a = lstm_cell_step(torch.cat([x, ctx], -1), h_a, c_a, *w.a_lstm, z)
        loc = location_term(alpha, alpha_cum, w.l_conv, w.l_dense)
        alpha = torch.softmax(location_scores(keys, dense(h_a, w.q_w), w.v, loc) + bias, dim=-1)
        ctx = torch.einsum("bt,btd->bd", alpha, mem)
        alpha_cum = alpha_cum + alpha
        h_d, c_d = lstm_cell_step(torch.cat([h_a, ctx], -1), h_d, c_d, *w.d_lstm, z)
        y = torch.cat([h_d, ctx], -1)
        frames = dense(y, w.f_w, w.f_b)
        gate = dense(y, w.g_w, w.g_b)[:, 0]
        return (h_a, c_a, h_d, c_d, ctx, alpha, alpha_cum, frames[:, -n_mels:], gate), frames, alpha

    dev = mem.device
    z_a = torch.zeros(b, w.a_lstm[1].shape[1], device=dev)
    z_d = torch.zeros(b, w.d_lstm[1].shape[1], device=dev)
    z_t = torch.zeros(b, t_in, device=dev)
    state = (z_a, z_a.clone(), z_d, z_d.clone(), torch.zeros(b, m_dim, device=dev), z_t,
             z_t.clone(), torch.zeros(b, n_mels, device=dev), torch.zeros(b, device=dev))
    return state, step


class Tacotron2(nn.Module):
    """Encoder, keys (``memory_proj``), decoder parameters and post-net;
    ``infer.Synthesizer`` runs them (f32 compute only)."""

    def __init__(self, cfg: ModelConfig, t2: Tacotron2Config, audio: AudioConfig, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise ValueError(f"Tacotron 2 computes in float32 only, not {cfg.compute_dtype}")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, t2, **kw)
        self.memory_proj = Dense(t2.memory_dim, cfg.attention_dim, bias=False, **kw)
        self.decoder = Decoder(cfg, t2, **kw)
        self.postnet = PostNet(cfg, tacotron2=t2, audio=audio, **kw)
