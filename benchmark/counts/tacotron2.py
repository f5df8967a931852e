"""Operation and byte counts of Tacotron 2 (``reference/tacotron2.py``),
from a configuration's model (``m``), ``tacotron2`` (``t2``) and audio
(``a``) sections: what the algorithm needs, whatever a program does, so that
every later implementation is read against the same work.

A decoder step reads every weight of the step once: the pre-net, both
LSTMs (two biases each), the attention's query, ``v``, location convolution
and its Dense, the frame projection and the gate (``step_params``; the
memory's ``W_m`` is not read in a step, its keys are taken once a call).
Beside them it reads the memory ``M`` and the keys ``P`` once. At the
published widths that is 18,190,481 parameters, 72.8 MB in f32, and with
``M`` and ``P`` of 8 rows of 160 characters 76.0 MB a step.

FLOPs count the products (two a multiply-add), as ``flops.py`` does for
Tacotron 1.
"""

from __future__ import annotations

from benchmark.counts.flops import gl_iteration_flops, live_span

F32 = 4


def _dims(m: dict, t2: dict):
    mem = 2 * t2["encoder_lstm_dim"]
    return (mem, t2["attention_lstm_dim"], t2["decoder_lstm_dim"], m["attention_dim"],
            m["prenet_dims"][0], m["prenet_dims"][1], m["r"] * m["n_mels"])


def step_params(m: dict, t2: dict) -> int:
    """The parameters one decoder step reads."""
    mem, ha, hd, att, p0, p1, out = _dims(m, t2)
    prenet = m["n_mels"] * p0 + p0 + p0 * p1 + p1
    lstm_a = 4 * ha * (p1 + mem) + 4 * ha * ha + 2 * 4 * ha
    attention = att * ha + att + t2["location_filters"] * 2 * t2["location_kernel"] \
        + att * t2["location_filters"]
    lstm_d = 4 * hd * (ha + mem) + 4 * hd * hd + 2 * 4 * hd
    heads = (out + 1) * (hd + mem) + out + 1
    return prenet + lstm_a + attention + lstm_d + heads


def step_bytes(m: dict, t2: dict, b: int, t_in: int) -> int:
    """One step's bytes at least, in f32: its weights, the memory and the
    keys once."""
    mem, att = 2 * t2["encoder_lstm_dim"], m["attention_dim"]
    return F32 * (step_params(m, t2) + b * t_in * (mem + att))


def step_flops(m: dict, t2: dict, b: int, t_in: int) -> float:
    """One decoder step's products."""
    mem, ha, hd, att, p0, p1, out = _dims(m, t2)
    f = 2 * m["n_mels"] * p0 + 2 * p0 * p1
    f += 2 * (p1 + mem + ha) * 4 * ha
    f += 2 * t_in * t2["location_filters"] * (2 * t2["location_kernel"] + att)
    f += 2 * ha * att + 2 * t_in * att + 2 * t_in * mem
    f += 2 * (ha + mem + hd) * 4 * hd
    f += 2 * (hd + mem) * (out + 1)
    return float(b * f)


def encoder_flops(m: dict, t2: dict, b: int, t_in: int) -> float:
    """The convolutions, the bidirectional LSTM and the keys."""
    ch, k, h = t2["encoder_channels"], t2["encoder_kernel"], t2["encoder_lstm_dim"]
    f, c_in = 0.0, m["embed_dim"]
    for _ in range(t2["encoder_convs"]):
        f += 2.0 * b * t_in * c_in * ch * k
        c_in = ch
    f += 2 * 2.0 * b * t_in * (c_in + h) * 4 * h
    return f + 2.0 * b * t_in * 2 * h * m["attention_dim"]


def postnet_flops(m: dict, t2: dict, b: int, frames: int) -> float:
    """The conv post-net and the pseudo-inverse to the linear spectrogram."""
    n, ch, k = t2["postnet_layers"], t2["postnet_channels"], t2["postnet_kernel"]
    f, c_in = 0.0, m["n_mels"]
    for i in range(n):
        c_out = m["n_mels"] if i == n - 1 else ch
        f += 2.0 * b * frames * c_in * c_out * k
        c_in = c_out
    return f + 2.0 * b * frames * m["n_mels"] * m["n_freq"]


def call_flops(m: dict, t2: dict, a: dict, b: int, t_in: int, n_steps: int, t_gl: int,
               gl_iters: int) -> float:
    """One served call: encoder, ``n_steps`` decoder steps, the post-net
    over their ``n_steps r`` frames, ``gl_iters`` Griffin-Lim iterations
    over the window's live span at ``t_gl`` frames, and the final inverse
    transform (as ``flops.synth_call_flops`` counts Tacotron 1's)."""
    f = encoder_flops(m, t2, b, t_in) + n_steps * step_flops(m, t2, b, t_in)
    f += postnet_flops(m, t2, b, n_steps * m["r"])
    f += gl_iters * gl_iteration_flops(b, t_gl, a["n_fft"], a["win_length"])
    lo, hi = live_span(a["n_fft"], a["win_length"])
    return f + b * t_gl * 2.0 * (2 * (a["n_fft"] // 2 + 1)) * (hi - lo)


def decode_bytes(m: dict, t2: dict, b: int, t_in: int, n_steps: int) -> int:
    """The step decode's bytes at least: ``n_steps`` steps' (the weights
    exceed the chip's L2, so each step reads them again)."""
    return n_steps * step_bytes(m, t2, b, t_in)
