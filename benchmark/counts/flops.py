"""Frozen operation and byte counts, and the chip's peaks.

The FLOP models are copies of the port's ``utils/roofline.py`` at the time
the benchmark was written, kept here so that no later change to the program
moves the yardstick; a CPU test holds each copy equal to the port's
function at the cells' shapes. One departs on purpose: ``train_step_flops``
counts the model's work, three times the forward, whatever the program
recomputes (the port's counts the decoder four times under
``remat_decoder``, so its count moved with an implementation choice).

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at 700 W.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def speed_of_light(flops: float, bytes_accessed: float, peak: float = H100_BF16_FLOPS) -> float:
    """The least seconds the chip could take: the larger of the operations
    over ``peak`` and the bytes over the memory rate."""
    return max(flops / peak, bytes_accessed / H100_HBM_BYTES_PER_S)


def live_span(n_fft: int, win_length: int) -> tuple[int, int]:
    """128-aligned bounds of the window's nonzero samples."""
    lpad = (n_fft - win_length) // 2
    lo = lpad // 128 * 128
    hi = min(-(-(lpad + win_length) // 128) * 128, n_fft)
    return lo, hi


def gl_iteration_flops(batch: int, frames: int, n_fft: int, win_length: int | None = None) -> float:
    """One Griffin-Lim iteration's two products over the 128-aligned live
    span of the window (all of ``n_fft`` without ``win_length``)."""
    if win_length is None:
        k = n_fft
    else:
        lo, hi = live_span(n_fft, win_length)
        k = hi - lo
    n_bins = n_fft // 2 + 1
    return batch * frames * (2 * k * (2 * n_bins) + 2 * (2 * n_bins) * k)


def gl_iteration_flops_exact(batch: int, frames: int, n_fft: int, win_length: int) -> float:
    """The same two products over the window's own ``win_length`` samples:
    the work the algorithm needs, which a kernel's roofline is held to."""
    n_bins = n_fft // 2 + 1
    return batch * frames * 2 * 2 * (2 * n_bins) * win_length


def conv_bank_group_bounds(k: int, groups: int) -> list[tuple[int, int]]:
    g = max(1, min(groups, k))
    bounds = [round(i * k / g) for i in range(g + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def conv_bank_flops(batch: int, t: int, c_in: int, k: int, channels: int,
                    packed: bool = True, groups: int = 1) -> float:
    if not packed:
        taps = k * (k + 1) // 2
    else:
        taps = sum(hi * (hi - lo) for lo, hi in conv_bank_group_bounds(k, groups))
    return 2.0 * batch * t * c_in * channels * taps


def decode_step_flops(batch: int, t_in: int, n_mels: int = 80, r: int = 2,
                      prenet=(256, 128), att_gru: int = 256, att_dim: int = 256,
                      mem_dim: int = 256, dec_dim: int = 256) -> float:
    """One decoder step's products."""
    f = 0.0
    f += 2 * n_mels * prenet[0] + 2 * prenet[0] * prenet[1]
    gi = prenet[1] + mem_dim
    f += 2 * (gi * 3 * att_gru + att_gru * 3 * att_gru)
    f += 2 * att_gru * att_dim + 2 * t_in * att_dim
    f += 2 * t_in * mem_dim
    f += 2 * (att_gru + mem_dim) * dec_dim
    f += 2 * 2 * (dec_dim * 3 * dec_dim + dec_dim * 3 * dec_dim)
    f += 2 * dec_dim * r * n_mels
    return batch * f


def gru_seq_flops(batch: int, t: int, in_dim: int, h: int, bidirectional: bool = False) -> float:
    per_step = 2.0 * (in_dim + h) * (2 * h) + 2.0 * (in_dim + h) * h
    return batch * t * per_step * (2 if bidirectional else 1)


def cbhg_flops(batch: int, t: int, c_in: int, k: int, channels: int, proj_dims, highway_layers: int,
               highway_dim: int, gru_dim: int, groups: int = 1) -> float:
    f = conv_bank_flops(batch, t, c_in, k, channels, groups=groups)
    bank_out = k * channels
    f += 2.0 * batch * t * 3 * (bank_out * proj_dims[0] + proj_dims[0] * proj_dims[1])
    if proj_dims[1] != highway_dim:
        f += 2.0 * batch * t * proj_dims[1] * highway_dim
    f += 2.0 * batch * t * highway_layers * 2 * highway_dim * highway_dim
    f += gru_seq_flops(batch, t, highway_dim, gru_dim, bidirectional=True)
    return f


def _parts(m: dict, batch: int, t_in: int, t_out: int) -> tuple[float, float, float]:
    """(encoder, decoder, post-net) forward products; ``m`` is a benchmark
    configuration's model section."""
    mem = 2 * m["gru_dim"]
    p0, p1 = m["prenet_dims"]
    enc = 2.0 * batch * t_in * (m["embed_dim"] * p0 + p0 * p1)
    enc += cbhg_flops(batch, t_in, p1, m["encoder_bank_k"], m["encoder_bank_channels"],
                      tuple(m["encoder_proj_dims"]), m["highway_layers"], m["highway_dim"],
                      m["gru_dim"])
    enc += 2.0 * batch * t_in * mem * m["attention_dim"]
    dec = decode_step_flops(batch, t_in, n_mels=m["n_mels"], r=m["r"], prenet=(p0, p1),
                            att_gru=m["attention_gru_dim"], att_dim=m["attention_dim"],
                            mem_dim=mem, dec_dim=m["decoder_gru_dim"]) * (t_out // m["r"])
    post = cbhg_flops(batch, t_out, m["n_mels"], m["postnet_bank_k"], m["postnet_bank_channels"],
                      tuple(m["postnet_proj_dims"]), m["highway_layers"], m["highway_dim"],
                      m["gru_dim"])
    post += 2.0 * batch * t_out * mem * m["n_freq"]
    return enc, dec, post


def train_step_flops(m: dict, batch: int, t_in: int, t_out: int, fwd_only: bool = False) -> float:
    """One training step: the forward's products, times three for forward
    and backward, whatever is recomputed."""
    fwd = sum(_parts(m, batch, t_in, t_out))
    return fwd if fwd_only else 3.0 * fwd


def synth_call_flops(m: dict, a: dict, batch: int, t_in: int, n_steps: int, t_gl: int,
                     gl_iters: int) -> float:
    """One served call: encoder, ``n_steps`` decoder steps, the post-net
    over the whole mel buffer, ``gl_iters`` Griffin-Lim iterations over the
    live span at ``t_gl`` frames, and the final inverse transform."""
    enc, dec, post = _parts(m, batch, t_in, n_steps * m["r"])
    gl = gl_iters * gl_iteration_flops(batch, t_gl, a["n_fft"], a["win_length"])
    lo, hi = live_span(a["n_fft"], a["win_length"])
    istft = batch * t_gl * 2.0 * (2 * (a["n_fft"] // 2 + 1)) * (hi - lo)
    return enc + dec + post + gl + istft


def gl_call_bytes(batch: int, frames: int, n_fft: int, win_length: int, bf16: bool) -> float:
    """Griffin-Lim's bytes at least: the f32 magnitude in, the f32 spectrum
    (re, im) out, the two bases once."""
    n_bins = n_fft // 2 + 1
    elt = 2 if bf16 else 4
    return batch * frames * n_bins * 4 * 3 + 2 * win_length * 2 * n_bins * elt


def decode_loop_bytes(m: dict, batch: int, t_in: int, n_steps: int, elt: int) -> float:
    """The fused decode's bytes at least: its weights, memory and keys in
    the storage dtype once, the mask, the frames and alignments out."""
    mem = 2 * m["gru_dim"]
    p0, p1 = m["prenet_dims"]
    ag, dd, att = m["attention_gru_dim"], m["decoder_gru_dim"], m["attention_dim"]
    weights = (m["n_mels"] * p0 + p0 + p0 * p1 + p1
               + 3 * ag * (p1 + mem + ag) + 3 * ag + att * ag + att
               + dd * (ag + mem) + dd + 2 * (3 * dd * 2 * dd + 3 * dd)
               + m["r"] * m["n_mels"] * dd + m["r"] * m["n_mels"])
    io = batch * t_in * (mem + att) * elt + batch * t_in * 4
    out = batch * n_steps * (m["r"] * m["n_mels"] + t_in) * 4
    return weights * elt + io + out


def attn_energy_bytes(batch: int, t_in: int, att: int, elt: int, backward: bool) -> float:
    """K1 reads keys, q and v and writes the energies; K2 reads those and
    the energies' gradient and writes the gradients of keys, q and v."""
    fwd = batch * t_in * att * elt + batch * att * elt + att * 4 + batch * t_in * 4
    if not backward:
        return fwd
    return fwd + batch * t_in * att * elt + batch * att * elt + att * 4
