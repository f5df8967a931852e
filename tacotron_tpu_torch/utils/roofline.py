"""Speed-of-light accounting: achieved against peak FLOP/s and bandwidth.

The port of the JAX package's ``utils/roofline.py``: the same FLOP models
(each returns the JAX function's float for the same arguments) and the same
``KernelRoofline.report()`` keys, against the peaks of one NVIDIA H100 SXM
as NVIDIA's data sheet gives them (dense, without sparsity, at the 700 W
power limit): 989 TFLOP/s on the tensor cores in bf16, 495 in TF32, 67
TFLOP/s in f32 on the CUDA cores, and 3.35 TB/s of HBM. A card set below
700 W runs slower under load, so every measured share is stated beside the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them.

``KernelRoofline(chip=None)`` means ``H100_BF16``, the tensor cores' rate.
A caller whose work runs in f32 with TF32 off (as ``chip_smoke.py`` runs
it) passes ``H100_F32``.
"""

from __future__ import annotations

from dataclasses import dataclass

from tacotron_tpu_torch.dsp.dft import live_span
from tacotron_tpu_torch.ops.modules import conv_bank_group_bounds

# "hbm_gbps" holds bytes per second: the JAX package's key
H100_BF16 = {"flops_peak": 989e12, "hbm_gbps": 3.35e12, "name": "H100 SXM bf16"}
H100_TF32 = {"flops_peak": 495e12, "hbm_gbps": 3.35e12, "name": "H100 SXM tf32"}
H100_F32 = {"flops_peak": 67e12, "hbm_gbps": 3.35e12, "name": "H100 SXM f32"}
H100 = {"bf16": H100_BF16, "tf32": H100_TF32, "f32": H100_F32}


def speed_of_light(flops: float, bytes_accessed: float, chip: dict | None = None):
    """(seconds, "bytes" | "operations"): the least time ``chip`` could take,
    the larger of the bytes over its memory rate and the operations over its
    peak, and which of the two it is."""
    chip = chip or H100_BF16
    tb, to = bytes_accessed / chip["hbm_gbps"], flops / chip["flops_peak"]
    return max(tb, to), ("bytes" if tb >= to else "operations")


@dataclass
class KernelRoofline:
    name: str
    flops: float            # algorithmic FLOPs per invocation
    bytes_accessed: float   # HBM bytes per invocation
    seconds: float          # measured wall time per invocation
    chip: dict = None

    def report(self) -> dict:
        chip = self.chip or H100_BF16
        achieved_flops = self.flops / self.seconds
        achieved_bw = self.bytes_accessed / self.seconds
        # ridge: below this intensity the kernel is bandwidth-bound
        intensity = self.flops / max(self.bytes_accessed, 1.0)
        ridge = chip["flops_peak"] / chip["hbm_gbps"]
        bound = "compute" if intensity >= ridge else "memory"
        sol_time, _ = speed_of_light(self.flops, self.bytes_accessed, chip)
        return {
            "kernel": self.name,
            "chip": chip["name"],
            "time_ms": round(self.seconds * 1e3, 3),
            "achieved_tflops": round(achieved_flops / 1e12, 2),
            "achieved_gbps": round(achieved_bw / 1e9, 1),
            "arith_intensity": round(intensity, 1),
            "bound": bound,
            "speed_of_light_ms": round(sol_time * 1e3, 3),
            "sol_fraction": round(sol_time / self.seconds, 3),
        }


def gl_iteration_flops(batch: int, frames: int, n_fft: int,
                       win_length: int | None = None) -> float:
    """One Griffin-Lim iteration via matmul-DFT: forward + inverse transforms.

    The transforms contract the 128-aligned live window span
    (``dsp/dft.live_span``), so FLOPs scale with that span, not n_fft. The
    Griffin-Lim kernels' bound in ``chip_smoke.py`` counts the exact window
    instead (1102 of 2048 against this span's 1280)."""
    if win_length is None:
        k = n_fft
    else:
        lo, hi = live_span(n_fft, win_length)
        k = hi - lo
    n_bins = n_fft // 2 + 1
    per_frame = 2 * k * (2 * n_bins)   # fwd matmul (re+im columns)
    per_frame += 2 * (2 * n_bins) * k  # inverse matmul
    return batch * frames * per_frame


def conv_bank_flops(batch: int, t: int, c_in: int, k: int, channels: int,
                    packed: bool = True, groups: int = 1) -> float:
    if not packed:
        taps = k * (k + 1) // 2
    else:
        # each packed group (lo, hi] is a width-hi conv with (hi-lo)*channels
        # outputs -> hi*(hi-lo) taps; groups=1 -> k*k
        taps = sum(hi * (hi - lo)
                   for lo, hi in conv_bank_group_bounds(k, groups))
    return 2.0 * batch * t * c_in * channels * taps


def decode_step_flops(batch: int, t_in: int, n_mels: int = 80, r: int = 2,
                      prenet=(256, 128), att_gru: int = 256, att_dim: int = 256,
                      mem_dim: int = 256, dec_dim: int = 256) -> float:
    """One decode step's matmul FLOPs."""
    f = 0.0
    f += 2 * n_mels * prenet[0] + 2 * prenet[0] * prenet[1]      # prenet
    gi = prenet[1] + mem_dim
    f += 2 * (gi * 3 * att_gru + att_gru * 3 * att_gru)          # attention GRU
    f += 2 * att_gru * att_dim + 2 * t_in * att_dim              # query + energy dot
    f += 2 * t_in * mem_dim                                       # context
    f += 2 * (att_gru + mem_dim) * dec_dim                        # input proj
    f += 2 * 2 * (dec_dim * 3 * dec_dim + dec_dim * 3 * dec_dim)  # 2 res GRUs
    f += 2 * dec_dim * r * n_mels                                 # frame proj
    return batch * f


def gru_seq_flops(batch: int, t: int, in_dim: int, h: int,
                  bidirectional: bool = False) -> float:
    """TF1-semantics GRU over a sequence: gates [x,h]@W_g (2h out) +
    candidate [x, r*h]@W_c (h out) per step (ops/gru.py)."""
    per_step = 2.0 * (in_dim + h) * (2 * h) + 2.0 * (in_dim + h) * h
    return batch * t * per_step * (2 if bidirectional else 1)


def cbhg_flops(batch: int, t: int, c_in: int, k: int, channels: int,
               proj_dims: tuple[int, int], highway_layers: int,
               highway_dim: int, gru_dim: int, groups: int = 1) -> float:
    """One CBHG forward (ops/cbhg.py): bank -> width-3 projections ->
    highway stack (with resize when c_in != highway_dim) -> biGRU."""
    f = conv_bank_flops(batch, t, c_in, k, channels, groups=groups)
    bank_out = k * channels
    f += 2.0 * batch * t * 3 * (bank_out * proj_dims[0]
                                + proj_dims[0] * proj_dims[1])
    if proj_dims[1] != highway_dim:          # pre-highway Dense resize
        f += 2.0 * batch * t * proj_dims[1] * highway_dim
    f += 2.0 * batch * t * highway_layers * 2 * highway_dim * highway_dim
    f += gru_seq_flops(batch, t, highway_dim, gru_dim, bidirectional=True)
    return f


def train_step_flops(cfg_model, batch: int, t_in: int, t_out: int,
                     fwd_only: bool = False) -> float:
    """Matmul FLOPs of ONE training step (fwd+bwd) of the full Tacotron at
    these shapes: the whole-step speed-of-light model.

    Forward is summed from the module models above (encoder prenet + CBHG-16,
    memory projection, T_out/r decoder steps, postnet CBHG-8 + Dense(n_freq));
    backward is the standard 2x forward for matmul-dominated nets (one
    matmul each for dL/dW and dL/dx), so fwd+bwd = 3x fwd; with
    remat_decoder the decoder forward is recomputed inside the backward,
    making the decoder 4x its forward. Embedding gather, BN, dropout,
    softmax, loss, and Adam are O(activations/params) and excluded
    (<1% at these shapes).

    The count is of the work the port executes: its ``ConvBank`` packs the
    bank into one width-K conv whatever ``bank_groups`` says, so both banks
    are counted as one packed group. That equals the JAX package's count
    wherever ``bank_groups`` is 1, which every preset sets.
    """
    m = cfg_model
    # encoder: prenet on embeddings, CBHG K=16, attention-key projection
    enc = 2.0 * batch * t_in * (m.embed_dim * m.prenet_dims[0]
                                + m.prenet_dims[0] * m.prenet_dims[1])
    enc += cbhg_flops(batch, t_in, m.prenet_dims[1], m.encoder_bank_k,
                      m.encoder_bank_channels, tuple(m.encoder_proj_dims),
                      m.highway_layers, m.highway_dim, m.gru_dim)
    enc += 2.0 * batch * t_in * m.memory_dim * m.attention_dim
    # decoder: T_out/r sequential steps
    dec = decode_step_flops(
        batch, t_in, n_mels=m.n_mels, r=m.r, prenet=tuple(m.prenet_dims),
        att_gru=m.attention_gru_dim, att_dim=m.attention_dim,
        mem_dim=m.memory_dim, dec_dim=m.decoder_gru_dim) * (t_out // m.r)
    # postnet: CBHG K=8 over ungrouped frames + the wide linear projection
    post = cbhg_flops(batch, t_out, m.n_mels, m.postnet_bank_k,
                      m.postnet_bank_channels, tuple(m.postnet_proj_dims),
                      m.highway_layers, m.highway_dim, m.gru_dim)
    post += 2.0 * batch * t_out * (2 * m.gru_dim) * m.n_freq
    if fwd_only:
        return enc + dec + post
    dec_mult = 4.0 if m.remat_decoder else 3.0
    return 3.0 * (enc + post) + dec_mult * dec
