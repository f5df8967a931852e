"""Frozen configuration dataclasses and named presets.

The PyTorch port's own copy of the JAX package's configuration: the same
sections, field names and presets, so a ``config.json`` written by a JAX run
parses here unchanged (``Config.from_json`` is strict about unknown keys).
Values trace to the Tacotron paper (arXiv 1703.10135, Table 1 / §3) unless
noted; LJSpeech audio parameters follow the common 22.05 kHz convention.

Some fields only steer the JAX implementation (scan unroll factors, bank
groups); they are kept so configs round-trip, and the port ignores them.

``Config.tacotron2`` is the port's own section (the JAX package has no
Tacotron 2): None (the default, and what a JAX ``config.json`` gives) is
Tacotron 1; a ``Tacotron2Config`` makes ``infer.Synthesizer`` serve Tacotron 2
(Shen et al. 2018, arXiv 1712.05884) with the widths it holds and the
``ModelConfig`` fields both architectures share (``vocab_size``,
``embed_dim``, ``prenet_dims``, ``prenet_dropout``, ``attention_dim``,
``n_mels``, ``r``, ``max_decode_steps``); the CBHG and GRU fields are then
unread. ``to_json`` leaves the section out when it is None, so the JAX
package still parses what the port writes.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class AudioConfig:
    """DSP parameters."""

    sample_rate: int = 22050          # LJSpeech native rate
    n_fft: int = 2048                 # paper Table 1: 2048-point Fourier transform
    # 50 ms frame / 12.5 ms hop (paper Table 1), rounded to samples at 22.05 kHz
    win_length: int = 1102
    hop_length: int = 275
    n_mels: int = 80                  # paper Table 1: 80-band mel
    fmin: float = 0.0
    fmax: float | None = None         # None -> sr / 2
    preemphasis: float = 0.97         # paper Table 1
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    griffin_lim_iters: int = 1000     # the reference runs ~1000 iterations
    griffin_lim_power: float = 1.5    # magnitude raised to 1.5 before inversion (paper §3.3)
    # GL transform backend: "pallas" = the Griffin-Lim kernel in its bf16
    # mode (dsp/fused_gl.py; its plain version on CPU tensors), "mm" = the
    # plain matmul-DFT loop in bf16, "mm_f32" = the same in f32, "fft" =
    # classic Griffin-Lim over torch.fft.
    gl_backend: str = "pallas"
    # Fast Griffin-Lim momentum (Perraudin 2013); 0.0 = vanilla GL.
    gl_momentum: float = 0.0
    # JAX kernel: lane-trim of partially windowed chunks. Accepted and
    # without effect here: the port's products cover only the window's
    # nonzero span.
    gl_trim_chunks: bool = False

    def __post_init__(self):
        if not (0 < self.hop_length <= self.win_length <= self.n_fft):
            raise ValueError(
                f"need 0 < hop_length <= win_length <= n_fft, got "
                f"hop={self.hop_length} win={self.win_length} "
                f"n_fft={self.n_fft} (override the trio together)")

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1    # 1025 linear bins


@dataclass(frozen=True)
class ModelConfig:
    """Tacotron architecture (paper Table 1)."""

    vocab_size: int = 256             # overwritten by dataset vocab at train time
    embed_dim: int = 256              # character embedding
    prenet_dims: tuple[int, ...] = (256, 128)
    prenet_dropout: float = 0.5       # active at train AND inference (paper §3.2)
    encoder_bank_k: int = 16          # conv bank widths 1..K
    encoder_bank_channels: int = 128
    encoder_proj_dims: tuple[int, int] = (128, 128)
    postnet_bank_k: int = 8
    postnet_bank_channels: int = 128
    postnet_proj_dims: tuple[int, int] = (256, 80)
    highway_layers: int = 4
    highway_dim: int = 128
    gru_dim: int = 128                # per-direction CBHG biGRU width
    attention_dim: int = 256          # Bahdanau attention depth
    attention_gru_dim: int = 256      # attention RNN
    decoder_gru_dim: int = 256        # each of the 2 residual decoder GRUs
    decoder_depth: int = 2            # residual decoder GRU layers
    n_mels: int = 80
    n_freq: int = 1025
    r: int = 2                        # reduction factor: frames per decoder step
    max_decode_steps: int = 500       # inference: fixed step count, no stop token (paper §3.2)
    bank_groups: int = 1              # JAX packed conv-bank split (ignored here)
    scan_unroll: int = 8              # JAX lax.scan unroll (ignored here)
    gru_scan_unroll: int = 4          # JAX lax.scan unroll (ignored here)
    # training: recompute each decoder step in backward (torch.utils.checkpoint)
    remat_decoder: bool = False
    param_dtype: str = "float32"
    # Computation dtype for matmuls/convs; params, state, BN stats, softmax
    # and loss stay f32.
    compute_dtype: str = "float32"
    tf_decoder: str = "scan"          # teacher-forced decoder form: "scan" | "hoisted"
    # attention energy: "xla" (the plain formula) | "fused" (kernels K1/K2
    # on CUDA tensors)
    attention_energy: str = "xla"
    remat_policy: str = "all"         # "all" or "save_attn" (models/decoder.py)

    @property
    def memory_dim(self) -> int:
        return 2 * self.gru_dim       # bidirectional GRU concat

    @property
    def cdtype(self) -> torch.dtype | None:
        """Computation dtype; None = full precision (f32 everywhere)."""
        if self.compute_dtype == "float32":
            return None
        return getattr(torch, self.compute_dtype)


@dataclass(frozen=True)
class Tacotron2Config:
    """Tacotron 2's own widths (Shen et al. 2018, sections 2.2-2.3; NVIDIA's
    public implementation, ``hparams.py``)."""

    encoder_convs: int = 3            # 3 x [conv, batch norm, ReLU]
    encoder_kernel: int = 5
    encoder_channels: int = 512
    encoder_lstm_dim: int = 256       # per direction; the memory is 2x wide
    attention_lstm_dim: int = 1024
    decoder_lstm_dim: int = 1024
    location_filters: int = 32        # location features: conv1d([alpha; sum alpha])
    location_kernel: int = 31
    postnet_layers: int = 5           # 5 x [conv, batch norm, tanh on all but the last]
    postnet_channels: int = 512
    postnet_kernel: int = 5
    zoneout: float = 0.1              # test-time zoneout on both LSTMs' h and c
    gate_threshold: float = 0.5       # a row ends at its first step with sigmoid(gate) > this

    @property
    def memory_dim(self) -> int:
        return 2 * self.encoder_lstm_dim


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation (paper §3.3)."""

    batch_size: int = 32
    per_chip_batch_size: int = 0
    learning_rate: float = 1e-3
    # lr 1e-3 -> 5e-4 @500k -> 3e-4 @1M -> 1e-4 @2M (paper §3.3)
    lr_boundaries: tuple[int, ...] = (500_000, 1_000_000, 2_000_000)
    lr_values: tuple[float, ...] = (1e-3, 5e-4, 3e-4, 1e-4)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip_norm: float | None = 1.0
    mask_padding: bool = False
    loss_linear_weight: float = 1.0
    checkpoint_every: int = 1000
    summary_every: int = 100
    max_steps: int = 2_000_000
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "ljspeech"
    data_dir: str = "data/ljspeech"
    num_buckets: int = 8
    max_text_len: int = 256
    max_frames: int = 1024
    prefetch: int = 2


@dataclass(frozen=True)
class InferConfig:
    """Synthesis-time behaviour. The reference decodes a FIXED number of
    steps (no stop token, paper §3.2) and returns untrimmed audio."""

    early_exit: bool = False
    silence_threshold: float = 0.05   # normalized mel in [0, 1]; 0 = min_level_db
    min_silence_frames: int = 12      # ~150 ms at the paper's 12.5 ms hop
    trim_before_gl: bool = False
    gl_length_quantum: int = 64


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    name: str = "default"
    tacotron2: Tacotron2Config | None = None

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        raw = dataclasses.asdict(self)
        if self.tacotron2 is None:
            del raw["tacotron2"]
        return json.dumps(raw, indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Config":
        """Parse a serialized config, STRICTLY: a key absent from the
        dataclasses raises instead of silently falling back to a default."""
        raw = json.loads(s)
        known_sections = {f.name for f in dataclasses.fields(Config)}
        alien_sections = set(raw) - known_sections
        if alien_sections:
            raise ValueError(
                f"unknown config section(s) {sorted(alien_sections)} in "
                f"serialized config — field renamed between versions? "
                f"(known: {sorted(known_sections)})")

        def _mk(cls, d, section):
            fields = {f.name for f in dataclasses.fields(cls)}
            unknown = set(d) - fields
            if unknown:
                raise ValueError(
                    f"unknown key(s) {sorted(f'{section}.{k}' for k in unknown)} "
                    f"in serialized config — field renamed between versions? "
                    f"(known {section} fields: {sorted(fields)})")
            return cls(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items()})

        hints = typing.get_type_hints(Config)
        kw = {}
        for f in dataclasses.fields(Config):
            t = hints[f.name]
            if dataclasses.is_dataclass(t):
                kw[f.name] = _mk(t, raw.get(f.name, {}), f.name)
            elif f.name == "tacotron2":
                if raw.get(f.name) is not None:
                    kw[f.name] = _mk(Tacotron2Config, raw[f.name], f.name)
            elif f.name in raw:
                kw[f.name] = raw[f.name]
        return Config(**kw)


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``section.key=value`` strings to a Config.

    Values parse as JSON first (numbers, booleans, lists->tuples), falling
    back to the raw string. Fields of one section are replaced in ONE
    ``dataclasses.replace`` call, so interdependent fields (the audio
    n_fft/win_length/hop_length trio) validate together.
    """
    per_section: dict[str, dict[str, object]] = {}
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if not _ or "." not in key:
            raise ValueError(f"override must be section.key=value, got {ov!r}")
        section, field_name = key.split(".", 1)
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            # Python-style booleans: a bool field set to the truthy string
            # "False" would invert the user's intent
            low = raw.strip().lower()
            val = {"true": True, "false": False}.get(low, raw)
        if isinstance(val, list):
            val = tuple(val)
        sub = getattr(cfg, section)
        if not any(f.name == field_name for f in dataclasses.fields(sub)):
            raise ValueError(f"unknown config field {key!r}")
        cur = getattr(sub, field_name)
        if isinstance(cur, bool) and not isinstance(val, bool):
            raise ValueError(
                f"{key!r} is a boolean flag; got {raw!r} (use true/false)")
        per_section.setdefault(section, {})[field_name] = val
    for section, fields_ in per_section.items():
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(getattr(cfg, section),
                                                 **fields_)})
    return cfg


def _tiny_model() -> ModelConfig:
    # embed 64, CBHG K=4, decoder GRU 128, r=5
    return ModelConfig(
        embed_dim=64,
        prenet_dims=(64, 32),
        encoder_bank_k=4,
        encoder_bank_channels=32,
        encoder_proj_dims=(32, 32),
        postnet_bank_k=4,
        postnet_bank_channels=32,
        postnet_proj_dims=(64, 80),
        highway_layers=2,
        highway_dim=32,
        gru_dim=32,
        attention_dim=64,
        attention_gru_dim=128,
        decoder_gru_dim=128,
        r=5,
        max_decode_steps=40,
    )


PRESETS: dict[str, Config] = {
    "tiny_cpu": Config(
        name="tiny_cpu",
        model=_tiny_model(),
        train=TrainConfig(batch_size=8, checkpoint_every=50, summary_every=10),
        data=DataConfig(num_buckets=1, max_text_len=64, max_frames=200),
    ),
    "cbhg_parity": Config(name="cbhg_parity"),
    "full_1chip": Config(name="full_1chip"),
    # autoregressive inference + 1000-iteration Griffin-Lim
    "synth_gl1000": Config(name="synth_gl1000"),
    "pod_dp": Config(
        name="pod_dp",
        model=ModelConfig(remat_decoder=True, tf_decoder="hoisted",
                          compute_dtype="bfloat16"),
        train=TrainConfig(batch_size=256, per_chip_batch_size=32,
                          summary_every=50),
    ),
    # serving recipe: Fast Griffin-Lim (momentum 0.99 x 100 iterations, the
    # kernel's bf16 mode) + early-exit decode + trimming before Griffin-Lim
    "synth_fast": Config(
        name="synth_fast",
        audio=AudioConfig(griffin_lim_iters=100, gl_momentum=0.99,
                          gl_trim_chunks=True),
        infer=InferConfig(early_exit=True, trim_before_gl=True),
    ),
}


def get_config(name: str) -> Config:
    return PRESETS[name]
