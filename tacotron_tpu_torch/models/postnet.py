"""Post-processing net: mel -> linear spectrogram.

Tacotron 1 (port of the JAX package's ``models/postnet.py``): CBHG(K=8) ->
Dense(1025). Tacotron 2 (``tacotron2=``; Shen et al. 2018, section 2.2): the
mel plus its residual, 5 x [conv1d 512 (n_mels in and out at the ends),
batch norm, tanh on all but the last], then ``dsp.audio.mel_to_linear``,
since Tacotron 2 predicts only mels. The convolutions have no bias (a batch
norm follows each; NVIDIA's code gives them one).
"""

from __future__ import annotations

import torch
from torch import nn

from tacotron_tpu_torch.config import AudioConfig, ModelConfig, Tacotron2Config
from tacotron_tpu_torch.dsp.audio import mel_to_linear
from tacotron_tpu_torch.dsp.mel import mel_pinv
from tacotron_tpu_torch.ops.cbhg import CBHG
from tacotron_tpu_torch.ops.modules import BatchNorm, Conv1d, Dense


class PostNet(nn.Module):
    def __init__(self, cfg: ModelConfig, *, tacotron2: Tacotron2Config | None = None,
                 audio: AudioConfig | None = None, device=None, dtype=torch.float32):
        super().__init__()
        self.tacotron2 = tacotron2
        if tacotron2 is None:
            kw = dict(device=device, dtype=dtype, compute_dtype=cfg.cdtype)
            self.cbhg = CBHG(cfg.n_mels, cfg.postnet_bank_k, cfg.postnet_bank_channels,
                             cfg.postnet_proj_dims, cfg.highway_layers,
                             cfg.highway_dim, cfg.gru_dim, **kw)
            self.linear_proj = Dense(cfg.memory_dim, cfg.n_freq, **kw)
            return
        if audio.n_freq != cfg.n_freq or audio.n_mels != cfg.n_mels:
            raise ValueError(f"the audio's {audio.n_mels} mels and {audio.n_freq} bins are not "
                             f"the model's {cfg.n_mels} and {cfg.n_freq}")
        self.audio = audio
        n, c_in = tacotron2.postnet_layers, cfg.n_mels
        for i in range(n):
            c_out = cfg.n_mels if i == n - 1 else tacotron2.postnet_channels
            self.add_module(f"conv{i}", Conv1d(c_in, c_out, tacotron2.postnet_kernel,
                                               device=device, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(c_out, device=device, dtype=dtype))
            c_in = c_out
        pinv = mel_pinv(audio.sample_rate, audio.n_fft, audio.n_mels, audio.fmin, audio.fmax)
        self.register_buffer("pinv", torch.from_numpy(pinv).to(device), persistent=False)

    def forward(self, mel, lengths=None):
        if self.tacotron2 is None:
            return self.linear_proj(self.cbhg(mel, lengths=lengths)).float()
        n = self.tacotron2.postnet_layers
        x = mel
        for i in range(n):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            if i < n - 1:
                x = torch.tanh(x)
        return mel_to_linear(mel + x, self.audio, self.pinv)
