"""The training step: teacher-forced forward, L1 losses, backward, update.

Port of the JAX package's ``train/step.py``. JAX's step is a pure function
of an immutable state; here the state holds PyTorch objects that the step
updates in place (parameters and batch statistics in the model, the Adam
moments in the optimizer, the dropout generator), and ``train_step``
returns it with the update count advanced. ``cfg.model.compute_dtype``
"bfloat16" runs the products in bf16 (``ops/modules.py``) while the
parameters, their gradients and the Adam moments stay f32, as in JAX. Data
and tensor parallelism are not ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.runtime import resolve_device
from tacotron_tpu_torch.train.loss import tacotron_loss
from tacotron_tpu_torch.train.schedule import apply_gradients, make_optimizer
from tacotron_tpu_torch.weights import init_params

STAGES = ("forward", "backward", "optimizer")


class TrainState(NamedTuple):
    model: Tacotron                  # parameters and batch statistics
    opt: torch.optim.Adam            # Adam moments
    step: int                        # updates applied so far
    generator: torch.Generator       # dropout; advances with every step


def create_train_state(cfg: Config, seed: int = 0, device=None) -> TrainState:
    """Seeded random weights (``weights.init_params``) in training mode, a
    fresh Adam and a dropout generator on ``device`` (None: the GPU)."""
    dev = resolve_device(device)
    model = init_params(Tacotron(cfg.model, device=dev), seed=seed).train()
    opt = make_optimizer(model.parameters(), cfg.train)
    # a stream of its own, apart from the one init_params drew the weights from
    dropout_seed = int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    return TrainState(model, opt, 0, gen)


class _StageClock:
    """Milliseconds per stage, by CUDA events on the GPU (read after the
    step ends) and by the host clock on the CPU. Off unless asked for."""

    def __init__(self, device: torch.device, enabled: bool):
        self.cuda = device.type == "cuda"
        self.enabled = enabled
        self.marks = []
        self.mark("start")

    def mark(self, name: str):
        if not self.enabled:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict[str, float]:
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


def train_step(state: TrainState, text, text_len, mel_gt, linear_gt, frame_len,
               *, cfg: Config, stage_ms: bool = False):
    """One teacher-forced forward/backward/update on the state's device.

    Targets are cast to f32. Returns ``(state, metrics, alignments)``:
    ``metrics`` holds ``mel_loss``, ``linear_loss``, ``total_loss`` and
    ``grad_norm`` (of the unclipped gradients) as 0-d tensors on the device,
    and with ``stage_ms`` a ``stage_ms`` dict of forward / backward /
    optimizer milliseconds.
    """
    model, opt = state.model, state.opt
    if model.cfg != cfg.model:
        raise ValueError("cfg.model differs from the configuration the state's model was built with")
    dev = next(model.parameters()).device
    text, text_len = text.to(dev), text_len.to(dev)
    mel_gt = mel_gt.to(dev, torch.float32)
    linear_gt = linear_gt.to(dev, torch.float32)
    if frame_len is not None:
        frame_len = frame_len.to(dev)
    clock = _StageClock(dev, stage_ms)

    model.train()
    out = model(text, text_len, gt_mel=mel_gt, generator=state.generator)
    total, metrics = tacotron_loss(out.mel, out.linear, mel_gt, linear_gt, frame_len,
                                   mask_padding=cfg.train.mask_padding,
                                   linear_weight=cfg.train.loss_linear_weight)
    clock.mark("forward")
    opt.zero_grad(set_to_none=True)
    total.backward()
    clock.mark("backward")
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = apply_gradients(opt, cfg.train, state.step)
    clock.mark("optimizer")
    if stage_ms:
        metrics["stage_ms"] = clock.ms()
    return state._replace(step=state.step + 1), metrics, out.alignments.detach()
