"""The training step: teacher-forced forward, L1 losses, backward, update.

Port of the JAX package's ``train/step.py``. JAX's step is a pure function
of an immutable state; here the state holds PyTorch objects that the step
updates in place (parameters and batch statistics in the model, the Adam
moments in the optimizer, the dropout generator), and ``train_step``
returns it with the update count advanced. ``cfg.model.compute_dtype``
"bfloat16" runs the products in bf16 (``ops/modules.py``) while the
parameters, their gradients and the Adam moments stay f32, as in JAX.

Data and tensor parallelism (``make_train_step(cfg, mesh)``): every rank
runs this step on its shard of the batch, and the step is that of the
global batch, as JAX's GSPMD step is one program whatever the mesh:
dropout masks drawn for the global batch, batch statistics over it
(``ops/modules.py``), the loss its mean (``train/loss.py``), the gradients
summed over the data group (one flat all-reduce after the backward), and
with tensor parallelism (``parallel/sharding.py``) the clipping norm taken
over every parameter once: the split ones' squares summed over the model
group.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.parallel import collectives
from tacotron_tpu_torch.parallel.sharding import shard_model
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


def create_train_state(cfg: Config, seed: int = 0, device=None, mesh=None) -> TrainState:
    """Seeded random weights (``weights.init_params``) in training mode, a
    fresh Adam and a dropout generator on ``device`` (None: the GPU, or the
    mesh's device). With ``mesh`` every rank draws the same weights and the
    same generator, then keeps its shards (``sharding.shard_model``)."""
    dev = resolve_device(mesh.device if device is None and mesh is not None else device)
    model = init_params(Tacotron(cfg.model, device=dev), seed=seed).train()
    if mesh is not None:
        shard_model(model, mesh)
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


def _sharded_norm(model, grads_by_name) -> torch.Tensor:
    """The global norm of a tensor-parallel model's gradients: each split
    parameter's norm from its shards' squares summed over the model group,
    then as ``global_norm``."""
    norms = []
    for name, g in grads_by_name:
        n = torch.linalg.vector_norm(g.float())
        if name in model.tp_shards:
            n = torch.sqrt(collectives.all_reduce_(n * n, model.mesh.model_group))
        norms.append(n)
    return torch.linalg.vector_norm(torch.stack(norms))


def _reduce_gradients(params, group) -> None:
    """Sum every parameter's gradient over ``group``: one flat all-reduce."""
    grads = [p.grad for p in params]
    flat = collectives.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(cfg: Config, mesh=None):
    """``train_step`` bound to ``cfg`` and ``mesh`` (None: one process), the
    counterpart of JAX's jitted step. The state must come from
    ``create_train_state(..., mesh=mesh)``."""
    return functools.partial(train_step, cfg=cfg, mesh=mesh)


def train_step(state: TrainState, text, text_len, mel_gt, linear_gt, frame_len,
               *, cfg: Config, mesh=None, stage_ms: bool = False):
    """One teacher-forced forward/backward/update on the state's device.

    Targets are cast to f32. Returns ``(state, metrics, alignments)``:
    ``metrics`` holds ``mel_loss``, ``linear_loss``, ``total_loss`` and
    ``grad_norm`` (of the unclipped gradients) as 0-d tensors on the device,
    and with ``stage_ms`` a ``stage_ms`` dict of forward / backward /
    optimizer milliseconds. With ``mesh`` the batch is this rank's shard
    and the metrics are the global batch's; every rank must call it.
    """
    model, opt = state.model, state.opt
    if model.cfg != cfg.model:
        raise ValueError("cfg.model differs from the configuration the state's model was built with")
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("the state was not created for this mesh: "
                         "create_train_state(cfg, seed, mesh=mesh)")
    dev = next(model.parameters()).device
    text, text_len = text.to(dev), text_len.to(dev)
    mel_gt = mel_gt.to(dev, torch.float32)
    linear_gt = linear_gt.to(dev, torch.float32)
    if frame_len is not None:
        frame_len = frame_len.to(dev)
    clock = _StageClock(dev, stage_ms)

    model.train()
    data_group = None if mesh is None else mesh.data_group
    gen = state.generator if mesh is None else mesh.batch_shard(state.generator)
    out = model(text, text_len, gt_mel=mel_gt, generator=gen)
    total, metrics = tacotron_loss(out.mel, out.linear, mel_gt, linear_gt, frame_len,
                                   mask_padding=cfg.train.mask_padding,
                                   linear_weight=cfg.train.loss_linear_weight,
                                   data_group=data_group)
    clock.mark("forward")
    opt.zero_grad(set_to_none=True)
    total.backward()
    norm = None
    if data_group is not None:
        _reduce_gradients(list(model.parameters()), data_group)
        if model.tp_shards:
            norm = _sharded_norm(model, [(k, p.grad) for k, p in model.named_parameters()])
    clock.mark("backward")
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = apply_gradients(opt, cfg.train, state.step, norm)
    clock.mark("optimizer")
    if stage_ms:
        metrics["stage_ms"] = clock.ms()
    return state._replace(step=state.step + 1), metrics, out.alignments.detach()
