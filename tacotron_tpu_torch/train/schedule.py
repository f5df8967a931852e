"""Optimizer and LR schedule (paper §3.3).

Port of the JAX package's ``train/schedule.py``, which chains optax's
``clip_by_global_norm``, ``scale_by_adam`` and a piecewise-constant
learning rate. Here one update is ``apply_gradients``:

1. ``set_learning_rate``: the group's ``lr`` for this update;
2. ``clip_and_step``: clip by the global norm with optax's rule: ``g /
   norm * max`` when ``norm >= max``, else ``g``
   (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and is
   not that rule), then ``torch.optim.Adam``, whose update equals optax's
   ``scale_by_adam`` (eps outside the square root, both bias corrections).

On CUDA the optimizer is built for CUDA graphs (``capturable=True``): its
``lr`` is a 0-d f32 tensor on the device, which ``set_learning_rate``
fills in place, outside any graph and with no host synchronisation, and
Adam's step count and bias corrections live on the device too. Eager and
graphed steps then run the same update. Its bias corrections are f32 on
the device where the CPU's are the host's doubles, so the two differ in
the last bits. torch allows ``capturable`` only on accelerators: on the
CPU ``lr`` stays a float.
"""

from __future__ import annotations

import torch

from tacotron_tpu_torch.config import TrainConfig


def lr_values(cfg: TrainConfig) -> list[float]:
    """The schedule's values, scaled by ``learning_rate / lr_values[0]``:
    overriding the base rate scales the whole schedule."""
    if len(cfg.lr_values) != len(cfg.lr_boundaries) + 1:
        raise ValueError(
            f"train.lr_values needs len(lr_boundaries)+1 entries: got "
            f"{len(cfg.lr_values)} values for {len(cfg.lr_boundaries)} boundaries")
    scale = cfg.learning_rate / cfg.lr_values[0]
    return [v * scale for v in cfg.lr_values]


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """The LR of update number ``count`` (0 for the first update): optax's
    ``piecewise_constant_schedule``, which multiplies in each boundary's
    scale, in boundary order, once ``count >= boundary``."""
    values = lr_values(cfg)
    scales = {b: values[i + 1] / values[i] for i, b in enumerate(cfg.lr_boundaries)}
    lr = values[0]
    for boundary, scale in sorted(scales.items()):
        if count >= boundary:
            lr = scale * lr
    return lr


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every entry of ``grads``, f32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor | None = None):
    """Clip ``grads`` in place with optax's rule; no host synchronisation."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with optax's hyperparameters; capturable, with a device ``lr``,
    when the parameters are on CUDA."""
    params = list(params)
    dev = params[0].device
    lr = lr_values(cfg)[0]
    capturable = dev.type == "cuda"
    opt = torch.optim.Adam(params, lr=torch.tensor(lr, device=dev) if capturable else lr,
                           betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                           capturable=capturable)
    # torch warns once when a capturable Adam steps outside a graph; the
    # eager step does so on purpose (the graph's first step of each shape,
    # and the plain version that the graph is held against)
    opt._warned_capturable_if_run_uncaptured = True
    return opt


def set_learning_rate(opt: torch.optim.Adam, cfg: TrainConfig, count: int) -> None:
    """The LR of update ``count`` into every group: a device ``lr`` is
    filled in place (a captured step reads that tensor), a float replaced."""
    lr = learning_rate(cfg, count)
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def clip_and_step(opt: torch.optim.Adam, cfg: TrainConfig,
                  norm: torch.Tensor | None = None) -> torch.Tensor:
    """Clip and take one Adam step on the ``.grad`` of ``opt``'s
    parameters at the groups' current LR. Returns the global norm before
    clipping: ``norm`` when given (a sharded model's, which no rank can
    take alone), else ``global_norm`` of the gradients."""
    grads = [p.grad for group in opt.param_groups for p in group["params"]]
    if norm is None:
        norm = global_norm(grads)
    if cfg.grad_clip_norm is not None:
        clip_by_global_norm_(grads, cfg.grad_clip_norm, norm)
    opt.step()
    return norm


def apply_gradients(opt: torch.optim.Adam, cfg: TrainConfig, count: int,
                    norm: torch.Tensor | None = None) -> torch.Tensor:
    """Set the LR of update ``count``, then ``clip_and_step``."""
    set_learning_rate(opt, cfg, count)
    return clip_and_step(opt, cfg, norm)
