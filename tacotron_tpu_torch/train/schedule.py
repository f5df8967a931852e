"""Optimizer and LR schedule (paper §3.3).

Port of the JAX package's ``train/schedule.py``, which chains optax's
``clip_by_global_norm``, ``scale_by_adam`` and a piecewise-constant
learning rate. Here one update is ``apply_gradients``:

1. clip by the global norm with optax's rule: ``g / norm * max`` when
   ``norm >= max``, else ``g`` (``torch.nn.utils.clip_grad_norm_`` divides
   by ``norm + 1e-6`` and is not that rule);
2. ``torch.optim.Adam``, whose update equals optax's ``scale_by_adam``
   (eps outside the square root, both bias corrections), with the group's
   ``lr`` set for this update.
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
    return torch.optim.Adam(params, lr=lr_values(cfg)[0],
                            betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps)


def apply_gradients(opt: torch.optim.Adam, cfg: TrainConfig, count: int) -> torch.Tensor:
    """Clip, set the LR of update ``count`` and take one Adam step on the
    ``.grad`` of ``opt``'s parameters. Returns the global norm before
    clipping."""
    grads = [p.grad for group in opt.param_groups for p in group["params"]]
    norm = global_norm(grads)
    if cfg.grad_clip_norm is not None:
        clip_by_global_norm_(grads, cfg.grad_clip_norm, norm)
    lr = learning_rate(cfg, count)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return norm
