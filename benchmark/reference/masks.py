"""The pre-nets' dropout masks, drawn as the served and the trained model
draw them.

The program takes a seed (a call's ``seed``, a training state's dropout
generator) and draws its masks from ``torch``'s generator on the device,
so the reference draws the same from a generator of its own seeded alike:
a mask keeps a unit where a uniform draw of ``torch.rand`` is below 1 -
rate. The order and the shapes of the draws are the model's: the encoder's
pre-net over (B, T_in) first, its two layers in turn, then the decoder's
pre-net, per step (serving) or over all steps at once (training).
"""

from __future__ import annotations

import torch


def _keep(gen, shape, rate, device):
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def prenet_keep(gen, lead: tuple, dims, rate: float, device):
    """The two layers' keep masks over leading shape ``lead``."""
    return tuple(_keep(gen, (*lead, d), rate, device) for d in dims)


class ServeMasks:
    """The masks of one served call with ``seed``: ``encoder`` now, then
    ``step()`` for each decoder step in turn."""

    def __init__(self, seed: int, b: int, t_in: int, dims, rate: float, device):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.b, self.dims, self.rate, self.device = b, tuple(dims), rate, device
        self.encoder = prenet_keep(self.gen, (b, t_in), self.dims, rate, device)

    def step(self):
        return prenet_keep(self.gen, (self.b,), self.dims, self.rate, self.device)

    def seed_draw(self) -> int:
        """The int that a ``randint(0, 2**31 - 1)`` draws next."""
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.gen, device=self.device))


def train_keep(gen, b: int, t_in: int, steps: int, dims, rate: float, device):
    """One training step's masks -> (encoder's, decoder's over all steps)."""
    return (prenet_keep(gen, (b, t_in), dims, rate, device),
            prenet_keep(gen, (b, steps), dims, rate, device))
