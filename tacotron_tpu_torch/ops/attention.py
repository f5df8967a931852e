"""Bahdanau (additive, content-based) attention.

Port of the JAX package's ``ops/attention.py``:

    score(q, m_j) = v^T tanh(W_q q + W_m m_j)
    alpha = softmax(score) over encoder time (masked to text length)
    context = sum_j alpha_j m_j

The energy has two forms, chosen by ``ModelConfig.attention_energy``:
``"xla"`` is the JAX package's reference formula on any device;
``"fused"`` is ``ops/attn_energy.attention_energy`` (kernels K1/K2 on CUDA
tensors). This module is also the plain oracle for the attention inside the
fused decode kernel.

With a bf16 ``compute_dtype`` the query and memory projections are bf16, so
the energy's tanh runs on bf16 ``keys``/``q``; ``v``, the scores, the
softmax and the context (over f32 memory) stay f32, as in JAX.

Tacotron 2's location-sensitive attention (Chorowski et al. 2015; Shen et
al. 2018, section 2.3) adds a location term to the keys:

    score(q, m_j) = v^T tanh(W_q q + W_m m_j + W_l f_j)
    f = conv1d([alpha_{t-1}; sum of the previous alphas])

``location_term`` computes ``W_l f`` and ``location_scores`` the energy on
the keys so shifted, through the same helpers; with ``W_l`` zero it is the
additive energy above.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tacotron_tpu_torch.ops.attn_energy import attention_energy, attention_energy_reference
from tacotron_tpu_torch.ops.modules import Dense

NEG_INF = -1e9
ENERGY_FORMS = ("xla", "fused")


def energy_scores(keys, q, v, form: str = "xla"):
    """keys (B, T_in, A), q (B, A), v (A, 1) -> scores (B, T_in) f32."""
    if form == "fused":
        return attention_energy(keys, q, v)
    if form == "xla":
        return attention_energy_reference(keys, q, v)
    raise ValueError(f"attention_energy must be one of {ENERGY_FORMS}, got {form!r}")


def location_term(alpha, alpha_cum, conv_w, dense_w):
    """``W_l f``: the previous alignment and the sum of the alignments
    before it, each (B, T_in), through a bias-free conv1d of (F, 2, K)
    weights with (K - 1) / 2 zeros on each side (K odd), then a bias-free
    Dense F -> A of (A, F) weights -> (B, T_in, A)."""
    pad = (conv_w.shape[-1] - 1) // 2
    f = F.conv1d(torch.stack([alpha, alpha_cum], 1), conv_w, padding=pad)
    return F.linear(f.transpose(1, 2), dense_w)


def location_scores(keys, q, v, location):
    """keys (B, T_in, A), q (B, A), v (A, 1), the location term (B, T_in, A)
    -> scores (B, T_in) f32: ``energy_scores`` on ``keys + location``."""
    return energy_scores(keys + location, q, v)


class BahdanauAttention(nn.Module):
    """``memory_dim`` adds the ``memory`` projection (``process_memory``);
    the decoder omits it, since Tacotron computes the keys once outside the
    decode loop (``memory_proj``)."""

    def __init__(self, query_dim: int, dim: int = 256,
                 memory_dim: int | None = None, energy: str = "xla", *,
                 device=None, dtype=torch.float32, compute_dtype=None):
        super().__init__()
        if energy not in ENERGY_FORMS:
            raise ValueError(f"attention_energy must be one of {ENERGY_FORMS}, got {energy!r}")
        self.energy = energy
        kw = dict(bias=False, device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.query = Dense(query_dim, dim, **kw)
        self.memory = Dense(memory_dim, dim, **kw) if memory_dim is not None else None
        self.v = nn.Parameter(torch.empty(dim, 1, device=device, dtype=dtype))

    def process_memory(self, memory):
        """(B, T_in, D_mem) -> keys (B, T_in, dim)."""
        return self.memory(memory)

    def full_step(self, query, memory, mask=None):
        return self(query, self.process_memory(memory), memory, mask)

    def forward(self, query, keys, memory, mask=None):
        """query (B, D_q); keys (B, T_in, dim); memory (B, T_in, D_mem);
        mask (B, T_in) bool, True = valid. Returns (context (B, D_mem),
        alignment (B, T_in))."""
        scores = energy_scores(keys, self.query(query), self.v, self.energy)
        if mask is not None:
            scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        alignment = torch.softmax(scores, dim=-1)
        context = torch.einsum("bt,btd->bd", alignment, memory.float())
        return context, alignment
