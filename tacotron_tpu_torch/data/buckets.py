"""Length bucketing with a small fixed set of padded shapes.

The port's own copy of the JAX package's ``data/buckets.py`` (numpy only).
A few buckets are chosen from the length histogram; each bucket is one
padded (text_len, n_frames) shape, with n_frames a multiple of r. The same
buckets give the same batches as the JAX package's loader, and on the card
each bucket's shape gets one captured CUDA graph of the training step
(``train.step.GraphedTrainStep``), as JAX compiles its step per bucket.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BucketSpec:
    text_len: int
    n_frames: int   # multiple of r

    def key(self):
        return (self.text_len, self.n_frames)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_buckets(text_lens, frame_lens, num_buckets: int, r: int,
                 text_quantum: int = 8) -> list[BucketSpec]:
    """Choose bucket boundaries from the joint length distribution.

    Buckets are quantiles of frame length (the dominant padding cost); each
    bucket's text_len is the max text length among its members, rounded up.
    """
    text_lens = np.asarray(text_lens)
    frame_lens = np.asarray(frame_lens)
    qs = np.linspace(0, 100, num_buckets + 1)[1:]
    frame_edges = sorted({_round_up(int(np.percentile(frame_lens, q)), r) for q in qs})

    buckets = []
    prev = 0
    for edge in frame_edges:
        sel = (frame_lens > prev) & (frame_lens <= edge)
        if not np.any(sel):
            prev = edge
            continue
        tmax = _round_up(int(text_lens[sel].max()), text_quantum)
        buckets.append(BucketSpec(text_len=tmax, n_frames=edge))
        prev = edge
    return buckets


def assign_bucket(buckets: list[BucketSpec], text_len: int, n_frames: int) -> int:
    """Smallest bucket that fits; -1 if nothing fits (caller drops or clips)."""
    for i, b in enumerate(buckets):
        if text_len <= b.text_len and n_frames <= b.n_frames:
            return i
    return -1
