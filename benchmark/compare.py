"""The comparison that decides ``correct``: each number compared against the
limit the cell's file gives it (``benchmark/workloads/<cell>.json``,
``"limits"``). A number over its limit, or one that is not finite, is not
correct; so is a limit with no number.

Serving cells, per sampled call, worst over the sample:

* ``mel_gap``, ``linear_gap``: the largest difference from the reference's
  mel / linear spectrogram, over the reference's peak;
* ``align_gap``: the largest difference of an attention weight;
* ``end_frames_wrong``: rows whose end frame differs, a waveform whose
  length is not Griffin-Lim's trimmed length, and rows with a sample that
  is not finite (exact: limit 0);
* ``wav_sc_excess``: the served waveforms against the served linear
  spectrogram: their spectral convergence to its magnitude less that of
  the reference's own Griffin-Lim on the same magnitude, the mean over the
  rows (Griffin-Lim multiplies a difference 3-10 times an iteration, so a
  waveform cannot be followed sample by sample);
* ``gl_sc_excess``, in a cell whose served waveforms do not separate the
  program from its control: the served Griffin-Lim stage held by itself
  (the ``Synthesizer``'s own ``_gl`` at the window's batch and largest
  length) on a speech-like spectrogram, against the reference's
  Griffin-Lim, by the same measure.

Training cells, over the steps the reference follows:

* ``loss_gap``: the relative difference of the first step's loss (the
  later steps' gaps carry the first updates' rounding forward and swing
  from seed to seed: they are printed beside it by ``controls.py``);
* ``grad_gap``: the first gradient as the optimizer got it, by the worst
  leaf: the gap between the two norms of a leaf over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``update_gap``: the same for each leaf's change over the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (their change is round-off under Adam).
"""

from __future__ import annotations

import math


def judge(numbers: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """-> (correct, [(name, number, limit)] in the limits' order)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        rows.append((name, value, limit))
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, rows


def worst(samples: list[dict]) -> dict:
    """The largest of each number over the samples."""
    out: dict = {}
    for s in samples:
        for k, v in s.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def norm_gaps(prog: dict, ref: dict, keep=None) -> float:
    """Worst leaf of |‖prog‖ - ‖ref‖| / max(‖ref leaf‖, ‖median ref leaf‖)
    over ``keep`` (all leaves by default); inputs are {name: norm}."""
    names = sorted(ref if keep is None else keep)
    norms = sorted(ref[k] for k in names)
    median = norms[len(norms) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names)
