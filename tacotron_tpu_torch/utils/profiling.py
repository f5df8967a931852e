"""Tracing hooks on ``torch.profiler``.

The port's counterpart of the JAX package's ``utils/profiling.py`` as far
as the synthesis CLI's ``--trace-dir`` needs it; the rest of that module is
not ported yet (``ROADMAP.md`` Queue 1, item 8).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the host and, where there is a card, the device,
    and write it into ``log_dir`` when the block ends (a Chrome trace,
    ``*.pt.trace.json``, viewable in TensorBoard's profiler or Perfetto).
    Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
