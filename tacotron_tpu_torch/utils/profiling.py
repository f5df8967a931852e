"""Tracing hooks on ``torch.profiler``.

The port's counterpart of the JAX package's ``utils/profiling.py`` as far
as the CLIs need it: ``trace`` around a block (the synthesis CLI's
``--trace-dir``), ``start_trace`` / ``stop_trace`` around a window of
training steps (the training CLI's ``--trace-steps``). The rest of that
module is not ported yet (``ROADMAP.md`` Queue 1, item 8).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


def start_trace(log_dir: str) -> profile:
    """Start capturing the host and, where there is a card, the device; the
    trace is written into ``log_dir`` by ``stop_trace`` (a Chrome trace,
    ``*.pt.trace.json``, viewable in TensorBoard's profiler or Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def stop_trace(prof: profile) -> None:
    """Wait for the device's queued work, then stop and write the trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: str):
    """``start_trace`` / ``stop_trace`` around a block; yields the profiler."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace(prof)
