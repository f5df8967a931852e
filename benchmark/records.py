"""The program's own records of the profiled calls or steps: the port's
stage clock (``tacotron_tpu_torch/utils/profiling.py``) keeps one per
synthesis call or training step while a profiler records, with device
milliseconds per stage read from CUDA events inside and between its CUDA
graphs. Readers of per-layer metrics that the program times itself take
them from here. A program without the stage clock keeps none, and those
readers then read nothing.
"""

from __future__ import annotations

ROOTS = ("tt.synthesize", "tt.train_step")     # each record's root span in the profile


def profiled(trace) -> list | None:
    """The records of the trace's profiled calls or steps, oldest first: the
    last profiled records the program kept, as many as the trace holds root
    spans of the program, which must be one per entry of ``trace.info``.
    None when the program keeps no records or the counts differ."""
    if not trace.info:
        return None
    try:
        from tacotron_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    roots = [e for e in trace.in_spans(trace.events) if e.kind == "cpu" and e.name in ROOTS]
    recs = [r for r in records() if r.get("profiled")]
    if len(roots) != len(trace.info) or len(recs) < len(roots):
        return None
    return recs[len(recs) - len(roots):]


def mean_ms(trace, value) -> float | None:
    """``value(record)`` (ms, or None where the record lacks it) averaged
    over the profiled calls or steps; None when any is missing."""
    recs = profiled(trace)
    if recs is None:
        return None
    values = [value(r) for r in recs]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)


def stage(name: str):
    """``mean_ms``'s ``value`` for a stage's device ms."""
    return lambda r: r.get("stage_ms", {}).get(name)
