"""Tacotron 2's step decode (infer/early_exit.py WhileDecode, the chunk
graph's replays): their device time, found as ``step_decode_ms_per_call``
finds it, over the steps the loop ran before its exit (the program's
counter ``decode_steps``, one a profiled call), in microseconds a step.
Nothing is read where the program keeps no such counter."""

from benchmark import harness
from benchmark.records import profiled

LAYER = "step decode"
UNIT = "us"
MOVES = "audio_s_per_s"


def decode(trace) -> tuple[float, list[int]] | None:
    """-> (device seconds of the profiled calls' chunk replays, the steps
    each call's loop ran), or None."""
    ms = harness.reader("step_decode_ms_per_call").read(trace)
    recs = profiled(trace)
    if ms is None or recs is None:
        return None
    steps = [r.get("counters", {}).get("decode_steps") for r in recs]
    if any(s is None for s in steps) or sum(steps) <= 0:
        return None
    return ms * 1e-3 * len(recs), steps


def read(trace):
    got = decode(trace)
    if got is None:
        return None
    seconds, steps = got
    return seconds * 1e6 / sum(steps)
