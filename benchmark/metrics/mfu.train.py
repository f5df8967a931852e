"""Whole step: three times the frozen forward count of each profiled step
over the time of a step untraced (the same run's untraced steps, issued as
these were; the profiler lengthens the steps it traces), against the
chip's bf16 peak, in percent."""

from benchmark.counts.flops import H100_BF16_FLOPS

LAYER = "training step"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(trace):
    if not trace.info or any("wall_s" not in i for i in trace.info):
        return None
    ops = sum(i["flops"] for i in trace.info)
    return 100.0 * ops / sum(i["wall_s"] for i in trace.info) / H100_BF16_FLOPS
