"""Whole call: the frozen operation count of each profiled call (encoder,
decoder steps, post-net, Griffin-Lim, final inverse transform) over the
wall time of such a call untraced (the mean latency of the same run's
untraced calls of its shape; the profiler lengthens the calls it traces),
against the chip's bf16 peak, in percent."""

from benchmark.counts.flops import H100_BF16_FLOPS

LAYER = "synthesis call"
UNIT = "%"
MOVES = "audio_s_per_s"


def read(trace):
    if not trace.info or any("wall_s" not in i for i in trace.info):
        return None
    ops = sum(i["flops"] for i in trace.info)
    return 100.0 * ops / sum(i["wall_s"] for i in trace.info) / H100_BF16_FLOPS
