"""Tacotron 2's step decode against its roofline: the least time the chip
could take for the steps each profiled call's loop ran (``counts/
tacotron2.py``: every weight of a step, the memory and the keys read once a
step in f32; the byte bound at these sizes) over the chunk replays' device
time (``t2_decode_us_per_step``), in percent."""

from benchmark import harness
from benchmark.counts import tacotron2
from benchmark.counts.flops import H100_F32_FLOPS, speed_of_light

LAYER = "step decode"
UNIT = "%"
MOVES = "audio_s_per_s"


def read(trace):
    got = harness.reader("t2_decode_us_per_step").decode(trace)
    if got is None:
        return None
    seconds, steps = got
    bound = 0.0
    for n, info in zip(steps, trace.info):
        m, t2 = info["model"], info["tacotron2"]
        bound += speed_of_light(n * tacotron2.step_flops(m, t2, info["b"], info["t_in"]),
                                tacotron2.decode_bytes(m, t2, info["b"], info["t_in"], n),
                                peak=H100_F32_FLOPS)
    return 100.0 * bound / seconds
