"""The final inverse transform and inverse pre-emphasis (dsp/audio.py
spectrum_to_wav) and the scaling to the peak: device milliseconds per
profiled call between the stage clock's marks around them."""

from benchmark.records import mean_ms, stage

LAYER = "final"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(trace):
    return mean_ms(trace, stage("istft_inv_preemphasis"))
