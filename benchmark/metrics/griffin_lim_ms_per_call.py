"""Griffin-Lim (dsp/audio.py gl_spectrum: the magnitude and K4's
iterations; eager on the split path, in the synthesis graph on the fixed
one): device milliseconds per profiled call between the stage clock's
marks around it, so the launch gaps between K4's kernels count."""

from benchmark.records import mean_ms, stage

LAYER = "Griffin-Lim K4"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(trace):
    return mean_ms(trace, stage("griffin_lim"))
