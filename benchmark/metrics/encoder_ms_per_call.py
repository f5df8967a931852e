"""The encoder (models/encoder.py, with the keys and mask; on the early-exit
path the whole preamble graph): device milliseconds per profiled call
between the stage clock's marks around it, inside the graph that runs it."""

from benchmark.records import mean_ms, stage

LAYER = "encoder"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(trace):
    return mean_ms(trace, stage("encoder"))
