"""The post-net (models/postnet.py) and the end frames, over the full mel
buffer: device milliseconds per profiled call between the stage clock's
marks around them, inside the graph that runs them."""

from benchmark.records import mean_ms, stage

LAYER = "post-net"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(trace):
    return mean_ms(trace, stage("postnet"))
