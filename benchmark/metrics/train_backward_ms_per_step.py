"""The training step's backward (and the gradients' all-reduce on a mesh):
device milliseconds per profiled step between the stage clock's event
nodes inside the step's graph."""

from benchmark.records import mean_ms, stage

LAYER = "train model"
UNIT = "ms"
MOVES = "train_frames_per_s"


def read(trace):
    return mean_ms(trace, stage("backward"))
