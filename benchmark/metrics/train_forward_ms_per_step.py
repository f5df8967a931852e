"""The training step's teacher-forced forward and losses (train/step.py
_forward_backward_update): device milliseconds per profiled step between
the stage clock's event nodes inside the step's graph."""

from benchmark.records import mean_ms, stage

LAYER = "train model"
UNIT = "ms"
MOVES = "train_frames_per_s"


def read(trace):
    return mean_ms(trace, stage("forward"))
