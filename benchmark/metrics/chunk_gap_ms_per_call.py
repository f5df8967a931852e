"""The early-exit decode's exit-flag reads (infer/early_exit.py
run_until_done): device milliseconds per profiled call between the end of
one chunk replay and the start of the next, from the preamble to the first
chunk and from the last chunk to the post-net, by the stage clock's host
marks around each chunk replay."""

from benchmark.records import mean_ms

LAYER = "step decode"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(trace):
    return mean_ms(trace, lambda r: r.get("chunk_gap_ms"))
