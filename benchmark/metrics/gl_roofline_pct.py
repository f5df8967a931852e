"""K4, the Griffin-Lim kernel (dsp/fused_gl.py -> csrc/griffin_lim.cu): the
least time the chip could take for each profiled call's iterations (the
frozen count over the window's own samples, and the bytes at least) over
the device time of its launches (``gl_wgmma``, ``gl_ola_frame``), in
percent of that roofline."""

from benchmark.counts.flops import gl_call_bytes, gl_iteration_flops_exact, speed_of_light
from benchmark.trace import per_launch_seconds

LAYER = "Griffin-Lim K4"
UNIT = "%"
MOVES = "audio_s_per_s"
LAUNCHES_PER_ITERATION = 3      # synthesis product, overlap-add and framing, analysis product


def read(trace):
    if not trace.info:
        return None
    bound, launches = 0.0, 0
    for i in trace.info:
        a = i["audio"]
        bound += speed_of_light(
            i["gl_iters"] * gl_iteration_flops_exact(i["b"], i["t_gl"], a["n_fft"], a["win_length"]),
            gl_call_bytes(i["b"], i["t_gl"], a["n_fft"], a["win_length"], bf16=True))
        launches += LAUNCHES_PER_ITERATION * i["gl_iters"]
    seconds = per_launch_seconds(trace, launches, "gl_wgmma", "gl_ola_frame")
    return None if seconds is None else 100.0 * bound / seconds
