"""K1 and K2, the attention energy and its gradient (ops/attn_energy.py ->
csrc/attn_energy.cu), in the profiled training steps: the bytes each
launch needs at least, over the memory rate, summed over the launches the
steps' graph holds (its nodes of each kernel), over the kernels' device
time (a launch the profiler dropped counted at the recorded ones' mean),
in percent."""

from benchmark.counts.flops import attn_energy_bytes, speed_of_light
from benchmark.trace import per_launch_seconds

LAYER = "attention energy K1/K2"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(trace):
    if not trace.info:
        return None
    i = trace.info[0]
    m = i["model"]
    elt = 2 if m["compute_dtype"] == "bfloat16" else 4
    total_bound, total_s = 0.0, 0.0
    for part, backward in (("energy_fwd", False), ("energy_bwd", True)):
        n = i["energy_nodes"][part] * len(trace.info)
        s = per_launch_seconds(trace, n, part)
        if s is None:
            return None
        total_bound += n * speed_of_light(0.0, attn_energy_bytes(i["b"], i["t_in"], m["attention_dim"],
                                                                  elt, backward))
        total_s += s
    return 100.0 * total_bound / total_s
