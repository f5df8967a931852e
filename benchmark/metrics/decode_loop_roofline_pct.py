"""K3, the fused decode (ops/decode_loop.py -> csrc/decode_loop.cu): the
least time the chip could take for each profiled call's decoder steps (the
frozen count; its weights, memory and keys once in bf16 storage) over the
kernel's device time, in percent of that roofline."""

from benchmark.counts.flops import decode_loop_bytes, decode_step_flops, speed_of_light
from benchmark.trace import per_launch_seconds

LAYER = "fused decode K3"
UNIT = "%"
MOVES = "audio_s_per_s"


def read(trace):
    calls = [i for i in trace.info if i.get("fused")]
    if not calls:
        return None
    bound = 0.0
    for i in calls:
        m = i["model"]
        ops = i["n_steps"] * decode_step_flops(
            i["b"], i["t_in"], n_mels=m["n_mels"], r=m["r"], prenet=tuple(m["prenet_dims"]),
            att_gru=m["attention_gru_dim"], att_dim=m["attention_dim"], mem_dim=2 * m["gru_dim"],
            dec_dim=m["decoder_gru_dim"])
        bound += speed_of_light(ops, decode_loop_bytes(m, i["b"], i["t_in"], i["n_steps"], 2))
    seconds = per_launch_seconds(trace, len(calls), "decode_loop")
    return None if seconds is None else 100.0 * bound / seconds
