"""The Synthesizer's outputs reaching the host (infer/synthesize.py, the
``.cpu()`` of mel, linear, alignments, end frames and wavs): device time of
the device-to-host copies per profiled call, in milliseconds."""

LAYER = "outputs to host"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(trace):
    if not trace.info:
        return None
    dev = [e for e in trace.in_spans(trace.device) if e.kind == "memcpy" and "DtoH" in e.name]
    return sum(e.end - e.start for e in dev) * 1e-3 / len(trace.info)
