"""The early-exit decode (infer/early_exit.py WhileDecode): device time of
the kernels that the chunk graph's replays ran, per profiled call, in
milliseconds. A replay's device work carries the correlation id of the
``cudaGraphLaunch`` that started it; in each call the first launch is the
preamble graph's and the last the post-net's, the ones between are chunks.
Each replay runs one device operation per node of the chunk graph; where
the profiler dropped a few (under 1%), the recorded ones' mean stands in
for them, and with more missing the metric is not read."""

LAYER = "step decode"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(trace):
    if not trace.info or any(i.get("fused") for i in trace.info):
        return None
    launches = sorted((e for e in trace.events if e.kind == "runtime" and e.name == "cudaGraphLaunch"),
                      key=lambda e: e.start)
    work = {}
    for e in trace.device:
        work.setdefault(e.corr, []).append(e)
    total = 0.0
    for (a, b), info in zip(sorted(trace.spans), trace.info):
        own = [e for e in launches if a <= e.start < b]
        chunks = own[1:-1]
        per_chunk = info["graph_nodes"].get("chunk")
        if len(own) < 3 or not per_chunk:
            return None
        ops = [k for e in chunks for k in work.get(e.corr, [])]
        expected = per_chunk * len(chunks)
        if not expected * 0.99 <= len(ops) <= expected:
            return None
        total += sum(k.end - k.start for k in ops) / len(ops) * expected
    return total * 1e-3 / len(trace.info)
