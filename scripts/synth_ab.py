"""Time the [main] and [main-bf16] synthesis calls of one checkout of the
port, to compare two checkouts on one card, in turns in one run. Needs
one NVIDIA GPU:

    python3 scripts/synth_ab.py --tree PATH [--calls 3] [--out FILE]
                                [--decode-rows 8 72] [--energy] [--probe]

Imports ``tacotron_tpu_torch`` and ``chip_smoke`` from ``--tree`` (a
checkout's root; this one by default), builds its kernels, and runs
``Synthesizer(fused=True)`` at synth_gl1000 as chip_smoke.py [main] does
(seeded random weights, the 8 prompts, 500 steps; GL 1000 iterations) and
then with compute_dtype="bfloat16" at GL 100 ([main-bf16]): one warm call
and ``--calls`` timed calls each. Prints one JSON line: each timed call's
wall seconds, audio-seconds per second and stage milliseconds. Run it for
two trees in turns (A, B, B, A) to compare them.

With ``--decode-rows``, it times the fused decode (K3) alone instead, at
[main]'s shapes (bf16 storage, dropout 0.5, 500 steps) with the 8 prompts
repeated to each given number of rows: ``decode_loop`` as a user calls it
and, where the tree's launch takes a ``_cluster`` pin, pinned to a cluster
of one block per row; device milliseconds by CUDA events over ``--calls``
calls after a warm one.

With ``--energy``, it times the attention-energy kernels alone instead: K1
(``energy_fwd``) and K2 (``energy_bwd``) at the training path's shapes (B
32, T_in 128, A 256; chip_smoke.py's seeded random inputs), keys and q in
f32 and in bf16; each one's device microseconds per call by torch.profiler
over 200 calls, ``--calls`` times, and the device kernels per call; where
the tree's ``energy_bwd`` takes a ``_cluster`` pin, K2 at each cluster size
too.

With ``--probe``, it times the ops probe (P2, ``probe.probe_ops``) alone
instead, on chip_smoke.py [timing]'s all-ones operands: device microseconds
per call by torch.profiler over 200 calls, ``--calls`` times, and the
device kernels per call; where the tree's ``probe_empty`` takes
``smem_bytes``, the floor (an empty kernel on the same cluster, threads and
shared memory).
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", help="also append the JSON line to this file")
    ap.add_argument("--decode-rows", type=int, nargs="+",
                    help="time the fused decode alone at these batch sizes")
    ap.add_argument("--energy", action="store_true",
                    help="time the attention-energy kernels alone")
    ap.add_argument("--probe", action="store_true", help="time the ops probe (P2) alone")
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("synth_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.weights import split_state
    if not runtime.__file__.startswith(tree):
        raise RuntimeError(f"imported {runtime.__file__}, not from {tree}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    runtime.build()
    vocab = Vocab.build(cs.PROMPTS)
    base = get_config("synth_gl1000")
    base = dataclasses.replace(base, model=dataclasses.replace(base.model,
                                                               vocab_size=len(vocab)))
    result = {"tree": tree, "card": cs.smi(), "paths": {}}
    if args.decode_rows:
        result["decode"] = time_decode(cs, base, vocab, args.decode_rows, args.calls)
    if args.energy:
        result["energy"] = time_energy(cs, args.calls)
    if args.probe:
        result["probe"] = time_probe(cs, args.calls)
    for name, dtype, gl_iters in (() if args.decode_rows or args.energy or args.probe else
                                  (("main", "float32", None), ("main-bf16", "bfloat16", 100))):
        cfg = base.replace(model=dataclasses.replace(base.model, compute_dtype=dtype))
        p, bs = split_state(cs.full_model(cfg, torch.device("cuda")))
        synth = Synthesizer(cfg, p, bs, vocab, fused=True)
        kw = {} if gl_iters is None else {"gl_iters": gl_iters}
        synth(cs.PROMPTS, seed=0, **kw)
        calls = []
        for i in range(args.calls):
            t0 = time.perf_counter()
            out = synth(cs.PROMPTS, seed=1 + i, stage_ms=True, **kw)
            wall = time.perf_counter() - t0
            calls.append({"wall_s": wall, "audio_seconds_per_s": out["audio_seconds"] / wall,
                          "stage_ms": out["stage_ms"]})
        result["paths"][name] = calls
        del synth
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


def time_decode(cs, cfg, vocab, rows, calls):
    """{rows: {"ms": decode_loop's ms, "cluster_1_ms": pinned to one block
    per row or None, "cluster": the launch's cluster size or None}}."""
    import inspect

    import torch
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.models.tacotron import length_mask
    from tacotron_tpu_torch.ops import decode_loop as dl
    from tacotron_tpu_torch.weights import split_state

    dev = torch.device("cuda")
    p, bs = split_state(cs.full_model(cfg, dev))
    synth = Synthesizer(cfg, p, bs, vocab, fused=True)
    w = dl.pack_decoder_weights(synth.model.decoder.cell)
    kw = dict(n_steps=cfg.model.max_decode_steps, dropout_rate=cfg.model.prenet_dropout)
    pinned = "_cluster" in inspect.signature(dl._decode_loop_cuda).parameters
    out = {}
    for b in rows:
        text, lengths = synth.encode_texts((cs.PROMPTS * -(-b // len(cs.PROMPTS)))[:b])
        mask = length_mask(text.shape[1], lengths)
        with torch.no_grad():
            memory = synth.model.encoder(text, lengths, torch.Generator(device=dev).manual_seed(0))
            keys = synth.model.memory_proj(memory)
            run = lambda: dl.decode_loop(memory, keys, mask, w, seed=5, **kw)  # noqa: E731
            run()
            row = {"ms": cs.cuda_ms(run, reps=calls), "cluster_1_ms": None, "cluster": None}
            if pinned:
                one = lambda: dl._decode_loop_cuda(  # noqa: E731
                    memory, keys, mask, w, seed=5, dropout=True, lowp=True,
                    return_keep_counts=False, _cluster=1, **kw)
                one()
                row["cluster_1_ms"] = cs.cuda_ms(one, reps=calls)
                row["cluster"] = dl.cluster_plan(memory, keys, w)[0]
        out[b] = row
    return out


def time_energy(cs, calls, reps=200):
    """{dtype: {"fwd_us": [...], "bwd_us": [...], "fwd_kernels": n,
    "bwd_kernels": n, "bwd_C_us": [...] for each pinned cluster size C}}:
    device microseconds per call, ``calls`` times: the sum over the call's
    kernels (each launched once a call) of each one's time per launch that
    the profiler recorded; n, the launches it recorded per call."""
    import functools
    import inspect

    import torch
    from tacotron_tpu_torch.ops.attn_energy import energy_bwd, energy_fwd

    keys, q, v, de = cs.energy_inputs(torch.device("cuda"), 32, 128, 256)
    pinned = "_cluster" in inspect.signature(energy_bwd).parameters
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        k, qq = keys.to(dtype), q.to(dtype)
        row = {}
        fns = [("fwd", functools.partial(energy_fwd, k, qq, v)),
               ("bwd", functools.partial(energy_bwd, k, qq, v, de))]
        fns += [(f"bwd_{c}", functools.partial(energy_bwd, k, qq, v, de, _cluster=c))
                for c in ((1, 2, 4, 8) if pinned else ())]
        for name, fn in fns:
            fn()
            us = []
            for _ in range(calls):
                kern = cs.device_kernels(fn, reps)
                # each kernel launches once a call: its time per recorded launch
                us.append(sum(ms / n for ms, n in kern.values()) * 1e3)
            row[f"{name}_us"] = us
            row[f"{name}_kernels"] = sum(n for _, n in kern.values())
        out[str(dtype).split(".")[-1]] = row
    return out


def time_probe(cs, calls, reps=200):
    """{"ops_us": [...], "ops_kernels": n, "floor_us": [...]}: device microseconds per
    call, ``calls`` times (each one's time per launch the profiler
    recorded), and the launches it recorded per call."""
    import functools
    import inspect

    import torch
    from tacotron_tpu_torch import probe

    dev = torch.device("cuda")
    inputs = probe.ops_inputs(dev)
    fns = [("ops", functools.partial(probe.probe_ops, *inputs))]
    if "smem_bytes" in inspect.signature(probe.probe_empty).parameters:
        plan = probe.ops_plan()
        fns.append(("floor", functools.partial(probe.probe_empty, plan.cluster, plan.threads,
                                               plan.cluster, dev, plan.smem_bytes)))
    out = {}
    for name, fn in fns:
        fn()
        us = []
        for _ in range(calls):
            kern = cs.device_kernels(fn, reps)
            us.append(sum(ms / n for ms, n in kern.values()) * 1e3)
        out[f"{name}_us"] = us
        out[f"{name}_kernels"] = sum(n for _, n in kern.values())
    return out


if __name__ == "__main__":
    sys.exit(main())
