"""Where a step of the step decode's kernel (csrc/decode_chunk.cu) spends its
time. Needs one NVIDIA H100 (sm_90a) and nvcc:

    python3 scripts/decode_chunk_study.py [--clusters 8 4] [--variants ...]
        [--out decode_chunk_study.json]

Builds ``tacotron_tpu_torch/csrc/decode_chunk.cu`` as it is, with
``-DTT_CHUNK_PHASE_CLOCK``, and as the variants named (``VARIANTS``: source
edits), and runs each at [fast]'s shapes (synth_fast with seeded random
weights, B 8, the 8 prompts' encoder outputs, prenet dropout 0.5): the 63
chunks of 8 steps of a 500-step early-exit decode that never exits, as
``WhileDecode`` launches them. Prints each build's registers and spills,
its device time per step (CUDA events around the 63 launches, the mask
draws made before), the largest difference of its frames from the
committed build's, and from the phase clock the SM cycles that block 0
(row 0, rank 0) spends in each of the 14 phases of a step, the wait at
the phase's barrier included, and of that the staging of its inputs and
the wait at the barrier (from block 0's arrival), as microseconds per step,
with block 0's clock rate over the run.
"""
import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from tacotron_tpu_torch import runtime  # noqa: E402
from tacotron_tpu_torch.config import get_config  # noqa: E402
from tacotron_tpu_torch.data.vocab import Vocab  # noqa: E402
from tacotron_tpu_torch.infer.early_exit import DECODE_CHUNK, WhileDecode  # noqa: E402
from tacotron_tpu_torch.infer.synthesize import Synthesizer  # noqa: E402
from tacotron_tpu_torch.models.tacotron import length_mask  # noqa: E402
from tacotron_tpu_torch.ops.decode_loop import pack_decoder_weights  # noqa: E402
from tacotron_tpu_torch.weights import split_state  # noqa: E402

PHASES = ("prenet 0", "prenet 1", "attention GRU gates", "attention GRU candidate", "query",
          "energy", "softmax", "context", "input projection", "decoder GRU 0 gates",
          "decoder GRU 0 candidate", "decoder GRU 1 gates", "decoder GRU 1 candidate",
          "frame projection")
# name -> (source edits (old, new, times it occurs), extra nvcc flags)
CLOCK = ["-DTT_CHUNK_PHASE_CLOCK"]
VARIANTS = {
    "phase_clock": ([], CLOCK),
    # the weights' loads left out (zeros): the floor of the step's structure
    "no_weight_loads": ([("? __ldg(reinterpret_cast<const float4*>(W + (size_t)o * K + i)) : zero4()",
                          "? zero4() : zero4()", 1)], CLOCK),
    # each push stored into the block's own copy only (wrong results: timing)
    "local_push": ([("if (lane < C) peer[(buf - smem) + i] = v;",
                     "if (lane == 0) smem[(buf - smem) + i] = v;", 1)], CLOCK),
    # the softmax's exp and division in their fast forms, no alignment store
    "fast_softmax": ([("const float e = expf(sc[t] - mx);", "const float e = __expf(sc[t] - mx);", 1),
                      ("const float a = sc[t] / sum;", "const float a = __fdividef(sc[t], sum);", 1),
                      ("if (rank == 0 && write) ao[t] = a;", "", 1)], CLOCK),
    "t256": ([("constexpr int kThreads = 512;", "constexpr int kThreads = 256;", 1)], []),
    "u2": ([("constexpr int kU = 4;", "constexpr int kU = 2;", 1)], []),
}


def build(names):
    src = (runtime.CSRC_DIR / "decode_chunk.cu").read_text()
    out_dir = runtime.BUILD_DIR / "decode_chunk_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        edits, flags = VARIANTS[name]
        text = src
        for old, new, times in edits:
            if text.count(old) != times:
                raise RuntimeError(f"{name}: {old!r} is not {times}x in decode_chunk.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, *flags, "-I", str(runtime.CSRC_DIR),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    committed = runtime.build(("decode_chunk",))["decode_chunk"]
    logs, libs = {"committed": committed.with_suffix(".log").read_text()}, {"committed": committed}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
        logs[name], libs[name] = log, so
    return logs, libs


def fast_inputs(dev):
    """[fast]'s: the prompts through the encoder of synth_fast with seed-0
    weights."""
    cfg = get_config("synth_fast")
    vocab = Vocab.build(cs.PROMPTS)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    p, bs = split_state(cs.full_model(cfg, dev))
    synth = Synthesizer(cfg, p, bs, vocab)
    text, lengths = synth.encode_texts(cs.PROMPTS)
    with torch.no_grad():
        memory = synth.model.encoder(text, lengths, torch.Generator(device=dev).manual_seed(0))
        keys = synth.model.memory_proj(memory)
    return (memory, keys, length_mask(text.shape[1], lengths),
            pack_decoder_weights(synth.model.decoder.cell), cfg.model)


def decode(lib_path, inputs, cluster, reps=3):
    """The 63 chunks through the library at ``lib_path`` -> (ms per step of
    each rep, the frames of the last)."""
    memory, keys, mask, w, mcfg = inputs
    dev = memory.device
    runtime._LIBS["decode_chunk"] = ctypes.CDLL(str(lib_path))
    n = mcfg.max_decode_steps
    chunks = -(-n // DECODE_CHUNK)
    ms = []
    with torch.no_grad():
        for _ in range(reps):
            loop = WhileDecode(memory, keys, mask, w, torch.Generator(device=dev).manual_seed(1),
                               n_steps=n, r=mcfg.r, n_mels=mcfg.n_mels,
                               dropout_rate=mcfg.prenet_dropout, silence_threshold=-1.0)
            loop._launch._cluster = cluster
            masks = [loop.draw_masks() for _ in range(chunks)]
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for m in masks:
                loop._launch.launch(m, DECODE_CHUNK)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1) / (chunks * DECODE_CHUNK))
    return ms, loop.frames.clone()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", type=int, nargs="+", default=[8])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_chunk_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    print(f"card: {card}", flush=True)
    logs, libs = build(["phase_clock", *[v for v in args.variants if v != "phase_clock"]])
    report = {"card": card, "ptxas": {}, "runs": {}}
    for name, log in logs.items():
        rows = [k for k in cs.ptxas_report(log) if "decode_chunk_kernel" in k["kernel"]]
        report["ptxas"][name] = rows
        for k in rows:
            print(f"ptxas {name}: {k.get('registers')} registers, {k.get('spill_stores')} / "
                  f"{k.get('spill_loads')} bytes spill stores / loads", flush=True)
    dev = torch.device("cuda")
    inputs = fast_inputs(dev)
    print(f"B {inputs[0].shape[0]}, T_in {inputs[0].shape[1]}, {inputs[4].max_decode_steps} "
          f"steps in chunks of {DECODE_CHUNK}", flush=True)
    for c in args.clusters:
        ms, ref = decode(libs["committed"], inputs, c)
        runs = report["runs"][c] = {"committed": {"us_per_step": [1e3 * x for x in ms]}}
        print(f"C {c} committed: {[round(1e3 * x, 2) for x in ms]} us a step", flush=True)
        for name in libs:
            if name == "committed":
                continue
            lib = ctypes.CDLL(str(libs[name]))
            clocked = CLOCK[0] in VARIANTS.get(name, ((), ()))[1]
            if clocked:
                runtime.check(lib.tt_decode_chunk_phase_reset(), "phase clock reset")
            ms, frames = decode(libs[name], inputs, c, reps=1)
            run = runs[name] = {"us_per_step": [1e3 * x for x in ms],
                                "max_abs_diff": float((frames - ref).abs().max())}
            line = f"C {c} {name}: {[round(1e3 * x, 2) for x in ms]} us a step, frames apart " \
                   f"by {run['max_abs_diff']:.3e}"
            if clocked:
                n_p = len(PHASES)
                cyc = (ctypes.c_ulonglong * (3 * n_p))()
                runtime.check(lib.tt_decode_chunk_phase_cycles(cyc), "phase clock read")
                total = sum(cyc[:n_p])
                us = [1e3 * ms[0] * c_ / total for c_ in cyc]
                steps = -(-inputs[4].max_decode_steps // DECODE_CHUNK) * DECODE_CHUNK
                run["sm_mhz"] = total / (steps * 1e3 * ms[0])
                run["phase_us_per_step"] = dict(zip(PHASES, us))
                run["barrier_wait_us_per_step"] = dict(zip(PHASES, us[n_p:2 * n_p]))
                run["staging_us_per_step"] = dict(zip(PHASES, us[2 * n_p:]))
                line += f" (block 0's clock {run['sm_mhz']:.0f} MHz)\n  " + "\n  ".join(
                    f"{p:26s} {v:7.2f} us: staging {st:5.2f}, waiting at its barrier {wt:5.2f}"
                    for p, v, wt, st in zip(PHASES, us, us[n_p:2 * n_p], us[2 * n_p:]))
            print(line, flush=True)
    runtime._LIBS.pop("decode_chunk", None)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
