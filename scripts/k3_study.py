"""Where a step of the fused decode (K3) spends its time, and what sets its
registers. Needs one NVIDIA H100 (sm_90a) and nvcc:

    python3 scripts/k3_study.py [--clusters 1 2 4 8 16] [--out k3_study.json]

1. Registers: builds ``tacotron_tpu_torch/csrc/decode_loop.cu`` as it is
   and with ``__launch_bounds__(kThreads)`` in place of ``(kThreads, 1)``
   (no minimum of one resident block per SM), and prints each kernel's
   registers and spills from ``-Xptxas -v``.
2. Phases: builds it with ``-DTT_DECODE_PHASE_CLOCK`` and runs the decode
   at chip_smoke.py [timing]'s shapes (synth_gl1000 with seeded random
   weights, the 8 prompts, 500 steps, bf16, dropout 0.5) at each cluster
   size. Prints the SM cycles that block 0 (row 0, rank 0) spends in each
   of the 14 phases of a step, the wait at the phase's cluster barrier
   included, as a share and as microseconds per step (the share times the
   instrumented build's time per step, by CUDA events), beside the time per
   step of the build without the clock.
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
from tacotron_tpu_torch.infer.synthesize import Synthesizer  # noqa: E402
from tacotron_tpu_torch.models.tacotron import length_mask  # noqa: E402
from tacotron_tpu_torch.ops.decode_loop import (CLUSTER_SIZES, _decode_loop_cuda,  # noqa: E402
                                                cluster_plan, pack_decoder_weights)
from tacotron_tpu_torch.weights import split_state  # noqa: E402

PHASES = ("prenet 0", "prenet 1", "attention GRU gates", "attention GRU candidate", "query",
          "energy", "softmax", "context", "input projection", "decoder GRU 0 gates",
          "decoder GRU 0 candidate", "decoder GRU 1 gates", "decoder GRU 1 candidate",
          "frame projection")
BOUNDS = ("__launch_bounds__(kThreads, 1)\ndecode_loop_kernel",
          "__launch_bounds__(kThreads)\ndecode_loop_kernel")
# name -> (source edits, extra nvcc flags)
VARIANTS = {"phase_clock": ([], ["-DTT_DECODE_PHASE_CLOCK"]),
            "no_min_blocks": ([BOUNDS], [])}


def build_variants():
    src = (runtime.CSRC_DIR / "decode_loop.cu").read_text()
    out_dir = runtime.BUILD_DIR / "k3_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, flags) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in decode_loop.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, *flags, "-I", str(runtime.CSRC_DIR),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    committed = runtime.build(("decode_loop",))["decode_loop"]
    logs, libs = {"committed": committed.with_suffix(".log").read_text()}, {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
        logs[name], libs[name] = log, so
    return logs, libs


def main_inputs(dev):
    """[timing]'s: the prompts through the encoder of synth_gl1000 with
    seed-0 weights."""
    cfg = get_config("synth_gl1000")
    vocab = Vocab.build(cs.PROMPTS)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    p, bs = split_state(cs.full_model(cfg, dev))
    synth = Synthesizer(cfg, p, bs, vocab, fused=True)
    text, lengths = synth.encode_texts(cs.PROMPTS)
    with torch.no_grad():
        memory = synth.model.encoder(text, lengths, torch.Generator(device=dev).manual_seed(0))
        keys = synth.model.memory_proj(memory)
    return (memory, keys, length_mask(text.shape[1], lengths),
            pack_decoder_weights(synth.model.decoder.cell), cfg.model)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", type=int, nargs="+", default=list(CLUSTER_SIZES))
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_study: no CUDA device", file=sys.stderr)
        return 2
    card = cs.smi()
    print(f"card: {card}", flush=True)
    logs, libs = build_variants()
    report = {"card": card, "ptxas": {}, "phases": {}}
    for name, log in logs.items():
        rows = [k for k in cs.ptxas_report(log) if "decode_loop_kernel" in k["kernel"]]
        report["ptxas"][name] = rows
        for k in rows:
            print(f"ptxas {name}: {k['kernel']}: {k.get('registers')} registers, "
                  f"{k.get('spill_stores')} / {k.get('spill_loads')} bytes spill stores / loads",
                  flush=True)

    dev = torch.device("cuda")
    memory, keys, mask, w, mcfg = main_inputs(dev)
    n = mcfg.max_decode_steps
    chosen, resident = cluster_plan(memory, keys, w)
    print(f"B {memory.shape[0]}, T_in {memory.shape[1]}, {n} steps, bf16; chosen cluster "
          f"{chosen}; resident clusters {resident}", flush=True)
    clock = ctypes.CDLL(str(libs["phase_clock"]))
    clock.tt_decode_loop_phase_cycles.argtypes = [ctypes.c_void_p]
    committed = runtime.load("decode_loop")
    for c in args.clusters:
        def run():
            _decode_loop_cuda(memory, keys, mask, w, n_steps=n, seed=5, dropout=True,
                              dropout_rate=mcfg.prenet_dropout, lowp=True,
                              return_keep_counts=False, _cluster=c)
        with torch.no_grad():
            runtime._LIBS["decode_loop"] = committed
            run()
            plain_ms = cs.cuda_ms(run, reps=3)
            runtime._LIBS["decode_loop"] = clock
            try:
                run()
                clock_ms = cs.cuda_ms(run)
                cycles = (ctypes.c_ulonglong * len(PHASES))()
                runtime.check(clock.tt_decode_loop_phase_cycles(cycles), "phase cycles")
            finally:
                runtime._LIBS["decode_loop"] = committed
        total = sum(cycles)
        us_step = clock_ms / n * 1e3
        rows = {ph: {"share": cy / total, "us_per_step": cy / total * us_step}
                for ph, cy in zip(PHASES, cycles)}
        report["phases"][c] = {"resident": resident[c], "ms": plain_ms,
                               "us_per_step": plain_ms / n * 1e3, "clock_build_ms": clock_ms,
                               "clock_build_us_per_step": us_step, "cycles_per_step": total / n,
                               "by_phase": rows}
        print(f"cluster {c:2d} ({resident[c]} resident): {plain_ms:.3f} ms, "
              f"{plain_ms / n * 1e3:.2f} us per step; with the phase clock {clock_ms:.3f} ms, "
              f"{total / n:.0f} cycles per step", flush=True)
        for ph, r in rows.items():
            print(f"    {ph:24s} {100 * r['share']:5.1f}%  {r['us_per_step']:6.2f} us", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
