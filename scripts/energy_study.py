"""What sets the attention-energy kernels' time (K1 ``energy_fwd``, K2
``energy_bwd``, ``tacotron_tpu_torch/csrc/attn_energy.cu``) at the training
path's shapes. Needs one NVIDIA H100 (sm_90a) and nvcc:

    python3 scripts/energy_study.py [--out energy_study.jsonl]

Builds the source as it is and variants of it (one nvcc each, started
together), each one's registers and spills from ``-Xptxas -v``; then, for
each build, keys and q in f32 and in bf16 at B 32, T_in 128, A 256
(chip_smoke.py's seeded random inputs): K1's and K2's device microseconds
per call by torch.profiler over 200 calls, K2 at each cluster size, and the
largest error of e, dkeys, dq and dv against the plain versions over each
one's peak. Variants:

- ``fwd_rows_1``, ``fwd_rows_4``: K1 with 1 or 4 rows per warp in bf16
  (2 as built), ``fwd_rows_2_f32`` with 2 in f32 (1 as built);
- ``bwd_warps_16``: K2 blocks of 16 warps (8 as built);
- ``approx_tanh``: ``tanh.approx.f32`` in place of ``tanhf`` (wrong in
  bf16 by design: how much of the time the accurate tanh takes);
- ``bwd_batch_1``, ``bwd_batch_4``: K2 issuing 1 or 4 rows' loads at a
  time (2 as built; 4 takes 128 registers, 2 blocks an SM, and so fewer
  resident clusters);
- ``no_dv``: K2 without the ticket and the last cluster's dv sum (dv
  wrong: what the cross-cluster step costs);
- ``phase_clock``: built with ``-DTT_ENERGY_PHASE_CLOCK``, K2 records
  %globaltimer at 8 marks per block; printed, for K2 at its plan's cluster
  size: the spread of the blocks' starts, and per phase the mean and the
  largest nanoseconds over the blocks (the marks: start, rows done, warp
  sums pushed to rank 0, the cluster barrier, rank 0's sums over the
  ranks, the chunk's end, the ticket, the last cluster's dv sum), and the
  span from the first start to the last mark.

Also prints, for each build, K2's resident clusters of each size (the
occupancy calculator).
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from tacotron_tpu_torch import runtime  # noqa: E402
from tacotron_tpu_torch.ops import attn_energy as ae  # noqa: E402

APPROX = ('#include "common.cuh"\n',
          '#include "common.cuh"\n__device__ __forceinline__ float approx_tanh(float x) {\n'
          '  float y;\n  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;\n}\n')
ROWS = "constexpr int kFwdRows = sizeof(S) == 2 ? 2 : 1;"
BATCH = "constexpr int kBwdBatch = 2;"
# name -> (source edits, each of which must occur once; extra nvcc flags)
VARIANTS = {
    "fwd_rows_1": ([(ROWS, ROWS.replace("? 2", "? 1"))], []),
    "fwd_rows_4": ([(ROWS, ROWS.replace("? 2", "? 4"))], []),
    "fwd_rows_2_f32": ([(ROWS, ROWS.replace(": 1;", ": 2;"))], []),
    "approx_tanh": ([APPROX,
                     ("make_float2(tanhf(k.x + q.x), tanhf(k.y + q.y))",
                      "make_float2(approx_tanh(k.x + q.x), approx_tanh(k.y + q.y))"),
                     ("make_float2(tanhf(s.x), tanhf(s.y))",
                      "make_float2(approx_tanh(s.x), approx_tanh(s.y))")], []),
    "bwd_batch_1": ([(BATCH, BATCH.replace("2", "1"))], []),
    "bwd_batch_4": ([(BATCH, BATCH.replace("2", "4"))], []),
    "no_dv": ([("  if (rank != 0) return;", "  return;")], []),
    "phase_clock": ([], ["-DTT_ENERGY_PHASE_CLOCK"]),
}
MARKS = ("rows", "push", "barrier", "rank 0 sums", "chunk end", "ticket", "dv sum")


def build_variants():
    src = (runtime.CSRC_DIR / "attn_energy.cu").read_text()
    out_dir = runtime.BUILD_DIR / "energy_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, flags) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in attn_energy.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, *flags, "-I", str(runtime.CSRC_DIR),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    built = runtime.build(("attn_energy",))["attn_energy"]
    logs, libs = {"built": built.with_suffix(".log").read_text()}, {"built": built}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
        logs[name], libs[name] = log, so
    return logs, libs


def use(path):
    """Route the wrapper's launches to the library at ``path``."""
    runtime._LIBS["attn_energy"] = ctypes.CDLL(str(path))
    ae._LIB = None
    ae._lib()


def errors(keys, q, v, de):
    """Max abs error over the peak of e, dkeys, dq, dv against the plain
    versions (f32: autograd through the formula; bf16: energy_bwd_reference)."""
    got = (ae.energy_fwd(keys, q, v), *ae.energy_bwd(keys, q, v, de))
    if keys.dtype == torch.bfloat16:
        want = (ae.attention_energy_reference(keys, q, v),
                *ae.energy_bwd_reference(keys, q, v, de))
    else:
        leaves = [x.clone().requires_grad_(True) for x in (keys, q, v)]
        e = ae.attention_energy_reference(*leaves)
        want = (e, *torch.autograd.grad(e, leaves, de))
    return {n: cs.max_err(g, w) / float(w.detach().float().abs().max())
            for n, g, w in zip(("e", "dkeys", "dq", "dv"), got, want)}


def phase_clock(lib, keys, q, v, de):
    """K2's phase clock of one launch at its plan -> {mark: (mean ns, max
    ns)} over the blocks that reach it, the spread of starts and the span."""
    import numpy as np
    ae.energy_bwd(keys, q, v, de)
    torch.cuda.synchronize()
    raw = np.zeros((1024, 8), np.uint64)
    runtime.check(lib.tt_attn_energy_clock(raw.ctypes.data_as(ctypes.c_void_p)), "clock read")
    blocks = keys.shape[0] * ae.plan_of(keys).cluster
    ns = raw[:blocks].astype(np.int64)
    start = ns[:, 0]
    out = {"start_spread_ns": int(start.max() - start.min())}
    prev = ns[:, 0]
    for k, name in enumerate(MARKS, start=1):
        reached = ns[:, k] >= start            # rank 0 only past barrier 2, one block the dv sum
        d = (ns[:, k] - prev)[reached]
        out[name] = (float(d.mean()), int(d.max()))
        prev = np.where(reached, ns[:, k], prev)
    out["span_ns"] = int(ns[:, 1:].max() - start.min())
    return out


def device_us(fn, reps=200):
    """Device us per call of ``fn``, which launches one kernel: its time per
    launch that the profiler recorded."""
    fn()
    return cs.launch_ms(cs.device_kernels(fn, reps)) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="append one JSON line per build here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("energy_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    print(f"card: {card}", flush=True)
    logs, libs = build_variants()
    keys, q, v, de = cs.energy_inputs(torch.device("cuda"), 32, 128, 256)
    for name, path in libs.items():
        regs = {k["kernel"]: (k.get("registers"), k.get("spill_stores"))
                for k in cs.ptxas_report(logs[name])}
        use(path)
        row = {"build": name, "card": card, "ptxas": regs}
        ae._RESIDENT.clear()
        row["resident"] = {str(bf): ae._resident(keys.device, bf) for bf in (False, True)}
        print(f"{name:13s} K2 resident clusters (f32, bf16): {row['resident']}", flush=True)
        for dtype in (torch.float32, torch.bfloat16):
            k, qq = keys.to(dtype), q.to(dtype)
            d = {"errors": errors(k, qq, v, de),
                 "fwd_us": device_us(lambda: ae.energy_fwd(k, qq, v)),
                 "bwd_us": device_us(lambda: ae.energy_bwd(k, qq, v, de))}
            for c in (1, 2, 4, 8):
                d[f"bwd_{c}_us"] = device_us(lambda: ae.energy_bwd(k, qq, v, de, _cluster=c))
            if name == "phase_clock":
                d["clock"] = phase_clock(runtime._LIBS["attn_energy"], k, qq, v, de)
                print(f"phase_clock   {str(dtype):15s} {d['clock']}", flush=True)
            row[str(dtype).split(".")[-1]] = d
            by_c = " / ".join(f"{d[f'bwd_{c}_us']:.2f}" for c in (1, 2, 4, 8))
            print(f"{name:13s} {str(dtype):15s} K1 {d['fwd_us']:6.2f} us  K2 {d['bwd_us']:6.2f} us"
                  f" (C 1/2/4/8: {by_c})  errors "
                  + ", ".join(f"{n} {x:.1e}" for n, x in d["errors"].items()), flush=True)
        print(f"{name:13s} ptxas {regs}", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
