"""What sets the ops probe's time (P2, ``probe_ops_kernel`` in
``tacotron_tpu_torch/csrc/probe.cu``). Needs one NVIDIA H100 (sm_90a) and
nvcc:

    python3 scripts/probe_study.py [--out probe_study.jsonl]

Builds the source as it is and variants of it (one nvcc each, started
together), each one's registers and spills from ``-Xptxas -v``; then, for
each build, on chip_smoke.py [timing]'s all-ones operands: the kernel's
device microseconds per call by torch.profiler over 200 calls, and the
largest error on seeded normal operands against the plain version over its
peak. Variants:

- ``cluster_8``: a cluster of 8 blocks (16 as built; ``probe.ops_plan(8)``);
- ``rows_8_split_8``: 8 product rows a thread and the contraction split
  over 8 thread groups (4 and 4 as built): 12 shared loads per 128 FMAs
  in place of 8 per 64;
- ``no_product``: the product's loop runs no trip (wrong: what the
  product costs);
- ``phase_clock``, ``phase_clock_8``: built with ``-DTT_PROBE_PHASE_CLOCK``
  (the second at a cluster of 8), the kernel records %globaltimer at 7
  marks per block; printed: the
  spread of the blocks' starts, and per phase the mean and the largest
  nanoseconds over the blocks (the marks: start; operands in shared memory;
  the product; the sum of the groups' partial products; the rev partial and
  the partial sum of y[0:8]; the exchange and the cluster barrier; the
  stores), and the span from the first start to the last mark.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from tacotron_tpu_torch import probe, runtime  # noqa: E402

# name -> (source edits, each of which must occur once; extra nvcc flags)
C8 = ("constexpr int kOpsCluster = 16;", "constexpr int kOpsCluster = 8;")
VARIANTS = {
    "cluster_8": ([C8], []),
    "rows_8_split_8": ([("constexpr int kOpsRowGroups = 16;", "constexpr int kOpsRowGroups = 8;"),
                        ("constexpr int kOpsSplit = 4;", "constexpr int kOpsSplit = 8;")], []),
    "no_product": ([("for (int k = 0; k < kOpsDepth; k += 4) {",
                     "for (int k = 0; k < 0; k += 4) {")], []),
    "phase_clock": ([], ["-DTT_PROBE_PHASE_CLOCK"]),
    "phase_clock_8": ([C8], ["-DTT_PROBE_PHASE_CLOCK"]),
}
MARKS = ("operands in", "product", "group sum", "partials", "exchange + barrier", "stores")


def build_variants():
    src = (runtime.CSRC_DIR / "probe.cu").read_text()
    out_dir = runtime.BUILD_DIR / "probe_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, flags) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in probe.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, *flags, "-I", str(runtime.CSRC_DIR),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    built = runtime.build(("probe",))["probe"]
    logs, libs = {"built": built.with_suffix(".log").read_text()}, {"built": built}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
        logs[name], libs[name] = log, so
    return logs, libs


def phase_clock(lib, inputs, cluster):
    """One launch's phase clock -> {mark: (mean ns, max ns)} over the
    ``cluster`` blocks, the spread of their starts and the span."""
    probe.probe_ops(*inputs)
    torch.cuda.synchronize()
    raw = np.zeros((16, 7), np.uint64)
    runtime.check(lib.tt_probe_ops_clock(raw.ctypes.data_as(ctypes.c_void_p)), "clock read")
    ns = raw[:cluster].astype(np.int64)
    out = {"start_spread_ns": int(ns[:, 0].max() - ns[:, 0].min())}
    for k, name in enumerate(MARKS, start=1):
        d = ns[:, k] - ns[:, k - 1]
        out[name] = (float(d.mean()), int(d.max()))
    out["span_ns"] = int(ns[:, -1].max() - ns[:, 0].min())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="append one JSON line per build here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    print(f"card: {card}", flush=True)
    logs, libs = build_variants()
    dev = torch.device("cuda")
    ones, seeded = probe.ops_inputs(dev), probe.ops_inputs(dev, seed=0)
    want = probe.probe_ops_reference(*seeded)
    for name, path in libs.items():
        regs = {k["kernel"]: (k.get("registers"), k.get("spill_stores"))
                for k in cs.ptxas_report(logs[name]) if "probe_ops" in k["kernel"]}
        runtime._LIBS["probe"] = ctypes.CDLL(str(path))
        fn = lambda: probe.probe_ops(*ones)  # noqa: E731
        fn()
        us = cs.launch_ms(cs.device_kernels(fn, 200)) * 1e3
        err = cs.max_err(probe.probe_ops(*seeded), want) / float(want.abs().max())
        row = {"build": name, "card": card, "ptxas": regs, "us": us, "err_of_peak": err}
        if name.startswith("phase_clock"):
            row["clock"] = phase_clock(runtime._LIBS["probe"], ones, 8 if name.endswith("_8") else 16)
            print(f"{name:15s} clock {row['clock']}", flush=True)
        print(f"{name:15s} {us:7.2f} us  err/peak {err:.1e}  ptxas {regs}", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
