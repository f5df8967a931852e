"""Where a step of Tacotron 2's step decode kernel (csrc/t2_decode_chunk.cu)
spends its time. Needs one NVIDIA H100 (sm_90a) and nvcc:

    python3 scripts/t2_decode_study.py [--b 8] [--t-in 161] [--source NAME=PATH ...]
        [--out t2_decode_study.json]

Builds ``tacotron_tpu_torch/csrc/t2_decode_chunk.cu`` with ``-DTT_T2_CLOCK``
(as ``clock``), and each whole source given with ``--source`` the same way
(an A/B build of another version of the kernel), and runs each at the
published widths (seeded random weights, gate shut, B rows of T_in down to
half of it, pre-net dropout 0.5): launches of 8 steps as ``WhileDecode``
makes them, the masks drawn before. Prints each build's registers and
spills, its device time per step (CUDA events around the timed launches),
the largest difference of its frames from the committed build's, and the
microseconds per step that blocks 0 and 127 spend between the marks
(``MARKS``: the end of each phase and of each barrier's wait), the stages
consumer warp 0 has taken by each, and the shares of its time consumer
warp 0 spends waiting for its inputs, waiting for stages to land, and on
the rest.
"""
import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tacotron_tpu_torch import runtime  # noqa: E402
from tacotron_tpu_torch.config import Tacotron2Config, get_config  # noqa: E402
from tacotron_tpu_torch.infer.early_exit import WhileDecode  # noqa: E402
from tacotron_tpu_torch.models.tacotron import length_mask  # noqa: E402
from tacotron_tpu_torch.models.tacotron2 import Tacotron2  # noqa: E402
from tacotron_tpu_torch.ops import t2_decode_chunk  # noqa: E402
from tacotron_tpu_torch.ops.decode_chunk import draw_masks  # noqa: E402
from tacotron_tpu_torch.weights import init_params  # noqa: E402

# the kernel's MARK(k, i) points in the order a step passes them: (i, what
# ends there)
MARKS = ((0, "step start"), (20, "top: h_d fetched"), (21, "top: head rows waited"),
         (1, "FR: heads"), (2, "FR: barrier"), (3, "P0: pre-net 0"), (4, "P0: barrier"),
         (5, "P1: pre-net 1"), (6, "P1: barrier"), (7, "LA: x1 staged, XA flushed"),
         (8, "LA: cell"), (9, "LA: barrier"), (22, "Q: h_a fetched"), (23, "Q: rows waited"),
         (10, "Q: query"), (11, "Q: barrier"), (12, "E: energies"),
         (13, "E: barrier (prefetch)"), (14, "S: softmax, context"), (15, "S: barrier"),
         (16, "LD: ctx staged, location term"), (17, "LD: CD flushed"),
         (18, "LD: cell, prefetch"), (19, "LD: barrier"))
N_MARKS = 24
CLOCK = ["-DTT_T2_CLOCK"]


def build(sources):
    """-> {name: (library, ptxas's register lines)}: the committed source as
    ``clock`` and each ``sources`` entry (name -> a whole source file), all
    built with the clock."""
    out_dir = runtime.BUILD_DIR / "t2_decode_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    jobs = {"clock": runtime.CSRC_DIR / "t2_decode_chunk.cu",
            **{name: Path(path) for name, path in sources.items()}}
    for name, path in jobs.items():
        so = out_dir / f"{name}.so"
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, *CLOCK, "-I", str(runtime.CSRC_DIR),
               "-o", str(so), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    out = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        out[name] = (so, regs)
    return out


def setup(b, t_in, dev):
    base = get_config("synth_fast")
    cfg = base.replace(model=dataclasses.replace(base.model, vocab_size=40, embed_dim=512,
                                                 prenet_dims=(256, 256), attention_dim=128, r=1),
                       tacotron2=Tacotron2Config())
    model = init_params(Tacotron2(cfg.model, cfg.tacotron2, cfg.audio, device=dev), seed=7).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("bias"):
                p.zero_()
        model.decoder.gate.bias.fill_(-10.0)           # the gate shut
    g = torch.Generator().manual_seed(0)
    lengths = torch.tensor([t_in - (i * t_in) // (2 * b) for i in range(b)], device=dev)
    ids = torch.randint(1, 40, (b, t_in), generator=g).to(dev)
    mask = length_mask(t_in, lengths)
    with torch.no_grad():
        memory = model.encoder(torch.where(mask, ids, 0), lengths)
        keys = model.memory_proj(memory)
    return model, memory, keys, mask


def run(model, memory, keys, mask, launches, warm=3):
    """``warm`` then ``launches`` launches of 8 steps -> (frames, ms a
    launch by CUDA events over the timed ones)."""
    dev = memory.device
    loop = WhileDecode(memory, keys, mask, model.decoder.step_weights(),
                       torch.Generator(device=dev).manual_seed(3), n_steps=8 * (warm + launches),
                       r=1, n_mels=model.cfg.n_mels, dropout_rate=0.5)
    masks = [draw_masks(memory.shape[0], loop._w, 8, 0.5, loop._gen, dev)
             for _ in range(warm + launches)]
    with torch.no_grad():
        for i in range(warm):
            loop._launch.launch(masks[i], 8)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(warm, warm + launches):
            loop._launch.launch(masks[i], 8)
        e1.record()
        torch.cuda.synchronize()
    return loop.frames.clone(), e0.elapsed_time(e1) / launches


def read_clock(lib):
    """-> (the marks of the last launch's 8 steps, consumer warp 0's cycles
    waiting for inputs, waiting for stages, computing over the launch)."""
    n = 2 * t2_decode_chunk.CHUNK_MAX * N_MARKS * 3
    arr = np.zeros(n + 3, dtype=np.int64)
    runtime.check(lib.tt_t2_decode_clock(ctypes.c_void_p(arr.ctypes.data)), "clock read")
    return arr[:n].reshape(2, t2_decode_chunk.CHUNK_MAX, N_MARKS, 3)[:, :8], arr[n:]


def phases(clock):
    """-> {block: [(mark, us a step, stages consumed by the mark)]}: each
    interval's time from the global timer over steps 1..7 of the last
    launch, and consumer warp 0's stages since the step's start."""
    out = {}
    for i, blk in enumerate((0, t2_decode_chunk.BLOCKS - 1)):
        ns = clock[i, :, :, 1].astype(np.float64)
        cur = clock[i, :, :, 2]
        rows = []
        for (prev, _), (m, what) in zip(MARKS, MARKS[1:]):
            rows.append((what, float(np.mean(ns[1:, m] - ns[1:, prev])) * 1e-3,
                         float(np.mean(cur[1:, m] - cur[1:, 0]))))
        rows.append(("to the next step", float(np.mean(ns[2:, 0] - ns[1:-1, 19])) * 1e-3, 0.0))
        out[blk] = rows
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--t-in", type=int, default=161)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--source", nargs="*", default=[], metavar="NAME=PATH",
                    help="whole sources to build with the clock and time beside the committed one")
    ap.add_argument("--out", default="t2_decode_study.json")
    a = ap.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runtime.build(("t2_decode_chunk",))
    built = build(dict(x.split("=", 1) for x in a.source))
    model, memory, keys, mask = setup(a.b, a.t_in, dev)
    ref, ref_ms = run(model, memory, keys, mask, a.launches)
    report = {"b": a.b, "t_in": a.t_in, "committed_us_per_step": ref_ms * 1e3 / 8}
    print(f"committed build: {ref_ms * 1e3 / 8:.2f} us a step", flush=True)
    committed = runtime._LIBS["t2_decode_chunk"]
    for name, (so, regs) in built.items():
        lib = ctypes.CDLL(str(so))
        runtime._LIBS["t2_decode_chunk"] = lib
        frames, ms = run(model, memory, keys, mask, a.launches)
        rep = {"us_per_step": ms * 1e3 / 8, "regs": regs,
               "frames_gap": float((frames - ref).abs().max())}
        print(f"{name}: {rep['us_per_step']:.2f} us a step, frames gap {rep['frames_gap']:.3g}; "
              f"{regs}", flush=True)
        lib.tt_t2_decode_clock.argtypes = [ctypes.c_void_p]
        clock, cons = read_clock(lib)
        rep["phases"] = phases(clock)
        total = max(1, int(cons.sum()))
        rep["consumer_share"] = {"inputs": cons[0] / total, "landing": cons[1] / total,
                                 "compute": cons[2] / total}
        print(f"  consumer warp 0: {rep['consumer_share']}")
        for blk, rows in rep["phases"].items():
            print(f"  block {blk}:")
            for mark, us, stages in rows:
                print(f"    {mark:32s} {us:8.2f} us   stages {stages:5.1f}")
        report[name] = rep
        runtime._LIBS["t2_decode_chunk"] = committed
    Path(a.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
