"""The readings the limits of ``correct`` are set from, on the card at a
cell's own sizes: for each seed, the program's numbers (a short window at
the cell's load, then the same comparison a run makes) and, with
``--control N``, on the first N seeds, the control's (the reference in the precision below the
configuration's, put in the program's place). One process reads every
seed, so the kernels are built once.

    python3 -m benchmark.controls --workload <cell> --seconds 3 --seeds 1 2 3 [--control N]
    python3 -m benchmark.controls --workload <serving cell> --gl-only 1000 --seeds 1 2 3 [--control N]
    python3 -m benchmark.controls --workload <serving cell> --wav-only --seeds 1 2 3 [--control N]

``--gl-only T_GL`` reads the served Griffin-Lim stage held by itself on a
speech-like spectrogram of T_GL frames; ``--wav-only`` reads only the
served waveforms' number (``wav_sc_excess``) of a short window.

Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=0,
                    help="read the control on the first N seeds too")
    ap.add_argument("--gl-only", type=int, default=0, metavar="T_GL",
                    help="serving cells: read only the Griffin-Lim stage, at T_GL frames")
    ap.add_argument("--wav-only", action="store_true",
                    help="serving cells: read only the served waveforms' number")
    args = ap.parse_args(argv)
    from benchmark import run as bench_run
    bench_run._pin_caches()
    import torch

    from benchmark import harness
    from benchmark.compare import worst
    bench_run.precision_flags()
    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    if args.gl_only:
        for i, seed in enumerate(args.seeds):
            run = harness.driver(cell).Run(cell, seed, "cuda")
            run.build()
            line = {"seed": seed, "program": run._stage_gap(*run.gl_stage(args.gl_only))}
            if i < args.control:
                line["control"] = run._stage_gap(*run.gl_stage(args.gl_only,
                                                               cell.checks["control"]["gl"]))
            print(json.dumps(line), flush=True)
            del run
            torch.cuda.empty_cache()
        return 0
    for i, seed in enumerate(args.seeds):
        run = harness.driver(cell).Run(cell, seed, "cuda")
        run.setup()
        res = run.window(args.seconds)
        run.release()
        if args.wav_only:
            line = {"seed": seed, "calls": res["attempted"], **run.wav_readings(
                cell.checks["control"] if i < args.control else None)}
            print(json.dumps(line), flush=True)
            del run
            torch.cuda.empty_cache()
            continue
        samples = run.check()
        line = {"seed": seed, "calls": res["attempted"], "program": worst(samples),
                "program_samples": samples}
        if i < args.control:
            ctl = run.control(**cell.checks["control"])
            line["control"] = worst(ctl)
            line["control_samples"] = ctl
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
