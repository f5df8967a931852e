"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels' build into the checkout, the weights and inputs made
on the device from the seed, every shape of the cell's traffic warmed up)
is timed from the process's start to the first timed call. The window
then runs for ``--seconds``. ``--trace 1`` profiles a fixed count of calls
or steps inside it and reports the per-layer metrics instead of the
end-to-end ones. After the window the program is freed and the plain
reference follows a sample of what the window produced; ``correct`` is
their comparison (``benchmark/compare.py``). The last line of standard
output is the result as one JSON object; the numbers compared, each beside
its limit, end standard error too.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "benchmark_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tacotron_tpu")


def _pin_caches():
    """Every build and kernel cache inside the checkout, at fixed paths; one
    host thread for the host's tensor work (the load is one client, and idle
    worker threads spinning beside it on a shared host spread the times)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def precision_flags():
    """f32 products in f32 and bf16 products summed in f32, as the
    configurations state (torch's defaults let cuDNN take TF32)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is the JAX
    package's, JAX's or its libraries'."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str, code: int = 2) -> int:
    print(msg, file=sys.stderr)
    return code


def main(argv=None, *, device: str | None = None, overrides: dict | None = None) -> int:
    """``device`` and ``overrides`` are for the benchmark's own tests: a run
    on the CPU at a small size."""
    args = parse(argv)
    _pin_caches()
    import torch
    torch.set_num_threads(1)

    from benchmark import harness
    cell = harness.load_cell(args.workload)
    cell.traffic.update((overrides or {}).get("traffic", {}))
    chips = cell.entry["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            return _fail(f"needs {chips} CUDA device(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
        precision_flags()
    try:
        import tacotron_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program under test is missing: {e}")
    from benchmark import trace as tr_mod
    from benchmark.compare import judge, worst

    run = harness.driver(cell).Run(cell, args.seed, device, overrides)
    run.setup()
    setup_s = time.time() - T_START
    on_card = torch.device(device).type == "cuda"

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
    res = run.window(args.seconds, prof)
    peak = torch.cuda.max_memory_reserved() if on_card else 0
    metrics, extra = {}, {}
    if prof is not None:
        events = tr_mod.events(prof)
        del prof
        spans = sorted((e.start, e.end) for e in events if e.name == tr_mod.SPAN and e.kind == "cpu")
        trace = tr_mod.Trace(events, spans, run.span_info)
        for m in cell.per_layer:
            value = harness.reader(m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr_mod.busy_seconds(trace), "window_s": trace.span_seconds()}
        brk = tr_mod.breakdown(trace)
        del events, trace
    else:
        values = dict(res, setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    run.release()

    numbers = worst(run.check())
    ok, rows = judge(numbers, cell.checks["limits"])
    bad = forbidden_modules()
    if bad:
        return _fail(f"the process loaded {', '.join(bad)}: the benchmark runs the port alone")
    if res["failed"]:
        ok = False
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    out = {"correct": ok, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu", "kind": name, "count": chips,
                      "memory_peak_bytes": peak, **extra}}
    if args.trace:
        out["breakdown"] = brk
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        verdict = "ok" if math.isfinite(v) and v <= lim else "OVER"
        print(f"check {n} {v!r} limit {lim!r} {verdict}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
