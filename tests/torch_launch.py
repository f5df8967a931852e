"""Run a function on several local ranks, one fresh process each: the
harness of the multi-process tests and of ``chip_smoke.py``'s [dp] phase.

    results = torch_launch.run("my_module:fn", world=2, kwargs={...}, workdir=d,
                               timeout_s=120, platform="cpu")

Each process joins a process group through a ``file://`` rendezvous under
``workdir`` (no ports to clash; ``multihost.initialize``, with a collective
timeout of ``pg_timeout_s``), then calls ``fn(rank=r, world=n, **kwargs)``
and hands its return value back (pickled). ``run`` returns the values in
rank order. If a rank fails, or the ranks are not all done within
``timeout_s``, every rank still running is killed and ``RuntimeError``
carries each failed rank's error and the end of its output, so a hung or
dead rank never holds the caller. ``run_commands`` does the same for any
commands (the CLIs, one process each). The kernels are not built here: build
them in the caller first (``runtime.build()``), so that the ranks only load
them.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]


def _tail(path: Path, n: int) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def run_commands(cmds, log_dir, timeout_s: float, env: dict | None = None):
    """Start the commands as processes at once, each writing its stdout and
    stderr to ``log_dir/p<i>.log``; kill every one still running as soon as
    one fails or at ``timeout_s``. -> (outputs, exit codes; None for a
    process killed at the wall)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    paths = [log_dir / f"p{i}.log" for i in range(len(cmds))]
    procs = []
    for c, path in zip(cmds, paths):
        with open(path, "wb") as log:
            procs.append(subprocess.Popen(c, stdout=log, stderr=subprocess.STDOUT, env=env,
                                          cwd=str(log_dir)))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        codes = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [_tail(path, n=1 << 20) for path in paths], codes


def run(target: str, world: int, kwargs: dict | None = None, *, workdir, timeout_s: float,
        platform: str = "cpu", pg_timeout_s: float = 60.0, threads: int = 1,
        extra_path=()) -> list:
    workdir = Path(workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    spec = workdir / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump({"target": target, "world": world, "kwargs": kwargs or {},
                     "platform": platform, "pg_timeout_s": pg_timeout_s,
                     "rendezvous": f"file://{workdir / 'rendezvous'}", "threads": threads}, f)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads), PYTHONPATH=os.pathsep.join(
        [str(REPO_ROOT), *map(str, extra_path), os.environ.get("PYTHONPATH", "")]))
    cmds = [[sys.executable, str(Path(__file__).resolve()), str(spec), str(r)]
            for r in range(world)]
    outs, codes = run_commands(cmds, workdir, timeout_s, env)
    if codes != [0] * world:
        failed = [r for r, c in enumerate(codes) if c != 0]
        raise RuntimeError(f"ranks {failed} of {target} failed or were not done within "
                           f"{timeout_s} s (exit codes {codes}; every rank left was killed):\n"
                           + "\n".join(f"--- rank {r}:\n{outs[r][-4000:]}" for r in failed))
    out = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _child(spec_path: str, rank: int) -> int:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    import torch

    from tacotron_tpu_torch.parallel import multihost

    torch.set_num_threads(spec["threads"])
    try:
        multihost.initialize(spec["rendezvous"], spec["world"], rank,
                             platform=spec["platform"], timeout_s=spec["pg_timeout_s"])
        module, name = spec["target"].split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(rank=rank, world=spec["world"], **spec["kwargs"])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)        # do not wait in the process group's teardown
    with open(Path(spec_path).parent / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
