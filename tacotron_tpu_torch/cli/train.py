"""CLI: training on one GPU or one process per GPU, the port of the JAX package's ``cli/train.py``.

    python -m tacotron_tpu_torch.cli.train --data-dir data/ljspeech --run-dir runs/x \\
        [--preset full_1chip] [--steps N] [--batch-size B] [--no-restore] [--platform cpu]
        [--coordinator HOST:PORT --num-processes N --process-id I] [--debug-sync]

Reads a data directory written by either package's preprocessing and
trains with ``make_train_step``'s step: on one card one CUDA graph per
bucket shape (each bucket's first step eager, then its graph replayed, as
JAX compiles its step per bucket), on the CPU (``--platform cpu``) and on
several processes the eager ``train_step``; without a card and without
that flag it raises. The config is the
preset's, with the vocabulary size and feature widths taken from the data
and ``--set`` overrides on top; it is written to ``RUN_DIR/config.json``.

Always-resume contract: if ``RUN_DIR/ckpt`` holds a checkpoint (either
package's layout, ``train/checkpoint.py``), training continues from the
latest complete one unless ``--no-restore``. The flags and the printed
lines are the JAX package's: ``buckets: [...]``, ``resumed from step N``,
one JSON line per summary with the metrics and ``frames_per_s``, ``trace
written: ...`` and the last ``{"done": true, "step": N}``.

Multi-process training runs one process per device under
``torch.distributed`` (``parallel/``): start one process per card with
``--coordinator HOST:PORT --num-processes N --process-id I`` (NCCL with a
card per process, gloo on the CPU or for several processes on one card).
As in JAX: the global batch is ``per_chip_batch_size`` x N unless the batch
size was set explicitly, each process loads its shard of it, only process
0 writes ``config.json``, summaries and checkpoints (gathered from every
process), every process checks after a resume that all start from the same
step, and ``--debug-sync`` checks the batch shapes every step and the step
and the shards' distinct content at the summary cadence. ``--device-cache``
is refused with more than one process. ``--debug-nans`` turns on
autograd's anomaly mode, which raises where a backward function returns
NaN, and raises FloatingPointError on a step whose metrics are not finite;
JAX's ``jax_debug_nans`` also checks every forward operation, which has no
torch counterpart. Anomaly mode cannot be captured in a CUDA graph, so
under ``--debug-nans`` every step runs the eager ``train_step``.
``--trace-steps`` and ``--profile-port`` trace graphed steps as they run:
the profiler records the kernels a graph replays by name.

Live capture: with ``--profile-port PORT`` the run serves HTTP on
``127.0.0.1:PORT`` (``utils/profiling.start_server``, the counterpart of
JAX's profiler server) until it ends. ``curl
'127.0.0.1:PORT/capture?steps=N'`` traces the next N training steps into
``RUN_DIR/trace`` (a ``*.pt.trace.json``, as ``--trace-steps`` writes) and
answers, once the trace is written, with a JSON object naming the
directory, the first and last step and the files; ``/status`` says whether
a capture is pending or open and the step reached. The profiler starts and
stops on the training thread, at step boundaries. A request while a
capture is pending or open, or for fewer than 1 step, gets an error reply
and the run goes on. JAX starts a server on every process; here process I
serves at PORT + I, so that several processes on one host do not collide,
and each prints its address to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time

PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--preset", default="full_1chip")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--no-restore", action="store_true")
    p.add_argument("--num-buckets", type=int, default=None)
    p.add_argument("--device-cache", action="store_true",
                   help="upload the packed arrays to the device once and gather "
                        "each step's padded batch there; a step then uploads "
                        "only its rows' offsets and lengths")
    p.add_argument("--summary-every", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="cpu: the plain PyTorch versions on the CPU; by default the card")
    p.add_argument("--coordinator", default=None,
                   help="multi-process rendezvous address host:port (or a tcp:// "
                        "or file:// URL)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count: one process per device")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id in [0, num-processes)")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly mode, and raise on a step whose metrics "
                        "are not finite")
    p.add_argument("--debug-sync", action="store_true",
                   help="cross-process batch-shape agreement every step, plus step "
                        "agreement and input-shard content distinctness at the "
                        "summary cadence")
    p.add_argument("--eval-every", type=int, default=0,
                   help="every N steps: synthesize --eval-text and write an "
                        "audio + alignment summary; 0 = off")
    p.add_argument("--eval-text", default="the quick brown fox jumps over the lazy dog")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable, e.g. "
                        "--set model.tf_decoder=hoisted "
                        "--set model.compute_dtype=bfloat16")
    p.add_argument("--profile-port", type=int, default=0,
                   help="serve live capture on 127.0.0.1:PORT (+ the process id): "
                        "GET /capture?steps=N traces the next N steps into "
                        "RUN_DIR/trace; 0 = off")
    p.add_argument("--trace-steps", default=None, metavar="FIRST:LAST",
                   help="capture a torch.profiler trace spanning these steps "
                        "(inclusive) into RUN_DIR/trace, e.g. --trace-steps 40:45")
    args = p.parse_args(argv)

    import sys

    import torch

    from tacotron_tpu_torch.parallel import multihost
    from tacotron_tpu_torch.runtime import resolve_device

    platform = PLATFORMS[args.platform] if args.platform else "cuda"
    resolve_device(platform)          # no card and no --platform cpu: raise
    # the rendezvous, before any device use (one process: a no-op)
    multihost.initialize(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id, platform=platform)

    from tacotron_tpu_torch.config import apply_overrides, get_config
    from tacotron_tpu_torch.data.loader import DataLoader, Dataset, device_prefetch, put_batch
    from tacotron_tpu_torch.parallel import make_mesh
    from tacotron_tpu_torch.train import (checkpoint, create_train_state, make_train_step,
                                          train_step)
    from tacotron_tpu_torch.train.step import GraphedTrainStep
    from tacotron_tpu_torch.utils import SummaryWriter, profiling

    profiling.enable_compilation_cache()
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    trace_first = trace_last = -1
    if args.trace_steps:
        trace_first, trace_last = (int(x) for x in args.trace_steps.split(":"))

    cfg = get_config(args.preset)
    ds = Dataset(args.data_dir)
    tr = cfg.train
    if args.steps is not None:
        tr = dataclasses.replace(tr, max_steps=args.steps)
    if args.batch_size is not None:
        tr = dataclasses.replace(tr, batch_size=args.batch_size)
    if args.summary_every is not None:
        tr = dataclasses.replace(tr, summary_every=args.summary_every)
    if args.checkpoint_every is not None:
        tr = dataclasses.replace(tr, checkpoint_every=args.checkpoint_every)
    cfg = dataclasses.replace(
        cfg,
        train=tr,
        model=dataclasses.replace(cfg.model, vocab_size=max(64, len(ds.vocab) + 1),
                                  n_freq=ds.linears.shape[1],
                                  n_mels=ds.mels.shape[1]),
    )
    cfg = apply_overrides(cfg, args.overrides)
    if args.num_buckets:      # the loader's buckets, and the graphed step's cap on shapes
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_buckets=args.num_buckets))

    mesh = make_mesh(cfg.mesh, platform)
    device = mesh.device
    n_dev = mesh.size
    if n_dev == 1 and platform == "cuda" and torch.cuda.device_count() > 1:
        print(f"training on 1 of {torch.cuda.device_count()} cards: start one process per "
              f"card (--coordinator, --num-processes, --process-id) to use them all",
              file=sys.stderr)
    # an explicit batch size, by --batch-size or --set train.batch_size=N,
    # wins over the per-device one
    batch_overridden = args.batch_size is not None or any(
        ov.partition("=")[0] == "train.batch_size" for ov in args.overrides)
    if not batch_overridden and cfg.train.per_chip_batch_size:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=cfg.train.per_chip_batch_size * n_dev))
    if cfg.train.batch_size % n_dev:
        p.error(f"global batch {cfg.train.batch_size} not divisible by {n_dev} devices")

    os.makedirs(args.run_dir, exist_ok=True)
    if multihost.is_primary():
        with open(os.path.join(args.run_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    if args.device_cache and multihost.process_count() > 1:
        raise SystemExit("--device-cache is single-process only: each process would "
                         "upload the whole corpus to its device for a shard of it")
    # each process loads its rows of the global batch; the processes of one
    # model group (tensor parallelism) share theirs
    loader = DataLoader(
        ds, batch_size=cfg.train.batch_size // mesh.data_size,
        num_buckets=cfg.data.num_buckets, r=cfg.model.r,
        seed=cfg.train.seed, process_index=mesh.data_index,
        process_count=mesh.data_size, device_cache=args.device_cache, device=device,
    )
    print(f"buckets: {[b.key() for b in loader.buckets]}")

    state = create_train_state(cfg, seed=cfg.train.seed, mesh=mesh)
    ckpt_dir = os.path.join(args.run_dir, "ckpt")
    start_step = 0
    if not args.no_restore and checkpoint.latest(ckpt_dir) is not None:
        state, start_step = checkpoint.restore(ckpt_dir, state, cfg.train)
        print(f"resumed from step {start_step}")
    # unconditional: only process 0 writes checkpoints, so on a run
    # directory that a process does not share it would restart at step 0
    multihost.assert_same_step(start_step)

    # a graph per bucket shape on one card (the shapes the loader's buckets
    # give, cfg.data.num_buckets at most); anomaly mode is not capturable
    step_fn = (functools.partial(train_step, cfg=cfg, mesh=mesh) if args.debug_nans
               else make_train_step(cfg, mesh))
    if device.type != "cuda":
        how = "eager (the CPU)"
    elif args.debug_nans:
        how = "eager (--debug-nans: anomaly mode cannot be captured)"
    elif isinstance(step_fn, GraphedTrainStep):
        how = "a CUDA graph per batch shape"
    else:
        how = "eager (a gloo mesh: its collectives go through host copies)"
    print(f"training step: {how}", flush=True)
    writer = SummaryWriter(os.path.join(args.run_dir, "tb"), enabled=multihost.is_primary())
    trace_dir = os.path.join(args.run_dir, "trace")

    # the copies of batch N+1 are enqueued before the step on batch N runs
    stream = iter(loader)
    it = device_prefetch(stream, lambda b: put_batch(b, device))
    t_last = time.time()
    frames_since = 0
    step = start_step
    eval_synth = None
    prof = None
    window_end = -1       # the last step of the open trace window
    live = None           # (first step, trace files before) of an open live capture
    server = None
    try:
        if args.profile_port:
            server = profiling.start_server(args.profile_port + multihost.process_index())
            print(f"profile server: http://{server.host}:{server.port}/capture?steps=N "
                  f"(process {multihost.process_index()})", file=sys.stderr)
        while step < cfg.train.max_steps:
            # a live capture opens at a step boundary on this thread; a
            # request made while the --trace-steps window is open waits for it
            if server is not None and (n := server.poll(step, idle=prof is None)):
                os.makedirs(trace_dir, exist_ok=True)
                live = (step + 1, set(os.listdir(trace_dir)))
                prof, window_end = profiling.start_trace(trace_dir), step + n
            # >= not ==: a resume can land inside (or past) the window; the
            # profiler handle keeps start and stop paired either way
            if trace_first >= 0 and step + 1 >= trace_first and prof is None:
                prof, window_end = profiling.start_trace(trace_dir), trace_last
                trace_first = -1          # one window per run
            b, (arrays, _pinned) = next(it)
            if args.debug_sync:
                # shapes every step (one 8-byte all-gather: a bucket
                # divergence shows at its step); the step and the shards'
                # distinct content at the summary cadence
                multihost.assert_same_shapes(b.arrays())
                if (step + 1) % cfg.train.summary_every == 0:
                    multihost.assert_same_step(step)
                    multihost.assert_shard_consistency(b.arrays(), group=mesh.data_group)
            state, metrics, alignments = step_fn(state, *arrays)
            step += 1
            if args.debug_nans and not all(math.isfinite(float(v)) for v in metrics.values()):
                raise FloatingPointError(f"step {step}: metrics not finite: "
                                         f"{ {k: float(v) for k, v in metrics.items()} }")
            # a window that extends past max_steps is written at the last step
            if prof is not None and (step >= window_end or step >= cfg.train.max_steps):
                profiling.stop_trace(prof)
                prof = None
                print(f"trace written: {trace_dir}")
                if live is not None:
                    server.finish({"trace_dir": trace_dir, "steps": [live[0], step],
                                   "files": sorted(set(os.listdir(trace_dir)) - live[1])})
                    live = None
            frames_since += b.mel.shape[0] * b.mel.shape[1] * mesh.data_size

            if step % cfg.train.summary_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                fps = frames_since / dt
                writer.scalars(metrics, step, prefix="train/")
                writer.scalar("perf/frames_per_s", fps, step)
                writer.scalar("perf/frames_per_s_per_chip", fps / n_dev, step)
                writer.alignment("train/alignment", alignments[0].float().cpu().numpy(), step)
                print(json.dumps({"step": step, **metrics,
                                  "frames_per_s": round(fps, 1)}))
                t_last, frames_since = time.time(), 0

            if step % cfg.train.checkpoint_every == 0:
                multihost.barrier("pre-ckpt")
                # collective: every process joins the gather of the shards;
                # only process 0 writes
                checkpoint.save(ckpt_dir, step, state, cfg.train)
                multihost.barrier("post-ckpt")

            if args.eval_every and step % args.eval_every == 0:
                from tacotron_tpu_torch.infer import Synthesizer

                # collective gather on every process; process 0 synthesizes
                params, stats = checkpoint.full_state(state.model)
                if multihost.is_primary():
                    if eval_synth is None:
                        # built once; later evals load the current weights into it
                        eval_synth = Synthesizer(cfg, params, stats, ds.vocab, device=device)
                    else:
                        eval_synth.model.load_state_dict({**params, **stats}, strict=True)
                    out = eval_synth([args.eval_text], gl_iters=60)
                    writer.audio("eval/audio", out["wavs"][0], cfg.audio.sample_rate, step)
                    writer.alignment("eval/alignment", out["alignments"][0], step)
                    writer.flush()
    finally:
        stream.close()
        if server is not None:
            server.close()
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(False)

    checkpoint.save(ckpt_dir, step, state, cfg.train)
    writer.close()
    print(json.dumps({"done": True, "step": step}))


if __name__ == "__main__":
    main()
