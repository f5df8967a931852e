"""CLI: training on one GPU, the port of the JAX package's ``cli/train.py``.

    python -m tacotron_tpu_torch.cli.train --data-dir data/ljspeech --run-dir runs/x \\
        [--preset full_1chip] [--steps N] [--batch-size B] [--no-restore] [--platform cpu]

Reads a data directory written by either package's preprocessing and
trains with ``train_step`` on the card, or on the CPU with ``--platform
cpu``; without a card and without that flag it raises. The config is the
preset's, with the vocabulary size and feature widths taken from the data
and ``--set`` overrides on top; it is written to ``RUN_DIR/config.json``.

Always-resume contract: if ``RUN_DIR/ckpt`` holds a checkpoint (either
package's layout, ``train/checkpoint.py``), training continues from the
latest complete one unless ``--no-restore``. The flags and the printed
lines are the JAX package's: ``buckets: [...]``, ``resumed from step N``,
one JSON line per summary with the metrics and ``frames_per_s``, ``trace
written: ...`` and the last ``{"done": true, "step": N}``.

One process trains on one device. The multi-process flags
(``--coordinator``, ``--num-processes``, ``--process-id``, ``--debug-sync``)
are refused (ROADMAP.md Queue 1, item 7), and so is ``--profile-port``
(item 8). ``--debug-nans`` turns on autograd's anomaly mode, which raises
where a backward function returns NaN, and raises FloatingPointError on a
step whose metrics are not finite; JAX's ``jax_debug_nans`` also checks
every forward operation, which has no torch counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}
REFUSED = {"coordinator": "item 7", "num_processes": "item 7", "process_id": "item 7",
           "debug_sync": "item 7", "profile_port": "item 8"}


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
                   help="not ported: refused (ROADMAP.md Queue 1, item 7)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="not ported: refused (ROADMAP.md Queue 1, item 7)")
    p.add_argument("--process-id", type=int, default=None,
                   help="not ported: refused (ROADMAP.md Queue 1, item 7)")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly mode, and raise on a step whose metrics "
                        "are not finite")
    p.add_argument("--debug-sync", action="store_true",
                   help="not ported: refused (ROADMAP.md Queue 1, item 7)")
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
                   help="not ported: refused (ROADMAP.md Queue 1, item 8)")
    p.add_argument("--trace-steps", default=None, metavar="FIRST:LAST",
                   help="capture a torch.profiler trace spanning these steps "
                        "(inclusive) into RUN_DIR/trace, e.g. --trace-steps 40:45")
    args = p.parse_args(argv)
    for name, item in REFUSED.items():
        if getattr(args, name) not in (None, False, 0):
            p.error(f"--{name.replace('_', '-')} is not ported: it waits for "
                    f"ROADMAP.md Queue 1, {item}")

    import torch

    from tacotron_tpu_torch.config import apply_overrides, get_config
    from tacotron_tpu_torch.data.loader import DataLoader, Dataset, device_prefetch, put_batch
    from tacotron_tpu_torch.runtime import resolve_device
    from tacotron_tpu_torch.train import checkpoint, create_train_state, train_step
    from tacotron_tpu_torch.utils import SummaryWriter, profiling
    from tacotron_tpu_torch.weights import split_state

    device = resolve_device(PLATFORMS[args.platform] if args.platform else None)
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

    n_dev = 1
    # an explicit batch size, by --batch-size or --set train.batch_size=N,
    # wins over the per-device one
    batch_overridden = args.batch_size is not None or any(
        ov.partition("=")[0] == "train.batch_size" for ov in args.overrides)
    if not batch_overridden and cfg.train.per_chip_batch_size:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=cfg.train.per_chip_batch_size * n_dev))

    os.makedirs(args.run_dir, exist_ok=True)
    with open(os.path.join(args.run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    loader = DataLoader(
        ds, batch_size=cfg.train.batch_size,
        num_buckets=args.num_buckets or cfg.data.num_buckets, r=cfg.model.r,
        seed=cfg.train.seed, device_cache=args.device_cache, device=device,
    )
    print(f"buckets: {[b.key() for b in loader.buckets]}")

    state = create_train_state(cfg, seed=cfg.train.seed, device=device)
    ckpt_dir = os.path.join(args.run_dir, "ckpt")
    start_step = 0
    if not args.no_restore and checkpoint.latest(ckpt_dir) is not None:
        state, start_step = checkpoint.restore(ckpt_dir, state, cfg.train)
        print(f"resumed from step {start_step}")

    writer = SummaryWriter(os.path.join(args.run_dir, "tb"))
    trace_dir = os.path.join(args.run_dir, "trace")

    # the copies of batch N+1 are enqueued before the step on batch N runs
    stream = iter(loader)
    it = device_prefetch(stream, lambda b: put_batch(b, device))
    t_last = time.time()
    frames_since = 0
    step = start_step
    eval_synth = None
    prof = None
    try:
        while step < cfg.train.max_steps:
            # >= not ==: a resume can land inside (or past) the window; the
            # profiler handle keeps start and stop paired either way
            if trace_first >= 0 and step + 1 >= trace_first and prof is None:
                prof = profiling.start_trace(trace_dir)
            b, (arrays, _pinned) = next(it)
            state, metrics, alignments = train_step(state, *arrays, cfg=cfg)
            step += 1
            if args.debug_nans and not all(math.isfinite(float(v)) for v in metrics.values()):
                raise FloatingPointError(f"step {step}: metrics not finite: "
                                         f"{ {k: float(v) for k, v in metrics.items()} }")
            if prof is not None and step >= trace_last:
                profiling.stop_trace(prof)
                prof = None
                trace_first = -1          # one window per run
                print(f"trace written: {trace_dir}")
            frames_since += b.mel.shape[0] * b.mel.shape[1]

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
                checkpoint.save(ckpt_dir, step, state, cfg.train)

            if args.eval_every and step % args.eval_every == 0:
                from tacotron_tpu_torch.infer import Synthesizer

                params, stats = split_state(state.model)
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
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(False)

    if prof is not None:   # the window extended past max_steps: still write it
        profiling.stop_trace(prof)
        print(f"trace written: {trace_dir}")
    checkpoint.save(ckpt_dir, step, state, cfg.train)
    writer.close()
    print(json.dumps({"done": True, "step": step}))


if __name__ == "__main__":
    main()
