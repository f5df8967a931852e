"""CLI: synthesis from a run directory, the port of the JAX package's ``cli/synthesize.py``.

    python -m tacotron_tpu_torch.cli.synthesize --run-dir runs/x --data-dir data/ljspeech \\
        --text "hello world" [--text "..."] --out-dir out/ \\
        [--steps N] [--gl-iters 1000] [--fused] [--preset synth_fast] [--platform cpu]
        [--data-parallel [--coordinator HOST:PORT --num-processes N --process-id I]]

Restores a run directory written by either package's training (its
``config.json`` and the checkpoints under ``ckpt/``, ``train/checkpoint.py``),
reads ``vocab.json`` from the data directory, synthesizes the prompts and
writes ``utt_<i>.wav`` into the output directory, then prints one JSON line
with the same keys as the JAX package's. It runs on the card unless
``--platform cpu`` asks for the plain PyTorch versions on the CPU; without
a card and without that flag it raises. The flags and their mutual
exclusions are the JAX package's. ``--data-parallel`` splits the prompts
over a mesh of the processes (``Synthesizer(mesh=...)``), one per device,
joined by ``--coordinator``/``--num-processes``/``--process-id`` as in the
training CLI; every process synthesizes its slice and process 0 writes the
wavs and the JSON line. One process that sees several cards refuses
``--data-parallel``: start one process per card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

from tacotron_tpu_torch.config import PRESETS

PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def overlay_preset(cfg, name: str):
    """``cfg`` with the named preset's Griffin-Lim settings and infer section,
    as ``--preset`` applies them: only synthesis-behavior fields, since frame
    geometry and the model section are pinned by the checkpoint."""
    from tacotron_tpu_torch.config import get_config

    ps = get_config(name)
    return dataclasses.replace(
        cfg,
        audio=dataclasses.replace(
            cfg.audio,
            griffin_lim_iters=ps.audio.griffin_lim_iters,
            gl_momentum=ps.audio.gl_momentum,
            gl_backend=ps.audio.gl_backend,
            gl_trim_chunks=ps.audio.gl_trim_chunks,
        ),
        infer=ps.infer,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run-dir", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--text", action="append", default=None,
                   help="prompt (repeatable)")
    p.add_argument("--text-file", default=None,
                   help="file with one prompt per line (blank lines skipped); "
                        "combines with --text")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--gl-iters", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="cpu: the plain PyTorch versions on the CPU; by default the card")
    p.add_argument("--fused", action="store_true",
                   help="decode through the fused decode kernel")
    p.add_argument("--early-exit", action="store_true",
                   help="stop decoding when the whole batch has gone silent")
    p.add_argument("--trim", action="store_true",
                   help="write per-utterance silence-trimmed wavs and run "
                        "Griffin-Lim only on the non-padding prefix")
    p.add_argument("--data-parallel", action="store_true",
                   help="split the prompts over the processes' devices (a mesh of "
                        "one process per device)")
    p.add_argument("--coordinator", default=None,
                   help="with --data-parallel: rendezvous address host:port (or a "
                        "tcp:// or file:// URL)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --data-parallel: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --data-parallel: this process's id in [0, num-processes)")
    p.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace of the synthesis pass "
                        "(after a warm-up pass) into this directory; the JSON "
                        "line is then marked traced")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="override a field of the restored run config (model "
                        "overrides must keep the parameter shapes compatible "
                        "with the checkpoint)")
    p.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="overlay a named preset's Griffin-Lim settings "
                        "(iters/momentum/backend/trim) and infer section on "
                        "the restored run config; frame geometry and model "
                        "come from the run")
    args = p.parse_args(argv)
    texts = list(args.text or [])
    if args.text_file:
        with open(args.text_file) as f:
            texts += [ln.strip() for ln in f if ln.strip()]
    if not texts:
        p.error("no prompts: pass --text and/or --text-file")
    if (args.num_processes or 1) > 1 and not args.data_parallel:
        p.error("--num-processes needs --data-parallel")

    from tacotron_tpu_torch.config import Config, apply_overrides
    from tacotron_tpu_torch.data.ljspeech import save_wav
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.infer import Synthesizer
    from tacotron_tpu_torch.runtime import resolve_device
    from tacotron_tpu_torch.train import checkpoint, create_train_state
    from tacotron_tpu_torch.weights import split_state

    with open(os.path.join(args.run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    if args.preset:
        cfg = overlay_preset(cfg, args.preset)
    cfg = apply_overrides(cfg, args.overrides)
    if args.early_exit or args.trim:
        # flags only enable: a False flag must not clobber what --preset or
        # --set turned on
        cfg = dataclasses.replace(
            cfg, infer=dataclasses.replace(
                cfg.infer,
                early_exit=args.early_exit or cfg.infer.early_exit,
                trim_before_gl=args.trim or cfg.infer.trim_before_gl))
    # mutual exclusions on the effective config (flags, --preset and --set
    # can all set these)
    ee_or_trim = cfg.infer.early_exit or cfg.infer.trim_before_gl
    if args.data_parallel and (args.fused or ee_or_trim):
        p.error("--data-parallel cannot combine with --fused or "
                "early-exit/trim (from flags, --preset or --set): fused is a "
                "single-chip kernel; early-exit/trim are host-driven")
    if args.fused and ee_or_trim:
        p.error("--fused cannot combine with early-exit/trim (from flags, "
                "--preset or --set): the fused kernel decodes a fixed "
                "length; the flags' savings would silently not happen")
    platform = PLATFORMS[args.platform] if args.platform else "cuda"
    device = resolve_device(platform)
    mesh = None
    if args.data_parallel:
        import torch

        from tacotron_tpu_torch.parallel import make_mesh, multihost

        multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                             platform=platform)
        if (multihost.process_count() == 1 and platform == "cuda"
                and torch.cuda.device_count() > 1):
            p.error(f"--data-parallel in one process would use 1 of "
                    f"{torch.cuda.device_count()} cards: start one process per card "
                    f"(--coordinator, --num-processes, --process-id)")
        mesh = make_mesh(cfg.mesh, platform)
        device = mesh.device
    primary = mesh is None or multihost.is_primary()
    vocab = Vocab.load(os.path.join(args.data_dir, "vocab.json"))

    # the full parameters on every process: synthesis replicates them
    state = create_train_state(cfg, device=device)
    state, step = checkpoint.restore(os.path.join(args.run_dir, "ckpt"), state, cfg.train)
    print(f"restored checkpoint at step {step}")
    synth = Synthesizer(cfg, *split_state(state.model), vocab, fused=args.fused, mesh=mesh,
                        device=device)
    del state

    ctx = contextlib.nullcontext()
    if args.trace_dir:
        from tacotron_tpu_torch.utils import profiling

        # a warm-up pass first, so that the trace shows the steady state
        synth(texts, n_steps=args.steps, gl_iters=args.gl_iters, seed=args.seed)
        ctx = profiling.trace(args.trace_dir)
    with ctx:
        t0 = time.time()
        out = synth(texts, n_steps=args.steps, gl_iters=args.gl_iters, seed=args.seed)
        dt = time.time() - t0
    if args.trace_dir:
        print(f"trace written: {args.trace_dir}")
    if not primary:
        return

    os.makedirs(args.out_dir, exist_ok=True)
    for i, wav in enumerate(out["wavs"]):
        path = os.path.join(args.out_dir, f"utt_{i:03d}.wav")
        if cfg.infer.trim_before_gl:   # the effective config, not just the flag
            wav = wav[: max(int(out["wav_lengths"][i]), cfg.audio.hop_length)]
        save_wav(path, wav, cfg.audio.sample_rate)
    print(json.dumps({
        **({"traced": True} if args.trace_dir else {}),
        "n": len(out["wavs"]),
        "audio_seconds": round(out["audio_seconds"], 2),
        "trimmed_audio_seconds": round(out["trimmed_audio_seconds"], 2),
        "wall_seconds": round(dt, 2),
        "audio_seconds_per_s": round(out["audio_seconds"] / dt, 3),
        "trimmed_audio_seconds_per_s": round(out["trimmed_audio_seconds"] / dt, 3),
        "out_dir": args.out_dir,
    }))


if __name__ == "__main__":
    main()
