#!/usr/bin/env python3
"""What trained weights show that random ones cannot: the early exit and
the trim at full width, and bf16 against f32 Griffin-Lim on trained
spectrograms.

    PYTHONPATH=. python3 tools/trained_findings.py --run-dir RUN_DIR --data-dir DATA_DIR \\
        [--out out/trained_findings.json] [--platform cpu]

On a run directory that ``cli.alignment_run --save-run`` wrote, with the 8
held-out prompts of ``cli.audio_evidence`` (seed 123, 20 characters):

1. ``cli.synthesize --early-exit --trim`` on the prompts, as a user runs it
   (its JSON line and the lengths of the wavs it writes beside the run
   directory, in ``trained_findings_wavs/``), and the same call through
   ``Synthesizer`` with the configuration the CLI builds (the run's, prenet
   dropout on, seed 0, the run's ``max_decode_steps``): each row's decoder
   steps with a nonzero frame (``steps_done``), its end frame, the trimmed
   Griffin-Lim length ``t_gl``, whether the decode stopped before its
   budget (an exit in the middle of the buffer) and whether the trim cut
   the buffer to more than one quantum and less than all of it; then the
   same for each prompt alone (the batch exits only when every row has
   gone silent). The wavs the CLI wrote must have the lengths this call
   gives.
2. The early-exit mel against the fixed-length decode's mel, prenet
   dropout 0 (the two decode paths draw their masks differently), for the
   batch and for each prompt alone: equal within ``EXIT_ATOL`` on the
   frames before the exit, exactly zero after; with the largest difference
   by decoder step, the first step past ``EXIT_ATOL``, and the fixed
   decode against itself run again. A check that fails is recorded, the
   rest still runs, and the script exits non-zero at the end.
3. bf16 against f32 Griffin-Lim (``griffin_lim_spectrum``, momentum 0) on
   the linear spectrograms of the early-exit call, at 100 and 1000
   iterations, cut at the batch's ``t_gl`` and at the last end frame of
   the rows that went silent: the magnitude error mean | |STFT(wav)| - S |
   / mean S of each mode's waveform (``chip_smoke.py``'s bf16-vs-f32
   measure).

Prints one JSON line per part and writes all to ``--out``, with the card's
name and power limit. Runs on the card unless ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import time

import numpy as np

EXIT_ATOL = 1e-5
GL_ITERS = (100, 1000)
PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


def steps_done_of(mel: np.ndarray, r: int) -> list[int]:
    """Per row: decoder steps up to the last one with a nonzero frame."""
    out = []
    for row in mel:
        live = np.nonzero(np.abs(row).max(axis=-1) > 0)[0]
        out.append(int(-(-(live.max() + 1) // r)) if len(live) else 0)
    return out


def magnitude_error(spec, mag, acfg) -> float:
    """mean | |STFT(istft(spec))| - mag | / mean mag."""
    import torch

    from tacotron_tpu_torch.dsp.dft import istft_mm, stft_mm
    kw = dict(n_fft=acfg.n_fft, hop_length=acfg.hop_length, win_length=acfg.win_length)
    wav = istft_mm(spec[0].float(), spec[1].float(), **kw)
    re, im = stft_mm(wav, **kw)
    return float((torch.sqrt(re * re + im * im + 1e-12) - mag).abs().mean() / mag.mean())


def card_name(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out", default="out/trained_findings.json")
    ap.add_argument("--platform", default=None, choices=sorted(PLATFORMS))
    args = ap.parse_args(argv)

    import torch

    from tacotron_tpu_torch.cli import synthesize as synthesize_cli
    from tacotron_tpu_torch.cli.audio_evidence import held_out_prompts
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.data.ljspeech import load_wav
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.dsp.fused_gl import griffin_lim_spectrum
    from tacotron_tpu_torch.infer import Synthesizer
    from tacotron_tpu_torch.runtime import resolve_device
    from tacotron_tpu_torch.train import checkpoint, create_train_state
    from tacotron_tpu_torch.weights import split_state

    device = resolve_device(PLATFORMS[args.platform] if args.platform else None)
    card = card_name(device)
    prompts = held_out_prompts(8, 20, 26, 123)
    report = {"card": card, "run_dir": args.run_dir, "prompts": prompts}

    # 1. the CLI as a user runs it
    wav_dir = os.path.join(os.path.dirname(os.path.abspath(args.run_dir)), "trained_findings_wavs")
    argv_cli = ["--run-dir", args.run_dir, "--data-dir", args.data_dir, "--out-dir", wav_dir,
                "--early-exit", "--trim", *(["--platform", args.platform] if args.platform
                                            else []),
                *(x for p in prompts for x in ("--text", p))]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        synthesize_cli.main(argv_cli)
    cli_line = json.loads(buf.getvalue().strip().splitlines()[-1])

    with open(os.path.join(args.run_dir, "config.json")) as f:
        run_cfg = Config.from_json(f.read())
    vocab = Vocab.load(os.path.join(args.data_dir, "vocab.json"))
    state = create_train_state(run_cfg, device=device)
    state, step = checkpoint.restore(os.path.join(args.run_dir, "ckpt"), state, run_cfg.train)
    params = split_state(state.model)
    del state

    def synth(early_exit, trim, dropout):
        cfg = dataclasses.replace(
            run_cfg, infer=dataclasses.replace(run_cfg.infer, early_exit=early_exit,
                                               trim_before_gl=trim),
            model=dataclasses.replace(run_cfg.model, prenet_dropout=dropout))
        return cfg, Synthesizer(cfg, *params, vocab, device=device)

    r, hop = run_cfg.model.r, run_cfg.audio.hop_length
    n_steps = run_cfg.model.max_decode_steps
    cfg, s = synth(True, True, run_cfg.model.prenet_dropout)
    q = cfg.infer.gl_length_quantum

    def exit_row(out):
        steps = steps_done_of(out["mel"], r)
        t_gl = out["wavs"].shape[1] // hop + 1
        frames = out["mel"].shape[1]
        return {"steps_done": steps, "end_frames": [int(e) for e in out["end_frames"]],
                "t_gl": t_gl, "frames": frames, "mid_utterance_exit": 0 < max(steps) < n_steps,
                "trimmed_past_one_quantum": q < t_gl < frames}

    t0 = time.perf_counter()
    out = s(prompts, seed=0)
    wall = time.perf_counter() - t0
    written = [len(load_wav(os.path.join(wav_dir, f"utt_{i:03d}.wav"))) for i in range(8)]
    want = [max(int(n), hop) for n in out["wav_lengths"]]
    exit_run = {"checkpoint_step": step, "n_steps": n_steps, "r": r, "quantum": q,
                "prenet_dropout": run_cfg.model.prenet_dropout, **exit_row(out),
                "wall_s": wall, "cli": cli_line, "cli_wav_lengths": written,
                "cli_wavs_match": written == want,
                # each prompt alone: the exit waits for no other row
                "alone": [exit_row(s([p], seed=0)) for p in prompts]}
    report["early_exit_trim"] = exit_run
    print(json.dumps({"early_exit_trim": exit_run}), flush=True)
    failed = [] if written == want else [f"the CLI's wavs {written} are not this call's {want}"]

    # 2. the early-exit mel against the fixed decode's, dropout 0; the mel
    # does not see Griffin-Lim, which runs one iteration here
    def exit_vs_fixed(texts):
        m_exit = synth(True, False, 0.0)[1](texts, seed=0, gl_iters=1)["mel"]
        m_fixed = synth(False, False, 0.0)[1](texts, seed=0, gl_iters=1)["mel"]
        again = synth(False, False, 0.0)[1](texts, seed=0, gl_iters=1)["mel"]
        done = max(steps_done_of(m_exit, r))
        diff = np.abs(m_exit[:, :done * r] - m_fixed[:, :done * r])
        by_step = diff.reshape(len(texts), done, -1).max(axis=(0, 2)) if done else diff
        over = np.nonzero(by_step > EXIT_ATOL)[0]
        return {"steps_done": done, "max_abs_err": float(diff.max()) if done else 0.0,
                "first_step_over_atol": int(over[0]) + 1 if len(over) else None,
                "max_abs_err_by_step": {n: float(by_step[:n].max())
                                        for n in (10, 25, 50, 100, 200, 500) if n <= done},
                "zeros_after_exit": bool((m_exit[:, done * r:] == 0).all()),
                "fixed_twice_max_abs_err": float(np.abs(m_fixed - again).max()),
                "mel_peak": float(np.abs(m_fixed).max())}

    parity = {"atol": EXIT_ATOL, "batch": exit_vs_fixed(prompts),
              "alone": [exit_vs_fixed([p]) for p in prompts]}
    report["exit_vs_fixed"] = parity
    print(json.dumps({"exit_vs_fixed": parity}), flush=True)
    for name, row in [("batch", parity["batch"])] + [(f"prompt {i}", x)
                                                      for i, x in enumerate(parity["alone"])]:
        if not (row["max_abs_err"] <= EXIT_ATOL and row["zeros_after_exit"]):
            failed.append(f"early-exit mel against the fixed decode, {name}: {row}")

    # 3. bf16 against f32 Griffin-Lim on the trained spectrograms: the
    # batch's trimmed length, and the frames up to the last end frame of the
    # rows that went silent (the content, without the babble past it)
    acfg = cfg.audio
    ended = [e for e in exit_run["end_frames"] if e < exit_run["frames"]]
    spans = {"t_gl": exit_run["t_gl"], **({"content": max(ended)} if ended else {})}
    kw = dict(n_fft=acfg.n_fft, hop_length=acfg.hop_length, win_length=acfg.win_length)
    rows = []
    for span, frames in spans.items():
        mag = spectrogram_magnitude(torch.from_numpy(out["linear"][:, :frames]).to(device), acfg)
        for n_iter in GL_ITERS:
            errs = {}
            for lowp in (False, True):
                with torch.no_grad():
                    spec = griffin_lim_spectrum(mag, n_iter=n_iter, momentum=0.0, lowp=lowp,
                                                **kw)
                errs["bf16" if lowp else "f32"] = magnitude_error(spec, mag, acfg)
            rows.append({"span": span, "frames": frames, "n_iter": n_iter, **errs,
                         "bf16_over_f32": errs["bf16"] / errs["f32"]})
    report["gl_bf16_vs_f32"] = {"batch": len(prompts), "rows": rows}
    print(json.dumps({"gl_bf16_vs_f32": report["gl_bf16_vs_f32"]}), flush=True)

    report["failed"] = failed
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"trained findings written: {args.out}; {card}", flush=True)
    if failed:
        raise SystemExit("; ".join(failed))


if __name__ == "__main__":
    main()
