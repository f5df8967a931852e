"""CLI: the alignment-learning evidence run, the port of the JAX package's ``scripts/alignment_run.py``.

    python -m tacotron_tpu_torch.cli.alignment_run [--preset tiny_cpu] [--set model.r=5]
        [--n-utts 16] [--text-len 14] [--char-sec 0.06] [--char-sec-jitter 0]
        [--batch-size 0] [--steps 3000] [--save-every 0] [--log-every 100]
        [--out artifacts/alignment] [--save-run RUN_DIR] [--resume-from RUN_DIR]
        [--platform cpu]

Trains on the char-tone corpus (``data/ljspeech.py::generate_char_tone_corpus``:
each character a tone whose pitch encodes it, so a monotonic alignment
exists) and records what the JAX script records, with the same flags and
defaults and the same files:

* the loss and attention-entropy curve every ``--log-every`` steps;
* each utterance's attention scores (``utils/metrics.py::alignment_scores``:
  monotonic fraction, diagonal correlation) from an eval-mode teacher-forced
  pass (running batch statistics, no update, prenet dropout from a
  generator seeded 0: JAX's ``eval_fwd``) over the fixed eval batch, on
  each utterance's true text length and decoder steps;
* ``OUT/summary.json`` (the JAX script's keys; ``backend`` is the card's
  name, or "cpu"), ``OUT/final_alignments.npy`` and ``OUT/alignment_utt0.png``
  (through matplotlib where it imports, else a plain heatmap; written with
  zlib), at the end and every ``--save-every`` steps.

The corpus and its packed features go under ``OUT_work/`` (the STFT of
the evidence runs: n_fft 512, win 400, hop 128, 80 mels; features on the
card, or the CPU with ``--platform cpu``). One bucket, loader seed 5, the
train state from seed 3, ``--batch-size 0`` overfits the one batch of all
``--n-utts``. The step is ``make_train_step``'s: on one card one CUDA graph
per batch shape, as JAX jits its step. ``--save-run`` writes a run directory
(``config.json`` and ``ckpt/step_N`` in the JAX package's layout,
``train/checkpoint.py``) every ``--save-every`` steps and at the end, which
``cli.synthesize`` and ``cli.audio_evidence`` read; ``--resume-from`` such
a directory continues from its latest checkpoint for ``--steps`` more steps
(the corpus is generated again from the same flags, so with the same
``--n-utts`` it is the same corpus). It runs on the card unless
``--platform cpu``; without a card and without that flag it raises.

The flagship recipe (JAX's ``scripts/r5_evidence_run.sh``, two phases):
``--preset full_1chip --set model.r=5 --char-sec 0.06 --char-sec-jitter 0.3
--text-len 20 --batch-size 32 --save-every 2500 --log-every 250``, 25,000
steps at ``--n-utts 512``, then ``--resume-from`` the run directory for
25,000 more at ``--n-utts 2048`` (``tools/r5_evidence_run.sh``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}
EVIDENCE_STFT = {"n_fft": 512, "win_length": 400, "hop_length": 128, "n_mels": 80}
LOADER_SEED, STATE_SEED, EVAL_DROPOUT_SEED = 5, 3, 0
SCORING = ("eval_fwd(train=False, fixed dropout key), per-utterance true lengths; "
           "the port: model.eval(), prenet dropout from a generator seeded 0")


def entropy(align: np.ndarray) -> float:
    a = np.clip(align, 1e-8, 1.0)
    return float(-(a * np.log(a)).sum(-1).mean())


def eval_fwd(model, text, text_len, mel):
    """The eval-mode teacher-forced pass -> alignments (B, dec_steps, T_in)
    f32: running batch statistics, no update, prenet dropout drawn from a
    generator seeded ``EVAL_DROPOUT_SEED``. The model's mode is restored."""
    import torch

    was_training = model.training
    dev = next(model.parameters()).device
    model.eval()
    try:
        with torch.no_grad():
            gen = torch.Generator(device=dev).manual_seed(EVAL_DROPOUT_SEED)
            out = model(text.to(dev), text_len.to(dev), gt_mel=mel.to(dev, torch.float32),
                        generator=gen)
    finally:
        model.train(was_training)
    return out.alignments.float()


def backend_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def save_alignment_png(path: str, alignment: np.ndarray, title: str) -> None:
    """``plot_alignment``'s image where matplotlib imports, else
    ``alignment_heatmap``'s; written by ``write_png``."""
    from tacotron_tpu_torch.utils.metrics import alignment_heatmap, plot_alignment, write_png

    try:
        img = plot_alignment(alignment, title=title)
    except ImportError as e:
        print(f"matplotlib unavailable ({e}): plain heatmap", flush=True)
        img = alignment_heatmap(alignment)
    write_png(path, img)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--n-utts", type=int, default=16)
    p.add_argument("--text-len", type=int, default=14)
    p.add_argument("--char-sec", type=float, default=0.06,
                   help="tone duration per character (decoder steps per character set "
                        "the alignment pressure)")
    p.add_argument("--char-sec-jitter", type=float, default=0.0,
                   help="random per-character duration in char_sec*[1-j,1+j]")
    p.add_argument("--alphabet-size", type=int, default=26)
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = overfit one fixed batch of all n-utts; >0 = shuffled "
                        "minibatches over the corpus")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="cpu: the plain PyTorch versions on the CPU; by default the card")
    p.add_argument("--preset", default="tiny_cpu")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable, e.g. --set model.r=5")
    p.add_argument("--out", default="artifacts/alignment")
    p.add_argument("--save-run", default=None,
                   help="also write a synthesize-compatible run dir (config.json + "
                        "ckpt/step_N) here")
    p.add_argument("--resume-from", default=None,
                   help="run dir written by --save-run: continue from its latest "
                        "checkpoint; --steps counts additional steps")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--save-every", type=int, default=0,
                   help="also score + write artifacts (and the run dir) every N steps")
    args = p.parse_args(argv)

    from tacotron_tpu_torch.config import AudioConfig, apply_overrides, get_config
    from tacotron_tpu_torch.data import ljspeech
    from tacotron_tpu_torch.data.loader import DataLoader, Dataset, device_prefetch, put_batch
    from tacotron_tpu_torch.runtime import resolve_device
    from tacotron_tpu_torch.train import checkpoint, create_train_state, make_train_step
    from tacotron_tpu_torch.utils.metrics import alignment_scores

    device = resolve_device(PLATFORMS[args.platform] if args.platform else None)
    acfg = AudioConfig(**EVIDENCE_STFT)
    # keyed to --out: two runs at once must not share packed arrays
    root = os.path.abspath(args.out).rstrip("/") + "_work"
    ljspeech.generate_char_tone_corpus(
        os.path.join(root, "corpus"), n=args.n_utts, text_len=args.text_len,
        alphabet_size=args.alphabet_size, char_sec=args.char_sec,
        char_sec_jitter=args.char_sec_jitter)
    ljspeech.preprocess(os.path.join(root, "corpus"), os.path.join(root, "data"), acfg,
                        chunk=8, device=device)
    ds = Dataset(os.path.join(root, "data"))

    cfg = apply_overrides(get_config(args.preset), args.overrides)
    cfg = dataclasses.replace(
        cfg, audio=acfg,
        model=dataclasses.replace(cfg.model, vocab_size=max(32, len(ds.vocab)),
                                  n_freq=acfg.n_freq))
    r = cfg.model.r
    loader = DataLoader(ds, batch_size=args.batch_size or args.n_utts, num_buckets=1, r=r,
                        seed=LOADER_SEED)
    stream = iter(loader)
    batches = device_prefetch(stream, lambda b: put_batch(b, device))
    # the fixed eval batch (= the train batch at B 0); a batch's pinned host
    # tensors stay referenced until its step is enqueued
    b, (eval_batch, pinned) = next(batches)

    state = create_train_state(cfg, seed=STATE_SEED, device=device)
    step0 = 0
    if args.resume_from:
        state, step0 = checkpoint.restore(os.path.join(args.resume_from, "ckpt"), state,
                                          cfg.train)
        print(f"resumed from {args.resume_from} at step {step0}", flush=True)
    step_fn = make_train_step(cfg)

    curve = []
    text_lens = [int(x) for x in b.text_len]
    frame_steps = [int(x) // r for x in b.frame_len]
    os.makedirs(args.out, exist_ok=True)

    def save_run(at_step):
        os.makedirs(args.save_run, exist_ok=True)
        with open(os.path.join(args.save_run, "config.json"), "w") as f:
            f.write(cfg.to_json())
        return checkpoint.save(os.path.join(args.save_run, "ckpt"), at_step, state, cfg.train)

    def score_and_save(at_step):
        al = eval_fwd(state.model, *eval_batch[:3]).cpu().numpy()   # (B, dec_steps, T_in)
        scores = [alignment_scores(al[j], text_lens[j], frame_steps[j]) for j in range(len(al))]
        summary = {
            "steps": at_step,
            "n_utts": args.n_utts,
            "text_len": args.text_len,
            "text_lens": text_lens,
            "frame_steps": frame_steps,
            "args": dict(vars(args)),
            "scoring": SCORING,
            "final": curve[-1] if curve else None,
            "monotonic_frac_mean": float(np.mean([s["monotonic_frac"] for s in scores])),
            "monotonic_frac_min": float(np.min([s["monotonic_frac"] for s in scores])),
            "diag_corr_mean": float(np.mean([s["diag_corr"] for s in scores])),
            "diag_corr_min": float(np.min([s["diag_corr"] for s in scores])),
            "per_utt": scores,
            "curve": curve,
            "backend": backend_name(device),
        }
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        np.save(os.path.join(args.out, "final_alignments.npy"), al)
        save_alignment_png(os.path.join(args.out, "alignment_utt0.png"),
                           al[0, :frame_steps[0], :text_lens[0]],
                           f"char-tone utt0 @ step {at_step}")
        print(json.dumps({k: summary[k] for k in
                          ("monotonic_frac_mean", "diag_corr_mean", "final")}), flush=True)

    last = step0 + args.steps
    try:
        for i in range(step0 + 1, last + 1):
            batch = eval_batch
            if args.batch_size:
                _, (batch, pinned) = next(batches)
            state, m, al = step_fn(state, *batch)
            if i % args.log_every == 0 or i == last:
                row = {"step": i, "total_loss": float(m["total_loss"]),
                       "mel_loss": float(m["mel_loss"]),
                       "linear_loss": float(m["linear_loss"]),
                       "entropy": entropy(al.float().cpu().numpy())}
                curve.append(row)
                print(f"step {i:5d}  loss {row['total_loss']:.4f}  mel {row['mel_loss']:.4f}  "
                      f"entropy {row['entropy']:.3f}", flush=True)
            if args.save_every and i % args.save_every == 0 and i < last:
                score_and_save(i)
                if args.save_run:     # a cut run still leaves a checkpoint
                    save_run(i)
    finally:
        batches.close()
        stream.close()

    score_and_save(last)
    if args.save_run:
        path = save_run(state.step)
        print(f"run dir written: {args.save_run} (ckpt {path})", flush=True)


if __name__ == "__main__":
    main()
