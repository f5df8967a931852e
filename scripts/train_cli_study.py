#!/usr/bin/env python3
"""Spread of the two checks of ``chip_smoke.py`` [train-cli] whose inputs
move from run to run (the CLI's training is not bit-reproducible on the
card, so its weights and the eval's magnitudes differ a little each time).

    python3 scripts/train_cli_study.py      # on the card, ~90 s

Runs [train-cli] once, then on the run's own checkpoints:

* the Griffin-Lim kernel's single steps (the streaming kernel, bit-equal to
  the whole-loop kernel at momentum 0) against the plain bf16 step and the
  same step summed in f64, on the eval's magnitudes at seeds 0-3 of the
  checkpoints at steps 20 (f32) and 30 (bf16): per depth the largest
  component error over the magnitude's peak and the components past one
  bf16 ulp of the peak;
* ``check_train_cli_kernels`` (f32) on the loader's batches 0-5 at the
  checkpoints of steps 10 and 20: each gradient's distance through K1/K2,
  the largest gradient entry, failures reported and not raised.

Every check of chip_smoke.py it runs reports a failure instead of raising.
Prints one JSON line with the worst of each. Needs one card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def gl_steps(name, mag, acfg):
    from tacotron_tpu_torch.dsp.fused_gl import (f64_matmul, gl_step_reference,
                                                 griffin_lim_step, zero_phase)
    kw, peak = cs.gl_kw(acfg), float(mag.max())
    tol = cs.GL_PATH["step_tol"] * peak
    out = []
    re, im = zero_phase(mag, True)
    with torch.no_grad():
        for depth in range(max(cs.GL_PATH["step_depths"]) + 1):
            pr, pi = gl_step_reference(re, im, mag, **kw)
            if depth in cs.GL_PATH["step_depths"]:
                kern = griffin_lim_step(re, im, mag, **kw)
                f64 = gl_step_reference(re, im, mag, product=f64_matmul, **kw)
                row = {"depth": depth}
                for tag, a, b in (("kernel_plain", kern, (pr, pi)), ("plain_f64", (pr, pi), f64)):
                    d = torch.stack([(x.float() - y.float()).abs() for x, y in zip(a, b)])
                    row[tag] = float(d.max()) / peak
                    row[tag + "_past_ulp"] = int((d > tol).sum())
                row["components"] = 2 * mag.numel()
                out.append(row)
                cs.log(f"  {name} depth {depth}: kernel-plain {row['kernel_plain']:.3e} "
                       f"({row['kernel_plain_past_ulp']} past one ulp), plain f32-f64 "
                       f"{row['plain_f64']:.3e} ({row['plain_f64_past_ulp']})")
            re, im = pr, pi
    return out


def main():
    if not torch.cuda.is_available():
        print("train_cli_study: no CUDA device", file=sys.stderr)
        return 2
    from tacotron_tpu_torch import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = cs.smi()
    cs.log(f"card: {card}")
    runtime.build()
    failures = []
    require = cs.require
    cs.require = lambda ok, what: (cs.log(f"  {'ok' if ok else 'FAILED'}: {what}")
                                   or (None if ok else failures.append(what)))
    try:
        return study(card, failures)
    finally:
        cs.require = require


def study(card, failures):
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.data.loader import DataLoader, Dataset, put_batch
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.infer import Synthesizer
    from tacotron_tpu_torch.train import checkpoint, create_train_state
    from tacotron_tpu_torch.weights import split_state

    cs.phase_train_cli({})

    root = os.path.join(ROOT, "build", "chip_smoke_train")
    ckpt = os.path.join(root, "run", "ckpt")
    ds = Dataset(os.path.join(root, "data"))
    with open(os.path.join(root, "run", "config.json")) as f:
        cfg16 = Config.from_json(f.read())
    cfg32 = cfg16.replace(model=dataclasses.replace(cfg16.model, compute_dtype="float32",
                                                    tf_decoder="scan", remat_decoder=False))
    steps = []
    for step, cfg in ((20, cfg32), (30, cfg16)):
        state, _ = checkpoint.restore(ckpt, create_train_state(cfg, seed=1), cfg.train, step)
        synth = Synthesizer(cfg, *split_state(state.model), ds.vocab)
        del state
        for seed in range(4):
            res = synth(["the quick brown fox jumps over the lazy dog"], gl_iters=1, seed=seed)
            t_gl = res["wavs"].shape[1] // cfg.audio.hop_length + 1
            mag = spectrogram_magnitude(torch.from_numpy(res["linear"][:, :t_gl]).cuda(),
                                        cfg.audio)
            steps.append({"step": step, "seed": seed,
                          "depths": gl_steps(f"step {step} seed {seed}", mag, cfg.audio)})
        del synth

    grads = []
    batches = list(DataLoader(ds, batch_size=cfg32.train.batch_size,
                              num_buckets=cfg32.data.num_buckets, r=cfg32.model.r,
                              seed=cfg32.train.seed, use_native=False).epoch())
    for i in range(6):
        for step in (10, 20):
            cs.log(f"== batch {i}, checkpoint {step}")
            r = cs.check_train_cli_kernels(cfg32, ckpt, step,
                                           put_batch(batches[i], "cuda")[0], False)
            grads.append({"batch": i, "step": step,
                          "worst_grad_err_of_peak": r["worst_grad_err_of_peak"],
                          "largest_grad": r["largest_grad"],
                          "largest_grad_err": r["largest_grad_err"],
                          "worst_grad_err_of_tol": r["worst_grad_err_of_tol"]})
    rows = [d for s in steps for d in s["depths"]]
    print(json.dumps({
        "card": card,
        "gl_step_worst_kernel_plain": max(r["kernel_plain"] for r in rows),
        "gl_step_worst_plain_f64": max(r["plain_f64"] for r in rows),
        "gl_step_past_ulp_by_magnitude": [sum(d["kernel_plain_past_ulp"] for d in s["depths"])
                                          for s in steps],
        "gl_step_components_per_magnitude": sum(d["components"] for d in steps[0]["depths"]),
        "grad_worst_of_tol": max(g["worst_grad_err_of_tol"] for g in grads),
        "grad_largest_err": max(g["largest_grad_err"] for g in grads),
        "grad_checks": grads, "failures": failures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
