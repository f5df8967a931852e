#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tacotron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as the quickest proof
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi); no GPU -> exit 2;
2. build every kernel from the sources in the checkout (one nvcc each,
   started together) and time the build;
3. each kernel against its plain PyTorch version on the card, TF32 off:
   the fused decode (full synth_gl1000 widths, B 8, T_in ~120, 50 steps)
   in f32 and bf16 storage, its dropout keep rate and seed dependence; the
   Griffin-Lim kernel at 2048/275/1102, B 4, F 400, 10 iterations, momentum
   0 and 0.99; a small end-to-end check, the fused Synthesizer against
   the step-by-step one with every plain version; the attention energy
   (K1) and its backward (K2) at B 32, T_in 128, A 256 against autograd
   through the plain formula; and the teacher-forced loss and every
   parameter gradient on the tiny config through K1/K2 against the plain
   formula, for both decoder forms, with and without remat;
4. the synthesis path: ``Synthesizer(fused=True)`` at the synth_gl1000
   config (256-d model, r 2, 500 decode steps, Griffin-Lim 1000) on 8
   prompts with seeded random weights: one warm call, then one timed call
   with the launch counts set to 0 just before it; per-stage milliseconds
   and audio-seconds per second;
5. K3's and K4's time at that path's shapes beside its plain version, a
   library yardstick and its bound;
6. the training path: ``create_train_state`` + ``train_step`` at the
   full_1chip widths (hoisted teacher-forced decoder, fused energy, remat,
   f32) on B 32, T_in 128, T_out 400: one warm step, then 5 timed steps
   with the launch counts set to 0 just before them; step milliseconds,
   train frames per second, peak memory and a forward / backward /
   optimizer split; the device's busy share of one profiled step; the
   same steps through the plain energy, interleaved with the fused ones;
7. K1's and K2's time at that path's shapes beside the plain version and
   the bound; one JSON line with all four kernels;
8. last line: {"ok": true, "device": {...}}.

``--report PATH`` also writes every check and measurement as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# kernel vs plain at the main path's shapes: decode frames max abs error
# (bf16 storage, 500 autoregressive steps; 3.0e-3 measured on an H100);
# GL waveform max abs error over its peak after 1000 iterations (2.0e-2
# measured: 1000 iterations carry f32 rounding differences into the phase,
# which GL does not pin down), so GL is also held to converge as well as
# the plain loop, as tests/unit/test_pallas_gl.py holds its kernels:
# magnitude error <= plain's * 1.05 + 1e-3
MAIN_TOL = {"decode": 2e-2, "griffin_lim": 5e-2}
# K1/K2 vs autograd through the plain formula, f32 (summation order only):
# max abs error of e, dkeys, dq and dv each within this fraction of its peak
ENERGY_TOL = 1e-5
# the training main path: full_1chip widths, B 32, T_in 128, T_out 400
TRAIN_B, TRAIN_T_IN, TRAIN_T_OUT, TRAIN_STEPS = 32, 128, 400, 5

PROMPTS = [
    "The birch canoe slid on the smooth planks, and the boy glued the sheet to the dark blue background.",
    "It is easy to tell the depth of a well, but four hours of steady work faced us before the sun went down.",
    "A large size in stockings is hard to sell, so the merchant kept them in the back of the narrow shop all winter.",
    "The juice of lemons makes fine punch; the box was thrown beside the parked truck near the old stone bridge.",
    "Glue the sheet to the dark blue background, then rake the leaves into a pile and let the wind carry them off.",
    "These days a chicken leg is a rare dish, and the hogs were fed chopped corn and garbage before the market opened.",
    "Rice is often served in round bowls; the small pup gnawed a hole in the sock while the family slept late.",
    "Four hours of steady work faced us, and a rod is used to catch pink salmon in the cold rivers of the north.",
]


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def device_kernels(fn, reps: int = 1):
    """Run ``fn`` ``reps`` times under torch.profiler -> {kernel name:
    (device ms per rep, launches per rep)}, device-side events only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def full_model(cfg, dev, seed=0):
    from tacotron_tpu_torch.models.tacotron import Tacotron
    from tacotron_tpu_torch.weights import init_params
    return init_params(Tacotron(cfg.model, device=dev), seed=seed).eval()


def decoder_inputs(model, vocab, dev, b=8, seed=1):
    """memory, keys, mask of real encoder passes over random text."""
    from tacotron_tpu_torch.models.tacotron import length_mask
    g = torch.Generator().manual_seed(seed)
    t_in = 120
    lengths = torch.tensor([120, 96, 111, 80, 120, 64, 101, 90][:b])
    text = torch.randint(1, len(vocab), (b, t_in), generator=g)
    text = torch.where(length_mask(t_in, lengths), text, 0)
    text, lengths = text.to(dev), lengths.to(dev)
    with torch.no_grad():
        memory = model.encoder(text, lengths, torch.Generator(device=dev).manual_seed(seed))
        keys = model.memory_proj(memory)
    return memory, keys, length_mask(t_in, lengths)


def bound(byts, flops, peak):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and operations over the peak rate of their type."""
    tb, to = byts / HBM_BYTES_PER_S, flops / peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def decode_bound(w, memory, keys, n_steps, lowp=True):
    """Each input read once (weights, memory, keys, mask), frames and
    alignments written once; per row and step 2 flops per weight MAC plus
    the energy (add, tanh, multiply-add) and the context multiply-add."""
    b, t_in, m = memory.shape
    es = 2 if lowp else 4
    byts = (sum(x.numel() for x in w) + memory.numel() + keys.numel()) * es \
        + b * t_in * 4 + b * n_steps * (w.f_w.shape[0] + t_in) * 4
    macs = sum(x.numel() for x in w if x.ndim == 2)
    flops = n_steps * b * (2 * macs + 3 * t_in * keys.shape[2] + 2 * t_in * m)
    return bound(byts, flops, PEAK_FLOPS["bf16" if lowp else "f32"])


def gl_bound(mag_shape, win, n_iter):
    """Per iteration the synthesis and analysis products over the window's
    nonzero span: 2 x rows x win x 2*n_bins multiply-adds in f32; the
    magnitude is read once and the (re, im) spectrum written once."""
    *batch, f, nb = mag_shape
    rows = int(np.prod(batch)) * f
    return bound(rows * nb * 4 * 3, n_iter * 2 * 2 * rows * win * 2 * nb, PEAK_FLOPS["f32"])


def sample_magnitude(b, f, acfg, dev, seed):
    from tacotron_tpu_torch.dsp.dft import stft_mm
    g = torch.Generator().manual_seed(seed)
    y = torch.cumsum(torch.randn(b, acfg.hop_length * (f - 1), generator=g), -1) * 0.1
    y = (y - y.mean(-1, keepdim=True)).to(dev)
    re, im = stft_mm(y, acfg.n_fft, acfg.hop_length, acfg.win_length)
    return torch.sqrt(re * re + im * im + 1e-12)


def phase_kernels(report):
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.dsp.dft import gl_spectrum_mm, istft_mm
    from tacotron_tpu_torch.dsp.fused_gl import griffin_lim_spectrum
    from tacotron_tpu_torch.ops.decode_loop import (decode_loop, decode_loop_reference,
                                                    pack_decoder_weights)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("synth_gl1000")
    vocab = Vocab.build(PROMPTS)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    model = full_model(cfg, dev)
    memory, keys, mask = decoder_inputs(model, vocab, dev)
    w = pack_decoder_weights(model.decoder.cell)
    n = 50
    checks = report.setdefault("checks", {})

    log("[K3] fused decode vs plain, B 8, T_in 120, 50 steps")
    # (frames, alignments) max abs error; f32: summation order only; bf16:
    # rounding to bf16 flips where the two sums differ in the last bit
    tol = {False: (1e-4, 1e-5), True: (0.02, 1e-3)}
    for lowp in (False, True):
        with torch.no_grad():
            kf, ka = decode_loop(memory, keys, mask, w, n_steps=n, dropout=False, lowp=lowp)
            pf, pa = decode_loop_reference(memory, keys, mask, w, n_steps=n,
                                           dropout=False, lowp=lowp)
        torch.cuda.synchronize()
        ef, ea = max_err(kf, pf), max_err(ka, pa)
        scale = float(pf.abs().max())
        name = "decode_f32" if not lowp else "decode_bf16"
        checks[name] = {"frames_max_abs_err": ef, "aligns_max_abs_err": ea,
                        "frames_peak": scale, "tol": tol[lowp]}
        log(f"  {name}: frames err {ef:.3e} (peak {scale:.3f}), aligns err {ea:.3e}")
        require(bool(torch.isfinite(kf).all()), f"{name} frames finite")
        require(ef <= tol[lowp][0] and ea <= tol[lowp][1],
                f"{name} within tolerance frames {tol[lowp][0]}, alignments {tol[lowp][1]}")
        require(bool((ka[1, :, 96:] < 1e-6).all()), f"{name} mask respected")

    with torch.no_grad():
        f1, _, kc = decode_loop(memory, keys, mask, w, n_steps=n, seed=1,
                                dropout_rate=0.5, return_keep_counts=True)
        f2, _ = decode_loop(memory, keys, mask, w, n_steps=n, seed=2, dropout_rate=0.5)
        f1b, _ = decode_loop(memory, keys, mask, w, n_steps=n, seed=1, dropout_rate=0.5)
    units = memory.shape[0] * n * (w.p_w0.shape[0] + w.p_w1.shape[0])
    keep_rate = float(kc.sum()) / units
    checks["decode_dropout"] = {"keep_rate": keep_rate, "units": units}
    log(f"  dropout keep rate {keep_rate:.5f} over {units} units")
    require(abs(keep_rate - 0.5) <= 0.01, "dropout keep rate within 0.5 +- 0.01")
    require(not torch.allclose(f1, f2), "different seeds give different frames")
    require(torch.equal(f1, f1b), "the same seed gives the same frames")

    log("[K4] Griffin-Lim kernel vs plain, 2048/275/1102, B 4, F 400, 10 iterations")
    acfg = cfg.audio
    mag = sample_magnitude(4, 400, acfg, dev, seed=3)
    kw = dict(n_fft=acfg.n_fft, hop_length=acfg.hop_length, win_length=acfg.win_length)
    for mom in (0.0, 0.99):
        with torch.no_grad():
            kre, kim = griffin_lim_spectrum(mag, n_iter=10, momentum=mom, **kw)
            pre, pim = gl_spectrum_mm(mag, n_iter=10, momentum=mom, **kw)
            kwav = istft_mm(kre, kim, **kw)
            pwav = istft_mm(pre, pim, **kw)
        peak = float(pwav.abs().max())
        err = max_err(kwav, pwav) / peak
        name = f"griffin_lim_m{mom}"
        checks[name] = {"wav_max_abs_err_over_peak": err, "tol": 1e-3}
        log(f"  {name}: wav err / peak {err:.3e}")
        require(bool(torch.isfinite(kwav).all()) and err <= 1e-3,
                f"{name} within 1e-3 of the peak")

    log("[e2e] fused Synthesizer (kernels) vs step-by-step Synthesizer (plain), "
        "dropout 0, 20 steps, GL 5")
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.weights import split_state
    c0 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, prenet_dropout=0.0))
    p, bs = split_state(model)
    cref = dataclasses.replace(c0, audio=dataclasses.replace(c0.audio, gl_backend="mm_f32"))
    a = Synthesizer(c0, p, bs, vocab, fused=True)(PROMPTS[:2], n_steps=20, gl_iters=5)
    r = Synthesizer(cref, p, bs, vocab, fused=False)(PROMPTS[:2], n_steps=20, gl_iters=5)
    em = float(np.abs(a["mel"] - r["mel"]).max())
    checks["e2e"] = {"mel_max_abs_err": em,
                     "align_max_abs_err": float(np.abs(a["alignments"] - r["alignments"]).max())}
    log(f"  e2e: mel err {em:.3e}")
    np.testing.assert_allclose(a["mel"], r["mel"], rtol=0.1, atol=0.05)
    np.testing.assert_allclose(a["linear"], r["linear"], rtol=0.1, atol=0.05)
    require(a["wavs"].shape == r["wavs"].shape and np.isfinite(a["wavs"]).all(),
            "e2e mel/linear within rtol 0.1 atol 0.05 (bf16 decode vs f32), wavs finite")
    return cfg, vocab


def energy_inputs(dev, b, t, a, seed=0):
    g = torch.Generator().manual_seed(seed)
    keys, q = torch.randn(b, t, a, generator=g), torch.randn(b, a, generator=g)
    v, de = torch.randn(a, 1, generator=g) * 0.3, torch.randn(b, t, generator=g)
    return [x.to(dev) for x in (keys, q, v, de)]


def energy_check(keys, q, v, de):
    """K1/K2 against autograd through the plain formula on the same
    inputs -> {name: (max abs error, peak)} for e, dkeys, dq, dv, and dv of
    a second run."""
    from tacotron_tpu_torch.ops.attn_energy import attention_energy, attention_energy_reference
    leaves = [x.detach().clone().requires_grad_(True) for x in (keys, q, v)]
    e = attention_energy(*leaves)
    got = (e, *torch.autograd.grad(e, leaves, de))
    dv2 = torch.autograd.grad(attention_energy(*leaves), leaves, de)[2]
    ref_leaves = [x.detach().clone().requires_grad_(True) for x in (keys, q, v)]
    e_ref = attention_energy_reference(*ref_leaves)
    want = (e_ref, *torch.autograd.grad(e_ref, ref_leaves, de))
    torch.cuda.synchronize()
    out = {n: (max_err(g, w), float(w.detach().abs().max()))
           for n, g, w in zip(("e", "dkeys", "dq", "dv"), got, want)}
    return out, torch.equal(dv2, got[3])


def phase_energy(report):
    log("[K1/K2] attention energy and its backward vs autograd through the plain "
        "formula, B 32, T_in 128, A 256, f32")
    errs, same_dv = energy_check(*energy_inputs(torch.device("cuda"), 32, 128, 256))
    report["checks"]["attn_energy"] = {"errors": errs, "dv_bit_identical": same_dv,
                                       "tol_of_peak": ENERGY_TOL}
    for n, (err, peak) in errs.items():
        log(f"  {n}: max abs err {err:.3e} (peak {peak:.3f})")
        require(err <= ENERGY_TOL * peak, f"{n} within {ENERGY_TOL} of its peak")
    require(same_dv, "dv bit-identical across two runs")


def phase_train_e2e(report):
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.models.tacotron import Tacotron
    from tacotron_tpu_torch.train.loss import tacotron_loss
    from tacotron_tpu_torch.weights import init_params

    dev = torch.device("cuda")
    log("[train-e2e] tiny config, dropout 0, B 3, 4 decoder steps: loss and every "
        "parameter gradient, fused (K1/K2) vs xla (plain)")
    base = dataclasses.replace(get_config("tiny_cpu").model, vocab_size=32, prenet_dropout=0.0)
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 30, (3, 9), generator=g).to(dev)
    lengths = torch.tensor([9, 6, 4], device=dev)
    mel = torch.rand(3, 20, 80, generator=g).to(dev)
    linear = torch.rand(3, 20, base.n_freq, generator=g).to(dev)
    checks = report["checks"].setdefault("train_e2e", {})
    for form in ("scan", "hoisted"):
        for remat in (False, True):
            res = {}
            for energy in ("xla", "fused"):
                cfg = dataclasses.replace(base, tf_decoder=form, remat_decoder=remat,
                                          attention_energy=energy)
                model = init_params(Tacotron(cfg, device=dev), seed=0).train()
                before = dict(runtime.LAUNCHES)
                o = model(text, lengths, gt_mel=mel)
                loss, _ = tacotron_loss(o.mel, o.linear, mel, linear)
                loss.backward()
                torch.cuda.synchronize()
                n = {k: runtime.LAUNCHES[k] - before.get(k, 0)
                     for k in ("attn_energy_fwd", "attn_energy_bwd")}
                res[energy] = (loss.item(), {k: p.grad for k, p in model.named_parameters()}, n)
            name = f"{form}_remat{int(remat)}"
            loss_rel = abs(res["fused"][0] - res["xla"][0]) / abs(res["xla"][0])
            worst = max(float((res["fused"][1][k] - w).abs().max()) / (float(w.abs().max()) + 1e-12)
                        for k, w in res["xla"][1].items())
            checks[name] = {"loss_rel_err": loss_rel, "worst_grad_err_of_peak": worst,
                            "launches": res["fused"][2]}
            log(f"  {name}: loss rel err {loss_rel:.3e}, worst grad err / peak {worst:.3e}, "
                f"launches {res['fused'][2]}")
            require(res["fused"][2] == {"attn_energy_fwd": 4 * (1 + remat), "attn_energy_bwd": 4}
                    and res["xla"][2] == {"attn_energy_fwd": 0, "attn_energy_bwd": 0},
                    f"{name}: K1 {4 * (1 + remat)} and K2 4 launches through fused, none through xla")
            require(loss_rel <= 1e-5, f"{name}: loss within rel 1e-5")
            for k, w in res["xla"][1].items():
                err = float((res["fused"][1][k] - w).abs().max())
                if err > 1e-4 * float(w.abs().max()) + 1e-7:
                    raise AssertionError(f"{name}: gradient {k} off by {err:.3e}")
            log(f"  ok: {name}: every gradient within 1e-4 of its peak + 1e-7")


def phase_main(report, cfg, vocab):
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.infer.synthesize import STAGES, Synthesizer
    from tacotron_tpu_torch.weights import split_state

    dev = torch.device("cuda")
    log("[main] Synthesizer(fused=True), synth_gl1000, B 8, 500 steps, GL 1000")
    p, bs = split_state(full_model(cfg, dev))
    synth = Synthesizer(cfg, p, bs, vocab, fused=True)
    t0 = time.perf_counter()
    synth(PROMPTS, seed=0)
    warm_s = time.perf_counter() - t0
    runtime.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = synth(PROMPTS, seed=1, stage_ms=True)
    wall = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    wav = out["wavs"]
    log(f"  warm call {warm_s:.3f} s, timed call {wall:.3f} s")
    for s in STAGES:
        log(f"  stage {s}: {out['stage_ms'][s]:.3f} ms")
    aps = out["audio_seconds"] / wall
    log(f"  audio_seconds {out['audio_seconds']:.3f}, audio_seconds_per_s {aps:.3f}")
    log(f"  launches {launches}")
    require(launches.get("decode_loop", 0) > 0 and launches.get("griffin_lim", 0) > 0,
            "both kernels launched on the main path")
    require(wav.shape == (8, cfg.audio.hop_length * (2 * 500 - 1)), f"wav shape {wav.shape}")
    require(bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0,
            "wavs finite with a peak > 0")
    report["main"] = {"stage_ms": out["stage_ms"], "wall_s": wall, "warm_s": warm_s,
                      "audio_seconds": out["audio_seconds"],
                      "audio_seconds_per_s": aps, "launches": launches}
    return synth, out, launches


def phase_timing(report, synth, out, launches):
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.dsp.dft import gl_spectrum_mm, istft_mm, stft_mm
    from tacotron_tpu_torch.dsp.fused_gl import griffin_lim_spectrum, live_bases
    from tacotron_tpu_torch.ops.decode_loop import (decode_loop, decode_loop_reference,
                                                    pack_decoder_weights)

    dev = torch.device("cuda")
    cfg, m = synth.cfg, synth.model
    log("[timing] kernels at the main path's shapes")
    text, lengths = synth.encode_texts(PROMPTS)
    from tacotron_tpu_torch.models.tacotron import length_mask
    mask = length_mask(text.shape[1], lengths)
    with torch.no_grad():
        memory = m.encoder(text, lengths, torch.Generator(device=dev).manual_seed(0))
        keys = m.memory_proj(memory)
    w = pack_decoder_weights(m.decoder.cell)
    n = cfg.model.max_decode_steps
    dkw = dict(n_steps=n, dropout_rate=cfg.model.prenet_dropout)
    with torch.no_grad():
        k_ms = cuda_ms(lambda: decode_loop(memory, keys, mask, w, seed=5, **dkw), reps=3)
        p_ms = cuda_ms(lambda: decode_loop_reference(
            memory, keys, mask, w, generator=torch.Generator(device=dev).manual_seed(5), **dkw))
        # the same shapes, dropout off, kernel vs plain
        kf, ka = decode_loop(memory, keys, mask, w, n_steps=n, dropout=False)
        pf, pa = decode_loop_reference(memory, keys, mask, w, n_steps=n, dropout=False)
    d_err = max_err(kf, pf)
    report["checks"]["decode_bf16_main_shapes"] = {
        "frames_max_abs_err": d_err, "aligns_max_abs_err": max_err(ka, pa),
        "frames_peak": float(pf.abs().max()), "tol": MAIN_TOL["decode"]}
    log(f"  decode at main shapes: frames err {d_err:.3e}, aligns err {max_err(ka, pa):.3e}")
    require(d_err <= MAIN_TOL["decode"], f"decode at main shapes within {MAIN_TOL['decode']}")
    dbound = decode_bound(w, memory, keys, n)
    dec = {"name": "decode_loop", "route": "cuda",
           "source": "tacotron_tpu_torch/csrc/decode_loop.cu",
           "replaces": "tacotron_tpu/ops/pallas/decode_loop.py:103",
           "launches": launches.get("decode_loop", 0),
           "max_abs_err": d_err,
           "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": dbound[0], "bound_by": dbound[1], "library_ms": None,
           "shape": f"B {memory.shape[0]} T_in {memory.shape[1]} steps {n} bf16"}

    acfg = cfg.audio
    mag = spectrogram_magnitude(torch.from_numpy(out["linear"]).to(dev), acfg)
    kw = dict(n_fft=acfg.n_fft, hop_length=acfg.hop_length,
              win_length=acfg.win_length, n_iter=acfg.griffin_lim_iters,
              momentum=acfg.gl_momentum)
    res = {}
    with torch.no_grad():
        gk_ms = cuda_ms(lambda: res.setdefault("kernel", griffin_lim_spectrum(mag, **kw)))
        gp_ms = cuda_ms(lambda: res.setdefault("plain", gl_spectrum_mm(mag, **kw)))
        ikw = dict(n_fft=acfg.n_fft, hop_length=acfg.hop_length, win_length=acfg.win_length)
        kwav, pwav = istft_mm(*res["kernel"], **ikw), istft_mm(*res["plain"], **ikw)
        # library yardstick: the iteration's two DFT products alone, as
        # torch.matmul calls over the same live span
        bwd_np, fwd_np = live_bases(acfg.n_fft, acfg.win_length)
        bwd, fwd = torch.from_numpy(bwd_np).to(dev), torch.from_numpy(fwd_np).to(dev)
        rows = mag.shape[0] * mag.shape[1]
        spec = torch.randn(rows, bwd.shape[0], device=dev)
        frames = torch.empty(rows, bwd.shape[1], device=dev)
        outp = torch.empty(rows, fwd.shape[1], device=dev)

        def products():
            for _ in range(acfg.griffin_lim_iters):
                torch.matmul(spec, bwd, out=frames)
                torch.matmul(frames, fwd, out=outp)
        gl_lib_ms = cuda_ms(products)
    gl_err = max_err(kwav, pwav) / float(pwav.abs().max())
    report["checks"]["griffin_lim_main_shapes"] = {"wav_max_abs_err_over_peak": gl_err,
                                                   "tol": MAIN_TOL["griffin_lim"]}
    log(f"  griffin_lim at main shapes ({acfg.griffin_lim_iters} iterations): "
        f"wav err / peak {gl_err:.3e}")
    require(gl_err <= MAIN_TOL["griffin_lim"],
            f"griffin_lim at main shapes within {MAIN_TOL['griffin_lim']} of the peak")

    def mag_err(wav):
        re, im = stft_mm(wav, **ikw)
        return float((torch.sqrt(re * re + im * im + 1e-12) - mag).abs().mean() / mag.mean())

    ek, ep = mag_err(kwav), mag_err(pwav)
    report["checks"]["griffin_lim_main_shapes"].update(mag_err_kernel=ek, mag_err_plain=ep)
    log(f"  griffin_lim magnitude error: kernel {ek:.5f}, plain {ep:.5f}")
    require(ek <= ep * 1.05 + 1e-3, "griffin_lim converges as well as the plain loop")
    gbound = gl_bound(tuple(mag.shape), acfg.win_length, acfg.griffin_lim_iters)
    gl = {"name": "griffin_lim", "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/griffin_lim.cu",
          "replaces": "tacotron_tpu/dsp/pallas_gl.py:419",
          "launches": launches.get("griffin_lim", 0),
          "max_abs_err": gl_err,
          "ms": gk_ms, "plain_ms": gp_ms,
          "bound_ms": gbound[0], "bound_by": gbound[1], "library_ms": gl_lib_ms,
          "shape": f"B {mag.shape[0]} F {mag.shape[1]} iters {acfg.griffin_lim_iters} f32"}
    for k in (dec, gl):
        log(f"  {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f} ms, "
            f"bound {k['bound_ms']:.3f} ms by {k['bound_by']}, library {k['library_ms']})")
    return [dec, gl]


def phase_train(report):
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.train import create_train_state, train_step
    from tacotron_tpu_torch.train.step import STAGES

    dev = torch.device("cuda")
    base = get_config("full_1chip")
    cfg = base.replace(model=dataclasses.replace(
        base.model, tf_decoder="hoisted", attention_energy="fused", remat_decoder=True))
    b, t_in, t_out = TRAIN_B, TRAIN_T_IN, TRAIN_T_OUT
    n_dec = t_out // cfg.model.r
    log(f"[train] train_step, full_1chip widths, hoisted + fused + remat, f32, "
        f"B {b}, T_in {t_in}, T_out {t_out}: 1 warm step, {TRAIN_STEPS} timed")
    state = create_train_state(cfg, seed=0)
    g = torch.Generator().manual_seed(0)         # the batch as bench.py makes it
    batch = [torch.randint(1, 60, (b, t_in), generator=g),
             torch.full((b,), t_in), torch.rand(b, t_out, cfg.model.n_mels, generator=g),
             torch.rand(b, t_out, cfg.model.n_freq, generator=g), torch.full((b,), t_out)]
    batch = [x.to(dev) for x in batch]
    t0 = time.perf_counter()
    state, m, _ = train_step(state, *batch, cfg=cfg)
    first = float(m["total_loss"])
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    runtime.LAUNCHES.clear()
    step_ms, stages, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m, align = train_step(state, *batch, cfg=cfg, stage_ms=True)
        losses.append(float(m["total_loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        stages.append(m["stage_ms"])
    launches = dict(runtime.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(step_ms))
    fps = b * t_out / (med / 1e3)
    split = {s_: float(np.median([st[s_] for st in stages])) for s_ in STAGES}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    log(f"  warm step {warm_s:.3f} s; losses {first:.5f} (warm) -> {losses}")
    log(f"  step ms median {med:.3f}, range {min(step_ms):.3f}-{max(step_ms):.3f} "
        f"over {TRAIN_STEPS} steps")
    log(f"  train frames/s {fps:.1f} (= {b} x {t_out} / median step s)")
    log(f"  split (median ms, CUDA events): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"  max_memory_allocated {peak / 2**30:.3f} GiB")
    log(f"  launches per step {per_step} ({n_dec} decoder steps)")
    require(all(np.isfinite(losses)) and np.isfinite(first), "losses finite")
    require(losses[-1] < first, "last loss below the first")
    require(tuple(align.shape) == (b, n_dec, t_in) and bool(torch.isfinite(align).all()),
            f"alignments finite, shape {(b, n_dec, t_in)}")
    require(per_step.get("attn_energy_fwd") == 2 * n_dec and per_step.get("attn_energy_bwd") == n_dec,
            f"K1 {2 * n_dec} launches per step (forward + remat recompute), K2 {n_dec}")
    report["train"] = {"step_ms": step_ms, "step_ms_median": med, "train_frames_per_s": fps,
                       "split_ms_median": split, "max_memory_allocated": peak,
                       "losses": [first] + losses, "warm_s": warm_s,
                       "launches": launches, "launches_per_step": per_step}
    report["train"]["profile"] = profile_step(state, batch, cfg, med)
    report["train"]["fused_vs_xla_step_ms"] = compare_energy_forms(state, batch, cfg)
    return state, batch, launches


def compare_energy_forms(state, batch, cfg, pairs: int = 3):
    """Step milliseconds of the same training steps through the fused
    energy and through the plain one (same weights), in the order fused,
    xla, xla, fused, repeated: the host's noise falls on both alike."""
    from tacotron_tpu_torch.train import create_train_state, train_step
    xcfg = cfg.replace(model=dataclasses.replace(cfg.model, attention_energy="xla"))
    runs = {"fused": [state, cfg, []], "xla": [create_train_state(xcfg, seed=0), xcfg, []]}
    runs["xla"][0].model.load_state_dict(state.model.state_dict())
    runs["xla"][0] = train_step(runs["xla"][0], *batch, cfg=xcfg)[0]     # warm
    for _ in range(pairs):
        for form in ("fused", "xla", "xla", "fused"):
            st, c, ms = runs[form]
            t0 = time.perf_counter()
            st, m, _ = train_step(st, *batch, cfg=c)
            float(m["total_loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
            runs[form][0] = st
    out = {form: r[2] for form, r in runs.items()}
    log("  fused vs xla energy, same steps interleaved: " + ", ".join(
        f"{f} median {np.median(v):.3f} ms (range {min(v):.3f}-{max(v):.3f})"
        for f, v in out.items()))
    return out


def profile_step(state, batch, cfg, step_ms):
    """One training step under torch.profiler: the kernels' device time,
    its share of the unprofiled median step (the device's busy share), and
    the kernels with the most device time."""
    from tacotron_tpu_torch.train import train_step
    rows = sorted(device_kernels(lambda: train_step(state, *batch, cfg=cfg)).items(),
                  key=lambda r: -r[1][0])
    busy = sum(ms for _, (ms, _) in rows)
    launches = sum(n for _, (_, n) in rows)
    log(f"  profile: device busy {busy:.3f} ms in {launches:.0f} kernel launches = "
        f"{100 * busy / step_ms:.1f}% of the median step ({step_ms:.3f} ms)")
    for k, (ms, n) in rows[:15]:
        log(f"    {ms:9.3f} ms  {n:6.0f}x  {k[:100]}")
    return {"device_busy_ms": busy, "kernel_launches": launches,
            "busy_share_of_median_step": busy / step_ms,
            "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in rows[:30]]}


def phase_train_timing(report, state, batch, launches):
    from tacotron_tpu_torch.ops.attn_energy import (attention_energy_reference, energy_bwd,
                                                    energy_fwd)

    dev = torch.device("cuda")
    m = state.model
    log("[timing] K1/K2 at the training path's shapes")
    with torch.no_grad():
        text, lengths = batch[0], batch[1]
        keys = m.memory_proj(m.encoder(text, lengths))
        h = torch.tanh(torch.randn(keys.shape[0], m.cfg.attention_gru_dim,
                                   generator=torch.Generator().manual_seed(1))).to(dev)
        q = m.decoder.cell.attention.query(h)
        v = m.decoder.cell.attention.v.detach()
    de = torch.randn(keys.shape[:2], generator=torch.Generator().manual_seed(2)).to(dev)
    errs, same_dv = energy_check(keys, q, v, de)
    report["checks"]["attn_energy_main_shapes"] = {"errors": errs, "dv_bit_identical": same_dv}
    for n, (err, peak) in errs.items():
        log(f"  {n} at main shapes: max abs err {err:.3e} (peak {peak:.3f})")
        require(err <= ENERGY_TOL * peak, f"{n} at main shapes within {ENERGY_TOL} of its peak")
    require(same_dv, "dv bit-identical across two runs at main shapes")

    # ms: the kernels' device time per call (torch.profiler); call_ms: CUDA
    # events around back-to-back calls, the Python wrapper included, which
    # is what a host-bound step pays per call
    reps = 200
    leaves = [x.detach().clone().requires_grad_(True) for x in (keys, q, v)]
    e_ref = attention_energy_reference(*leaves)
    calls = {"fwd": lambda: energy_fwd(keys, q, v),
             "fwd_plain": lambda: attention_energy_reference(keys, q, v),
             "bwd": lambda: energy_bwd(keys, q, v, de),
             "bwd_plain": lambda: torch.autograd.grad(e_ref, leaves, de, retain_graph=True)}
    dev_ms, call_ms = {}, {}
    for name, fn in calls.items():
        with torch.no_grad() if name != "bwd_plain" else torch.enable_grad():
            fn()
            call_ms[name] = cuda_ms(fn, reps)
            kern = device_kernels(fn, reps)
        dev_ms[name] = sum(ms for ms, _ in kern.values())
        log(f"  {name}: device {dev_ms[name] * 1e3:.2f} us per call in "
            f"{sum(n for _, n in kern.values()):.0f} kernels; {call_ms[name] * 1e3:.2f} us "
            f"per call with the host")
    f_ms, fp_ms, b_ms, bp_ms = (dev_ms[k] for k in ("fwd", "fwd_plain", "bwd", "bwd_plain"))
    b, t, a = keys.shape
    el = b * t * a
    # K1: keys, q, v read, e written; add, tanh, multiply, accumulate per element.
    # K2: keys, q, v, de read, dkeys, dq, dv written; add, tanh, 1 - t^2,
    # de * v, times (1 - t^2), dq accumulate, t * de, dv accumulate per element.
    fb = bound((el + b * a + a + b * t) * 4, 4 * el, PEAK_FLOPS["f32"])
    bb = bound((2 * el + 2 * b * a + 2 * a + b * t) * 4, 9 * el, PEAK_FLOPS["f32"])
    per_step = {k: launches.get(k, 0) / TRAIN_STEPS for k in ("attn_energy_fwd", "attn_energy_bwd")}
    shape = f"B {b} T_in {t} A {a} f32"
    k1 = {"name": "attn_energy_fwd", "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/attn_energy.cu",
          "replaces": "tacotron_tpu/ops/pallas/attn_energy.py:63",
          "launches": launches.get("attn_energy_fwd", 0), "max_abs_err": errs["e"][0],
          "ms": f_ms, "plain_ms": fp_ms, "bound_ms": fb[0], "bound_by": fb[1],
          "library_ms": None, "shape": shape, "call_ms": call_ms["fwd"],
          "plain_call_ms": call_ms["fwd_plain"],
          "ms_per_step": f_ms * per_step["attn_energy_fwd"]}
    k2 = {"name": "attn_energy_bwd", "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/attn_energy.cu",
          "replaces": "tacotron_tpu/ops/pallas/attn_energy.py:69",
          "launches": launches.get("attn_energy_bwd", 0),
          "max_abs_err": max(errs[n][0] for n in ("dkeys", "dq", "dv")),
          "ms": b_ms, "plain_ms": bp_ms, "bound_ms": bb[0], "bound_by": bb[1],
          "library_ms": None, "shape": shape, "call_ms": call_ms["bwd"],
          "plain_call_ms": call_ms["bwd_plain"],
          "ms_per_step": b_ms * per_step["attn_energy_bwd"]}
    for k in (k1, k2):
        log(f"  {k['name']}: {k['ms'] * 1e3:.2f} us per launch, {k['ms_per_step']:.3f} ms per "
            f"step on the device (plain {k['plain_ms'] * 1e3:.2f} us, bound "
            f"{k['bound_ms'] * 1e3:.2f} us by {k['bound_by']}, library none)")
    return [k1, k2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel-vs-plain checks only")
    ap.add_argument("--report", help="write the checks and measurements here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tacotron_tpu_torch import runtime

    card = smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    report = {"card": card}
    t0 = time.perf_counter()
    paths = runtime.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.2f} s -> {[str(p) for p in paths.values()]}")
    for p in paths.values():
        log_path = p.with_suffix(".log")
        ptxas = [ln for ln in (log_path.read_text().splitlines() if log_path.exists() else [])
                 if "registers" in ln or "spill" in ln]
        for ln in ptxas:
            log(f"  ptxas: {ln.strip()}")

    cfg, vocab = phase_kernels(report)
    phase_energy(report)
    phase_train_e2e(report)
    kernels = None
    if not args.quick:
        synth, out, launches = phase_main(report, cfg, vocab)
        kernels = phase_timing(report, synth, out, launches)
        del synth, out
        state, batch, train_launches = phase_train(report)
        kernels = phase_train_timing(report, state, batch, train_launches) + kernels
        report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
