#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tacotron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as the quickest proof
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi); no GPU -> exit 2;
2. build every kernel from the sources in the checkout (one nvcc each,
   started together), time the build, and print each kernel's registers,
   spills and shared memory from the ``-Xptxas -v`` log (both instantiations
   of the fused decode held to no spills);
3. each kernel against its plain PyTorch version on the card, TF32 off:
   the fused decode (full synth_gl1000 widths, B 8, T_in ~120, 50 steps)
   in f32 and bf16 storage, at the cluster size it chooses (held > 1, every
   cluster resident) and at 1, its dropout keep rate, keep counts equal at
   both sizes, and seed dependence; the
   Griffin-Lim kernel (K4) at 2048/275/1102, B 4, F 400, 10 iterations,
   momentum 0 and 0.99, in its f32 (split TF32 products) and its bf16
   mode; the streaming Griffin-Lim kernel (K5) over 10 calls in both modes,
   and in f32 against K4; the probes (P1 at 48, 100 and 227 KiB, one KiB past the limit
   refused with the CUDA error shown; P2, two calls the same bits); a small
   end-to-end check, the
   fused Synthesizer against the step-by-step one with every plain
   version; the attention energy (K1) and its backward (K2) at B 32, T_in
   128, A 256 against autograd through the plain formula, and their bf16
   mode at B 32/T_in 128/A 256, B 6/T_in 37/A 256 and B 3/T_in 11/A 100
   (the scalar path) against the plain forward and ``energy_bwd_reference``
   and under autograd; and the teacher-forced loss and every parameter
   gradient on the tiny config through K1/K2 against the plain formula,
   for both decoder forms, with and without remat, and with
   remat_policy="save_attn" against "all" for both forms and both energies;
4. [main] the parity synthesis path: ``Synthesizer(fused=True)`` at the
   synth_gl1000 config (256-d model, r 2, 500 decode steps, Griffin-Lim
   1000, the kernel's bf16 mode by default) on 8 prompts with seeded random
   weights: one warm call, then one timed call with the launch counts set
   to 0 just before it; per-stage milliseconds and audio-seconds per
   second; then Griffin-Lim once more on the same spectrogram through the
   f32 kernel, each launch's device time by torch.profiler;
5. [fast] the production serving path: ``Synthesizer`` at the synth_fast
   config (early-exit decode, trimming before Griffin-Lim, momentum 0.99 x
   100 iterations in bf16) on the same prompts and weights: one warm and
   one timed call; then a call whose silence threshold is derived from the
   first call's per-step peaks so that the decode exits strictly inside
   (0, 500) and Griffin-Lim runs on a trimmed spectrogram, held against
   its plain version at that shape, on the run's magnitudes and on a
   speech-like one (with random weights the one exit any threshold reaches
   is after the first ``min_silence_steps`` steps, every end frame 0), and
   the f32 kernels' steps there against an f64 step (GL_F32_STEP_FACTOR);
6. [stream] ``griffin_lim(inner=1)``: 100 calls of the streaming kernel at
   B 8, F 1000 in bf16, against K4 and the plain step; [stream-f32] the same
   in f32, bit-equal to K4 f32, and the f32 kernels' steps against an f64
   step on [main]'s and a speech-like magnitude; and the probes' entry
   point;
7. K3's, K4's, K5's and the probes' time at their paths' shapes beside
   the plain version, a library yardstick and the bound (P1 at 48 and 227
   KiB; P2 with its floor, an empty kernel on the same cluster, threads and
   shared memory); K3 at every cluster size (1, 2, 4, 8, 16) with the card's count of
   resident clusters of each, microseconds per step and one cluster
   barrier's cost, the chosen size held at least 2x faster than 1; for
   the Griffin-Lim kernels in both modes each launch's device
   time per iteration (synthesis, overlap-add + frame, analysis, K5's
   pack), the achieved TFLOP/s and
   share of the bound, the device launches per iteration against
   ``runtime.LAUNCHES``, and a second yardstick at the padded shapes; K4's
   f32 mode against the plain f32 loop as [main] runs it (converging as
   well; its waveform held at least as close to the loop with f64 sums as
   the plain f32 loop's, the distance between the two f32 loops printed,
   as MAIN_TOL says); K4's
   bf16 mode against its plain version as [main] runs it (1000 iterations,
   momentum 0) and on a speech-like magnitude of that shape (9 and 10
   iterations); the magnitude error that the bf16 mode of Griffin-Lim
   reaches beside the f32 mode's;
8. the training path: ``create_train_state`` + ``train_step`` at the
   full_1chip widths (hoisted teacher-forced decoder, fused energy, remat,
   f32) on B 32, T_in 128, T_out 400: one warm step, then 3 timed steps
   with the launch counts set to 0 just before them; step milliseconds,
   train frames per second, peak memory and a forward / backward /
   optimizer split; the device's busy share of one profiled step; the
   same steps through the plain energy, interleaved with the fused ones;
9. K1's and K2's time at that path's shapes beside the plain version, the
   bound, the floor (an empty kernel launched on the same grid and
   clusters, ``probe.probe_empty``) and each one's device time per launch
   inside the profiled step; then [train-save-attn]: the same widths and
   batch on the plain energy, one warm and one timed step under
   remat_policy "all" and under "save_attn", the timed steps' peak memory
   apart by the kept tanh (S B T_in A 4 bytes) within 25%;
10. [train-bf16] bench.py's training recipe (compute_dtype="bfloat16",
   hoisted, remat, fused energy) at the same widths and batch, as 8: one
   warm and 5 timed steps, the profiled step (400 bf16 K1 and 200 bf16 K2
   kernels, one per call), the plain energy interleaved, f32 parameters and Adam
   moments; on one set of weights and dropout masks the loss through the
   plain energy beside the fused one and the mel against the f32 model's
   (JAX's drift rule); then bf16 K1's and K2's time at that path's shapes;
11. [main-bf16] ``Synthesizer(fused=True)`` at synth_gl1000 with
   compute_dtype="bfloat16" (K3 on bf16-computed keys, Griffin-Lim 100
   iterations to keep the script short): a warm and a timed call, and the
   mel's drift from [main]'s f32 mel, printed, not held (500 feed-previous
   steps on random weights may diverge);
12. [cli] the synthesis CLI at synth_gl1000: a run directory with the
   port's checkpoint of seeded random weights (restored and held equal),
   then ``cli.synthesize.main`` on 2 prompts with ``--fused`` (one K3 and
   3000 K4 launches counted) and with ``--preset synth_fast`` (300 K4
   launches), the wavs and the JSON line checked; then K3 and K4 held
   against their plain versions at the CLI's own inputs (its restored
   weights, prompts, seed and configs): K3 at the cluster size B 2 gives
   it, in both storage modes over 50 steps and in bf16 over 500; K4's bf16
   mode on each run's magnitudes, its first iteration and as GL_PATH sets
   out; one JSON line with all eleven kernel rows;
13. [train-cli] the data pipeline and the training CLI at full_1chip width:
   the char-tone corpus of the trained-weights recipe (256 utterances),
   ``cli.preprocess.main`` on the card (the first 16 utterances' f32
   features held against the CPU's at CLI_FEATURE_TOL), ``cli.train.main``
   at r 5 with the fused energy, B 32: 20 f32 steps (scan decoder, native
   assembler, a trace of steps 12-13, an eval at step 20: K4 bf16), then
   the resume to step 30 in bf16 with hoisted + remat and the device cache;
   each run's K1, K2 and K4 launches equal to what its steps' buckets (the
   loader's schedule replayed), decoder form, remat and eval give, the
   losses finite, the checkpoint restored bit for bit, the device cache's
   batches equal to the native assembler's (ms per batch of each), and
   K1/K2 (f32 and bf16) and K4 bf16 held against their plain versions on
   the runs' own inputs; the kernel rows gain ``train_cli_launches``;
14. last line: {"ok": true, "device": {...}}.

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
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# TF32 products per f32 product in the f32 Griffin-Lim kernels' bound: the
# least split that can stand for an f32 product, big.big + big.small +
# small.big. It does not depend on the build; the products the kernels take
# (tf32_products_taken) are reported beside it
TF32_PRODUCTS_BOUND = 3
# kernel vs plain at the main path's shapes: decode frames max abs error
# (bf16 storage, 500 autoregressive steps; 3.0e-3 measured on an H100);
# GL waveform max abs error over its peak after 1000 iterations: 1000
# iterations carry rounding differences into the phase, which GL does not
# pin down, so GL is also held to converge as well as the plain loop, as
# tests/unit/test_pallas_gl.py holds its kernels: magnitude error <= plain's
# * 1.05 + 1e-3. The f32 kernel's waveform is held against the same loop
# summed in f64 (gl_spectrum_reference with f64_matmul), the exact answer
# of the f32 loop's arithmetic: its distance from it, over the peak, at
# most "griffin_lim_f32_vs_f64" x the plain f32 loop's own distance from
# it (2.578e-2 against 5.225e-2 on an NVIDIA H100 80GB HBM3, 700.00 W). That
# guards against gross drift only: a build with one TF32 pass per product
# ends 0.490 from it and fails, but the two-piece split that the step rule
# rejects passes at 3.03e-2 (scripts/gl_tf32_precision.py, same card). Its
# distance from the plain f32 loop is printed beside MAIN_TOL's 5e-2, not
# held: two f32 loops 5e-2 apart after 1000 iterations on these
# random-weight magnitudes (5.23e-2 measured) says how far GL drifts, not
# which one errs. The f32 kernels' precision gate is GL_F32_STEP_FACTOR
MAIN_TOL = {"decode": 2e-2, "griffin_lim": 5e-2, "griffin_lim_f32_vs_f64": 1.0}
# K3 against its plain version over 50 steps, dropout off: (frames,
# alignments) max abs error by storage (lowp); f32: summation order only;
# bf16: rounding to bf16 flips where the two sums differ in the last bit
K3_TOL = {False: (1e-4, 1e-5), True: (0.02, 1e-3)}
# bf16 Griffin-Lim, kernel vs its plain version (same rounding points; an
# f32 sum that differs in its last bit flips a bf16 rounding, and GL carries
# the flip on): waveform max abs error over its peak after 10 iterations on
# a speech-like magnitude (4e-3 without momentum, 9e-3 with 0.99 measured on
# an H100); also held to the magnitude-error rule above
GL_BF16_TOL = 2e-2
# The same at a serving path's own shape and magnitudes. With random weights
# these sit at the spectrogram's floor and are nearly flat, far from any
# signal's spectrum, and Griffin-Lim then multiplies a difference by 3-10 per
# iteration even between the f32 kernel and the f32 plain loop (5e-6 of the
# peak after one iteration, 1.6e-1 after ten at momentum 0.99; [fast] prints
# it). So the path checks hold what the kernel
# itself adds: (a) "step": one iteration from the plain loop's own state at
# several depths, each component within one bf16 ulp (2^-7) of the
# magnitude's peak (a flipped rounding; 3e-3 measured); (b) the waveform
# after "iters" iterations, where the second consumes the momentum
# extrapolation (1.7e-2 measured); (c) at the path's full depth, finite
# values and the magnitude-error rule, the waveform difference only printed;
# (d) ``check_gl_speech``: the waveform after 9 and 10 iterations within
# GL_BF16_TOL on a speech-like magnitude of the path's shape
GL_PATH = {"iters": 2, "tol": 5e-2, "step_tol": 2.0 ** -7, "step_depths": (0, 1, 2, 4, 9)}
# the f32 Griffin-Lim kernels (split TF32 products) against the plain f32
# loop: one K4 iteration from the zero-phase start and one K5 call from the
# plain loop's state at GL_PATH's depths, each one's largest component error
# against the same step summed in f64 within this factor of the plain step's
GL_F32_STEP_FACTOR = 2.0
# K1/K2 vs autograd through the plain formula, f32 (summation order only):
# max abs error of e, dkeys, dq and dv each within this fraction of its peak
ENERGY_TOL = 1e-5
# K1/K2 bf16 vs their plain versions (the same rounding points): e and dv
# (f32) as ENERGY_TOL; each entry of dkeys and dq within one bf16 ulp (2^-7
# of its magnitude; an f32 sum's last bit can flip a rounding) plus
# ENERGY_TOL of the peak (dq is an f32 sum taken in another order); under
# autograd against autograd through the formula, which rounds elsewhere,
# 4e-2 of each peak (JAX's bf16 tolerance for its kernel against its formula)
ENERGY_BF16 = {"ulp": 2.0 ** -7, "autograd": 4e-2,
               "shapes": ((32, 128, 256), (6, 37, 256), (3, 11, 100))}
# [main-bf16]: Griffin-Lim iterations (the bf16 kernel's 1000 are timed in [main])
MAIN_BF16_GL_ITERS = 100
# the training main path: full_1chip widths, B 32, T_in 128, T_out 400; timed
# steps and interleaved rounds (fused, xla, xla, fused) per compute dtype: the
# f32 path, measured the longest, is cut to keep the whole script short
TRAIN_B, TRAIN_T_IN, TRAIN_T_OUT = 32, 128, 400
TRAIN_STEPS = {"float32": 3, "bfloat16": 5}
TRAIN_ROUNDS = {"float32": 1, "bfloat16": 3}

# [train-cli]: the corpus of the trained-weights recipe (scripts/r5_evidence_run.sh:
# 256 utterances of 20 characters, 0.06 s each +-30%), B 32, 20 f32 steps then a
# resume to 30 in bf16; the card's features checked against the CPU's on the
# first 16 utterances
TRAIN_CLI = {"n": 256, "text_len": 20, "char_sec": 0.06, "jitter": 0.3, "batch": 32,
             "steps": (20, 30), "cpu_check": 16}
# [train-cli] features, card (cuFFT) against CPU (torch.fft), f32 max abs error
# of the normalised spectrograms. FFT-bound: a transform's last-bit error is
# multiplied by the dB scale in the pure tones' deep spectral valleys, so
# two FFTs differ here by far more than on speech-like signals (2.094e-3 and
# 2.312e-5 measured on an H100, the same in every run)
CLI_FEATURE_TOL = {"linear": 5e-3, "mel": 5e-5}
# [train-cli]'s eval magnitudes (20 training steps: no longer flat at the
# spectrogram's floor): where a bin's analysis sum nearly cancels, one bf16
# rounding that an f32 sum's last bit flips turns the projected phase. In
# runs of this phase on an H100 one step's largest component error was
# 3.8e-3 to 2.2e-2 of the peak, past GL_PATH's one ulp (7.8e-3) at single
# bins: at most 4 of the 25.6M components of one magnitude over 8 eval
# magnitudes (scripts/train_cli_study.py). So here at most this share of
# the components may pass one ulp, none by more than twice its bin's
# magnitude
GL_EVAL_STEP_SHARE = 1e-5
# [train-cli], the training step through K1/K2 against the plain energy on
# the run's weights and batch (f32): [train-e2e]'s per-gradient tolerance,
# set on the tiny config, plus this share of the model's largest gradient
# entry. At full width after 10-20 training steps the gradients of the
# post-net and the decoder's output layer are sums that cancel, and the
# last-bit differences of K1's energies move them by up to ~6e-3 of their
# own peak; the CLI's training is not bit-reproducible on the card, so the
# weights, and these errors, differ from run to run. In 13 checks on an
# H100 (scripts/train_cli_study.py) the largest error was 9.6e-7, 0.038 of
# this tolerance (the largest entry 6.5e-3 to 9.6e-3)
CLI_GRAD_FLOOR = 3e-3

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


def launch_ms(kern) -> float:
    """Device ms of one call that launches each kernel of ``device_kernels``'
    result once: the sum of each kernel's time per profiled launch (the
    profiler can miss a launch of a short kernel; a mean over the launches
    it recorded does not count the missed ones as zero)."""
    return sum(ms / n for ms, n in kern.values())


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


def tf32_products_taken():
    """TF32 products the f32 Griffin-Lim kernels take per f32 product: the
    pairs of pieces (i, j) with i + j <= 2 of their split (TF32_PIECES)."""
    from tacotron_tpu_torch.dsp.fused_gl import TF32_PIECES
    a, b = TF32_PIECES
    return sum(1 for i in range(a) for j in range(b) if i + j <= 2)


def gl_bound_f32(rows, nb, win, n_iter, planar_io=False):
    """f32 mode: per iteration the synthesis and analysis products over the
    window's nonzero span, 2 x rows x win x 2*n_bins multiply-adds, taken as
    TF32_PRODUCTS_BOUND TF32 products each -> (ms, bound_by) at the TF32
    peak, and the same products' ms on the CUDA cores (f32 peak). Bytes:
    the magnitude read and the (re, im) spectrum written, in f32; the
    streaming kernel also reads an f32 spectrum."""
    byts = rows * nb * (4 + 2 * 4 + (2 * 4 if planar_io else 0))
    flops = n_iter * 2 * 2 * rows * win * 2 * nb
    return (bound(byts, TF32_PRODUCTS_BOUND * flops, PEAK_FLOPS["tf32"]),
            flops / PEAK_FLOPS["f32"] * 1e3)


def gl_bound_bf16(rows, nb, win, n_iter, planar_io=False):
    """bf16 mode: the same two products per iteration against the tensor
    cores' bf16 peak. Bytes: the f32 magnitude read and the bf16 (re, im)
    spectrum written; the streaming kernel also reads a bf16 spectrum."""
    byts = rows * nb * (4 + 2 * 2 + (2 * 2 if planar_io else 0))
    return bound(byts, n_iter * 2 * 2 * rows * win * 2 * nb, PEAK_FLOPS["bf16"])


def dft_products_ms(mag, acfg, n_iter, dtype, padded=False):
    """Library yardstick: an iteration's two DFT products alone, as
    ``torch.matmul`` calls in ``dtype`` over the same live span; with
    ``padded`` at the bf16 kernels' padded shapes (win and 2*n_bins rounded
    up to a multiple of 64: 16-byte-aligned rows for cuBLAS too)."""
    from tacotron_tpu_torch.dsp.fused_gl import live_bases, padded_bases
    dev = mag.device
    if padded:
        bwd_t, fwd_t = padded_bases(acfg.n_fft, acfg.win_length)
        bwd_np, fwd_np = np.ascontiguousarray(bwd_t.T), np.ascontiguousarray(fwd_t.T)
    else:
        bwd_np, fwd_np = live_bases(acfg.n_fft, acfg.win_length)
    bwd, fwd = (torch.from_numpy(x).to(dev).to(dtype) for x in (bwd_np, fwd_np))
    rows = mag.shape[0] * mag.shape[1]
    spec = torch.randn(rows, bwd.shape[0], device=dev).to(dtype)
    frames = torch.empty(rows, bwd.shape[1], device=dev, dtype=dtype)
    outp = torch.empty(rows, fwd.shape[1], device=dev, dtype=dtype)

    def products():
        for _ in range(n_iter):
            torch.matmul(spec, bwd, out=frames)
            torch.matmul(frames, fwd, out=outp)
    products()
    return cuda_ms(products)


def sample_magnitude(b, f, acfg, dev, seed):
    from tacotron_tpu_torch.dsp.dft import stft_mm
    g = torch.Generator().manual_seed(seed)
    y = torch.cumsum(torch.randn(b, acfg.hop_length * (f - 1), generator=g), -1) * 0.1
    y = (y - y.mean(-1, keepdim=True)).to(dev)
    re, im = stft_mm(y, acfg.n_fft, acfg.hop_length, acfg.win_length)
    return torch.sqrt(re * re + im * im + 1e-12)


def gl_kw(acfg):
    return dict(n_fft=acfg.n_fft, hop_length=acfg.hop_length, win_length=acfg.win_length)


def gl_errors(got, want, mag, acfg):
    """Kernel spectrum vs plain spectrum -> (waveform max abs error over the
    plain waveform's peak, magnitude error of the kernel's waveform, of the
    plain one's): the magnitude error is mean | |STFT(wav)| - mag | / mean
    mag, as tests/unit/test_pallas_gl.py measures convergence."""
    from tacotron_tpu_torch.dsp.dft import istft_mm, stft_mm
    kw = gl_kw(acfg)

    def wav(spec):
        return istft_mm(spec[0].float(), spec[1].float(), **kw)

    def mag_err(w):
        re, im = stft_mm(w, **kw)
        return float((torch.sqrt(re * re + im * im + 1e-12) - mag).abs().mean() / mag.mean())

    kwav, pwav = wav(got), wav(want)
    ok = bool(torch.isfinite(kwav).all())
    return (max_err(kwav, pwav) / float(pwav.abs().max()) if ok else float("inf"),
            mag_err(kwav), mag_err(pwav))


def check_gl(name, got, want, mag, acfg, tol):
    """Hold a Griffin-Lim kernel result to its plain version: waveform
    within ``tol`` of the peak (None: finite, the difference only printed),
    and converging as well (magnitude error <= plain's * 1.05 + 1e-3)."""
    err, ek, ep = gl_errors(got, want, mag, acfg)
    log(f"  {name}: wav err / peak {err:.3e}; magnitude error kernel {ek:.5f}, plain {ep:.5f}")
    if tol is None:
        require(np.isfinite(err), f"{name} finite")
    else:
        require(err <= tol, f"{name} within {tol} of the peak")
    require(ek <= ep * 1.05 + 1e-3, f"{name} converges as well as its plain version")
    return {"wav_max_abs_err_over_peak": err, "tol": tol, "mag_err_kernel": ek,
            "mag_err_plain": ep}


def check_gl_speech(name, b, f, acfg, cases):
    """The bf16 whole-loop kernel against its plain version on a speech-like
    magnitude of a path's shape (B ``b``, F ``f``), where the waveform can be
    held: ``cases`` are (n_iter, momentum) pairs, each within GL_BF16_TOL of
    the peak and converging as well. An odd ``n_iter`` with momentum reads the
    other of the kernel's two result buffers. -> the largest error."""
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference, griffin_lim_spectrum
    mag = sample_magnitude(b, f, acfg, torch.device("cuda"), seed=6)
    out = {}
    for n_iter, mom in cases:
        kw = dict(n_iter=n_iter, momentum=mom, **gl_kw(acfg))
        with torch.no_grad():
            out[f"{n_iter}_iterations_m{mom}"] = check_gl(
                f"{name}, speech-like B {b} F {f}, {n_iter} iterations, momentum {mom}",
                griffin_lim_spectrum(mag, **kw), gl_spectrum_reference(mag, **kw), mag, acfg,
                GL_BF16_TOL)
    out["max_abs_err"] = max(c["wav_max_abs_err_over_peak"] for c in out.values())
    return out


def check_gl_steps(name, mag, acfg, over_share=0.0):
    """The streaming kernel against the plain step, one iteration from the
    plain bf16 loop's own state at GL_PATH's depths -> the largest component
    error over the magnitude's peak. ``over_share``: the share of the
    components allowed past one bf16 ulp of the peak (0: none), each still
    within twice its bin's magnitude (a projection cannot move a bin
    further)."""
    from tacotron_tpu_torch.dsp.fused_gl import gl_step_reference, griffin_lim_step, zero_phase
    kw, peak, worst = gl_kw(acfg), float(mag.max()), 0.0
    tol = GL_PATH["step_tol"] * peak
    over = total = wild = 0
    re, im = zero_phase(mag, True)
    with torch.no_grad():
        for depth in range(max(GL_PATH["step_depths"]) + 1):
            pr, pi = gl_step_reference(re, im, mag, **kw)
            if depth in GL_PATH["step_depths"]:
                for got, want in zip(griffin_lim_step(re, im, mag, **kw), (pr, pi)):
                    d = (got.float() - want.float()).abs()
                    worst = max(worst, float(d.max()) / peak)
                    over, total = over + int((d > tol).sum()), total + d.numel()
                    wild += int((d > 2 * mag.float() + tol).sum())
            re, im = pr, pi
    log(f"  {name}: one step from the plain loop's state at depths {GL_PATH['step_depths']}: "
        f"max err / magnitude peak {worst:.3e}; {over} of {total} components past one bf16 "
        f"ulp of the peak")
    if over_share:
        require(over <= over_share * total and not wild,
                f"{name}: each step within one bf16 ulp ({GL_PATH['step_tol']:.2e}) of the "
                f"magnitude's peak but for at most {over_share} of the components, those "
                f"within twice their bin's magnitude")
    else:
        require(worst <= GL_PATH["step_tol"], f"{name}: each step within one bf16 ulp "
                f"({GL_PATH['step_tol']:.2e}) of the magnitude's peak")
    return worst


def check_gl_f32_steps(name, mag, acfg):
    """The f32 kernels' split TF32 products as exact as the plain f32 loop's
    (GL_F32_STEP_FACTOR) -> the largest errors over the magnitude's peak
    against the f64 step: {"k4", "k5", "plain"}."""
    from tacotron_tpu_torch.dsp.fused_gl import (f64_matmul, gl_step_reference,
                                                 griffin_lim_spectrum, griffin_lim_step,
                                                 zero_phase)
    kw, peak = dict(lowp=False, **gl_kw(acfg)), float(mag.max())
    err = lambda a, b: max(max_err(x, y) for x, y in zip(a, b)) / peak
    re, im = zero_phase(mag, False)
    with torch.no_grad():
        worst = {"k4": err(griffin_lim_spectrum(mag, n_iter=1, **kw),
                           gl_step_reference(re, im, mag, product=f64_matmul, **kw)),
                 "k5": 0.0, "plain": 0.0}
        for depth in range(max(GL_PATH["step_depths"]) + 1):
            plain = gl_step_reference(re, im, mag, **kw)
            if depth in GL_PATH["step_depths"]:
                exact = gl_step_reference(re, im, mag, product=f64_matmul, **kw)
                worst["k5"] = max(worst["k5"], err(griffin_lim_step(re, im, mag, **kw), exact))
                worst["plain"] = max(worst["plain"], err(plain, exact))
            re, im = plain
    log(f"  {name}: largest step error / magnitude peak against the f64 step: K4 f32 (depth 0) "
        f"{worst['k4']:.3e}, K5 f32 {worst['k5']:.3e}, plain f32 {worst['plain']:.3e} "
        f"(depths {GL_PATH['step_depths']})")
    f = GL_F32_STEP_FACTOR
    require(worst["k4"] <= f * worst["plain"] and worst["k5"] <= f * worst["plain"],
            f"{name}: K4 and K5 f32 steps within {f}x the plain f32 step's error against f64")
    return worst


def check_gl_path(name, mag, acfg, kernel, plain, n_iter, at_depth=None, steps=True,
                  over_share=0.0):
    """A bf16 Griffin-Lim kernel at a path's shape, magnitudes and depth
    against its plain version, as GL_PATH sets out: ``kernel(n)`` and
    ``plain(n)`` give the spectrum after n iterations on ``mag``;
    ``at_depth`` is the pair after ``n_iter`` where the caller has it;
    ``over_share`` as ``check_gl_steps``'."""
    out = ({"step_max_err_over_mag_peak": check_gl_steps(name, mag, acfg, over_share)}
           if steps else {})
    n = GL_PATH["iters"]
    with torch.no_grad():
        out["short"] = check_gl(f"{name}, {n} iterations", kernel(n), plain(n), mag, acfg,
                                GL_PATH["tol"])
        got, want = at_depth or (kernel(n_iter), plain(n_iter))
        out["at_depth"] = check_gl(f"{name}, {n_iter} iterations", got, want, mag, acfg, None)
    out["max_abs_err"] = out["short"]["wav_max_abs_err_over_peak"]
    return out


def phase_probes(checks):
    from tacotron_tpu_torch import probe
    dev = torch.device("cuda")
    log("[P1] dynamic shared memory of one block: 48, 100, 227 KiB, and one past the limit")
    x = torch.randn(probe.SMEM_SHAPE, generator=torch.Generator().manual_seed(4)).to(dev)
    limit = None
    for kib in (48, 100, 227):
        out, limit = probe.probe_smem(x, kib)
        torch.cuda.synchronize()
        require(torch.equal(out, probe.probe_smem_reference(x)),
                f"probe_smem {kib} KiB equals x * 2 (device limit {limit} bytes)")
    refused = None
    try:
        probe.probe_smem(x, limit // 1024 + 1)
    except probe.ProbeError as e:
        refused = str(e)
    log(f"  {limit // 1024 + 1} KiB: {refused}")
    require(refused is not None and "CUDA error" in refused,
            f"probe_smem {limit // 1024 + 1} KiB is refused with the CUDA error")
    out, _ = probe.probe_smem(x, 48)
    torch.cuda.synchronize()
    require(torch.equal(out, x * 2), "the device works on after the refusal")
    checks["probe_smem"] = {"limit_bytes": limit, "refusal": refused}

    log("[P2] ops probe vs plain, seeded normal operands")
    inputs = probe.ops_inputs(dev, seed=0)
    runs = [probe.probe_ops(*inputs) for _ in range(2)]
    want = probe.probe_ops_reference(*inputs)
    torch.cuda.synchronize()
    err, peak = max_err(runs[0], want), float(want.abs().max())
    log(f"  probe_ops: max abs err {err:.3e} (peak {peak:.3f})")
    require(err <= 1e-4 * peak, "probe_ops within 1e-4 of its peak (f32 summation order)")
    require(torch.equal(runs[0], runs[1]), "probe_ops: two calls give the same bits")
    checks["probe_ops"] = {"max_abs_err": err, "peak": peak, "tol_of_peak": 1e-4}


def phase_kernels(report):
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference, griffin_lim_spectrum
    from tacotron_tpu_torch.ops.decode_loop import (_decode_loop_cuda, cluster_plan,
                                                    decode_loop, decode_loop_reference,
                                                    pack_decoder_weights)

    dev = torch.device("cuda")
    # Plain versions in full precision: f32 products and convolutions in
    # f32, not TF32; and bf16 products summed in f32, as XLA sums them
    # (cuBLAS may otherwise reduce a split-K bf16 product in bf16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config("synth_gl1000")
    vocab = Vocab.build(PROMPTS)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    model = full_model(cfg, dev)
    memory, keys, mask = decoder_inputs(model, vocab, dev)
    w = pack_decoder_weights(model.decoder.cell)
    n = 50
    checks = report.setdefault("checks", {})

    chosen, resident = cluster_plan(memory, keys, w)
    log(f"[K3] fused decode vs plain, B 8, T_in 120, 50 steps, at the chosen cluster size "
        f"{chosen} and at 1 (resident clusters by size {resident})")
    require(chosen > 1 and resident[chosen] >= memory.shape[0],
            f"a cluster of {chosen} > 1 blocks per row, all {memory.shape[0]} resident at once")
    tol = K3_TOL
    for lowp in (False, True):
        for cluster in (chosen, 1):
            with torch.no_grad():
                if cluster == chosen:
                    kf, ka = decode_loop(memory, keys, mask, w, n_steps=n, dropout=False,
                                         lowp=lowp)
                else:
                    kf, ka = _decode_loop_cuda(memory, keys, mask, w, n_steps=n, seed=0,
                                               dropout=False, dropout_rate=0.5, lowp=lowp,
                                               return_keep_counts=False, _cluster=cluster)
                pf, pa = decode_loop_reference(memory, keys, mask, w, n_steps=n,
                                               dropout=False, lowp=lowp)
            torch.cuda.synchronize()
            ef, ea = max_err(kf, pf), max_err(ka, pa)
            scale = float(pf.abs().max())
            name = ("decode_f32" if not lowp else "decode_bf16") + (
                "" if cluster == chosen else "_cluster1")
            checks[name] = {"frames_max_abs_err": ef, "aligns_max_abs_err": ea,
                            "frames_peak": scale, "tol": tol[lowp], "cluster": cluster}
            log(f"  {name} (cluster {cluster}): frames err {ef:.3e} (peak {scale:.3f}), "
                f"aligns err {ea:.3e}")
            require(bool(torch.isfinite(kf).all()), f"{name} frames finite")
            require(ef <= tol[lowp][0] and ea <= tol[lowp][1],
                    f"{name} within tolerance frames {tol[lowp][0]}, alignments {tol[lowp][1]}")
            require(bool((ka[1, :, 96:] < 1e-6).all()), f"{name} mask respected")

    with torch.no_grad():
        f1, _, kc = decode_loop(memory, keys, mask, w, n_steps=n, seed=1,
                                dropout_rate=0.5, return_keep_counts=True)
        f2, _ = decode_loop(memory, keys, mask, w, n_steps=n, seed=2, dropout_rate=0.5)
        f1b, _ = decode_loop(memory, keys, mask, w, n_steps=n, seed=1, dropout_rate=0.5)
        _, _, kc1 = _decode_loop_cuda(memory, keys, mask, w, n_steps=n, seed=1, dropout=True,
                                      dropout_rate=0.5, lowp=True, return_keep_counts=True,
                                      _cluster=1)
    units = memory.shape[0] * n * (w.p_w0.shape[0] + w.p_w1.shape[0])
    keep_rate = float(kc.sum()) / units
    checks["decode_dropout"] = {"keep_rate": keep_rate, "units": units, "cluster": chosen}
    log(f"  dropout keep rate {keep_rate:.5f} over {units} units")
    require(abs(keep_rate - 0.5) <= 0.01, "dropout keep rate within 0.5 +- 0.01")
    require(torch.equal(kc, kc1), f"keep counts equal at cluster sizes {chosen} and 1")
    require(not torch.allclose(f1, f2), "different seeds give different frames")
    require(torch.equal(f1, f1b), "the same seed gives the same frames")

    acfg = cfg.audio
    mag = sample_magnitude(4, 400, acfg, dev, seed=3)
    kw = gl_kw(acfg)
    log("[K4] Griffin-Lim kernel vs plain, 2048/275/1102, B 4, F 400, 10 iterations, "
        "f32 and bf16")
    for lowp in (False, True):
        for mom in (0.0, 0.99):
            with torch.no_grad():
                got = griffin_lim_spectrum(mag, n_iter=10, momentum=mom, lowp=lowp, **kw)
                want = gl_spectrum_reference(mag, n_iter=10, momentum=mom, lowp=lowp, **kw)
            name = f"griffin_lim_{'bf16' if lowp else 'f32'}_m{mom}"
            tol = GL_BF16_TOL if lowp else 1e-3
            checks[name] = check_gl(name, got, want, mag, acfg, tol)

    log("[K5] streaming Griffin-Lim kernel, 10 calls, vs 10 plain steps; f32 also vs K4")
    for lowp in (False, True):
        with torch.no_grad():
            got = griffin_lim_spectrum(mag, n_iter=10, inner=1, lowp=lowp, **kw)
            want = gl_spectrum_reference(mag, n_iter=10, lowp=lowp, **kw)
        name = f"griffin_lim_step_{'bf16' if lowp else 'f32'}"
        checks[name] = check_gl(name, got, want, mag, acfg,
                                GL_BF16_TOL if lowp else 1e-3)
        if not lowp:
            with torch.no_grad():
                k4 = griffin_lim_spectrum(mag, n_iter=10, lowp=False, **kw)
            checks[name + "_vs_k4"] = check_gl(name + " vs K4 f32, beta 0", got, k4, mag,
                                               acfg, 1e-3)
    phase_probes(checks)

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


def energy_bf16_check(keys, q, v, de, label=""):
    """K1/K2 in bf16 (keys, q bf16) against their plain versions on the same
    inputs, and under autograd against autograd through the formula, with
    ENERGY_BF16's tolerances -> {name: (max abs error, peak)}; raises on a
    miss."""
    from tacotron_tpu_torch.ops.attn_energy import (attention_energy,
                                                    attention_energy_reference,
                                                    energy_bwd, energy_bwd_reference,
                                                    energy_fwd)
    keys, q = keys.bfloat16(), q.bfloat16()
    got = (energy_fwd(keys, q, v), *energy_bwd(keys, q, v, de))
    want = (attention_energy_reference(keys, q, v), *energy_bwd_reference(keys, q, v, de))
    leaves = [x.detach().clone().requires_grad_(True) for x in (keys, q, v)]
    auto = torch.autograd.grad(attention_energy(*leaves), leaves, de)
    ref_leaves = [x.detach().clone().requires_grad_(True) for x in (keys, q, v)]
    auto_ref = torch.autograd.grad(attention_energy_reference(*ref_leaves), ref_leaves, de)
    torch.cuda.synchronize()
    out = {}
    for n, g, w in zip(("e", "dkeys", "dq", "dv"), got, want):
        require(g.dtype == w.dtype and g.shape == w.shape, f"{label}{n}: {g.dtype} {tuple(g.shape)}")
        err, peak = max_err(g, w), float(w.float().abs().max())
        tol = ENERGY_TOL * peak
        if n in ("dkeys", "dq"):
            d = (g.float() - w.float()).abs()
            flips = int((d > 0).sum())
            within = bool((d <= ENERGY_BF16["ulp"] * w.float().abs() + tol).all())
            log(f"  {label}{n} ({g.dtype}): max abs err {err:.3e} (peak {peak:.3f}); "
                f"{flips} of {d.numel()} entries differ")
            require(within, f"{label}{n}: each entry within one bf16 ulp + {ENERGY_TOL} of the peak")
        else:
            log(f"  {label}{n} ({g.dtype}): max abs err {err:.3e} (peak {peak:.3f})")
            require(err <= tol, f"{label}{n} within {ENERGY_TOL} of its peak")
        out[n] = (err, peak)
    for n, g, w in zip(("dkeys", "dq", "dv"), auto, auto_ref):
        err, peak = max_err(g, w), float(w.float().abs().max())
        log(f"  {label}autograd {n}: max abs err {err:.3e} (peak {peak:.3f})")
        require(err <= ENERGY_BF16["autograd"] * peak,
                f"{label}autograd {n} within {ENERGY_BF16['autograd']} of its peak")
        out[f"autograd_{n}"] = (err, peak)
    return out


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
    log("[K1/K2 bf16] keys and q in bf16 vs the plain forward and energy_bwd_reference, "
        "and under autograd")
    chk = report["checks"].setdefault("attn_energy_bf16", {"tol": ENERGY_BF16 | {
        "e_dv_of_peak": ENERGY_TOL}})
    for b, t, a in ENERGY_BF16["shapes"]:
        chk[f"B{b}_T{t}_A{a}"] = energy_bf16_check(
            *energy_inputs(torch.device("cuda"), b, t, a), label=f"B {b} T {t} A {a}: ")


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

    log("[train-e2e] remat_policy save_attn against all, both decoder forms, both energies "
        "(remat on): loss and every parameter gradient")
    for form in ("scan", "hoisted"):
        for energy in ("xla", "fused"):
            res = {}
            for policy in ("all", "save_attn"):
                cfg = dataclasses.replace(base, tf_decoder=form, remat_decoder=True,
                                          attention_energy=energy, remat_policy=policy)
                model = init_params(Tacotron(cfg, device=dev), seed=0).train()
                before = dict(runtime.LAUNCHES)
                o = model(text, lengths, gt_mel=mel)
                loss, _ = tacotron_loss(o.mel, o.linear, mel, linear)
                loss.backward()
                torch.cuda.synchronize()
                n = {k: runtime.LAUNCHES[k] - before.get(k, 0)
                     for k in ("attn_energy_fwd", "attn_energy_bwd")}
                res[policy] = (loss.item(), {k: p.grad for k, p in model.named_parameters()}, n)
            name = f"{form}_{energy}_save_attn"
            loss_rel = abs(res["save_attn"][0] - res["all"][0]) / abs(res["all"][0])
            worst = max(float((res["save_attn"][1][k] - w).abs().max())
                        / (float(w.abs().max()) + 1e-12) for k, w in res["all"][1].items())
            checks[name] = {"loss_rel_err": loss_rel, "worst_grad_err_of_peak": worst,
                            "launches": res["save_attn"][2]}
            log(f"  {name}: loss rel err {loss_rel:.3e}, worst grad err / peak {worst:.3e}, "
                f"launches {res['save_attn'][2]}")
            require(res["save_attn"][2] == res["all"][2],
                    f"{name}: the energy kernels launched as under all ({res['all'][2]})")
            require(loss_rel <= 1e-5, f"{name}: loss within rel 1e-5 of all's")
            for k, w in res["all"][1].items():
                err = float((res["save_attn"][1][k] - w).abs().max())
                if err > 1e-4 * float(w.abs().max()) + 1e-7:
                    raise AssertionError(f"{name}: gradient {k} off by {err:.3e}")
            log(f"  ok: {name}: every gradient within 1e-4 of its peak + 1e-7 of all's")


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

    # the same Griffin-Lim through the f32 kernel, which no backend name
    # selects any more: the public function, on this call's spectrogram
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.dsp.fused_gl import griffin_lim_spectrum
    acfg = cfg.audio
    mag = spectrogram_magnitude(torch.from_numpy(out["linear"]).to(dev), acfg)
    res = {}
    runtime.LAUNCHES.clear()
    # device time of each launch by torch.profiler, the launches counted by
    # the wrapper and by the profiler
    with torch.no_grad():
        stages = gl_stages(lambda: res.update(f32=griffin_lim_spectrum(
            mag, n_iter=acfg.griffin_lim_iters, momentum=acfg.gl_momentum, lowp=False,
            **gl_kw(acfg))))
    f32_launches = runtime.LAUNCHES["griffin_lim"]
    f32_ms = sum(ms for ms, _ in stages.values())
    dev_launches = sum(n for _, n in stages.values())
    gl_ms = out["stage_ms"]["griffin_lim"]
    aps_f32 = out["audio_seconds"] / (wall + (f32_ms - gl_ms) / 1e3)
    log(f"  Griffin-Lim stage: bf16 kernel (the default) {gl_ms:.3f} ms, f32 kernel "
        f"{f32_ms:.3f} ms of device time ({f32_launches} launches); with the f32 kernel the "
        f"call would give {aps_f32:.3f} audio_seconds_per_s (timed call less its stage plus "
        f"this)")
    require(f32_launches == dev_launches == 3 * acfg.griffin_lim_iters and stages["pack"][1] == 0,
            f"the f32 kernel launched: {dev_launches:.0f} device launches = LAUNCHES "
            f"{f32_launches} = 3 per iteration")
    report["main"].update(griffin_lim_f32_ms=f32_ms, audio_seconds_per_s_f32_gl=aps_f32)
    launches["griffin_lim_f32"] = f32_launches
    return synth, out, launches, mag, res["f32"], (f32_ms, stages)


def phase_main_bf16(report, cfg, vocab, mel_f32):
    """[main-bf16]: [main]'s call with compute_dtype="bfloat16" on the same
    seed-0 weights, prompts and dropout seed; the counts set to 0 just
    before the timed call. ``mel_f32``: [main]'s mel, for the drift."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.infer.synthesize import STAGES, Synthesizer
    from tacotron_tpu_torch.weights import split_state

    cfg16 = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    n_it = MAIN_BF16_GL_ITERS
    log(f"[main-bf16] Synthesizer(fused=True), synth_gl1000 with compute_dtype bfloat16, B 8, "
        f"500 steps, GL {n_it} (not 1000: [main] times the same kernel at 1000)")
    p, bs = split_state(full_model(cfg16, torch.device("cuda")))
    synth = Synthesizer(cfg16, p, bs, vocab, fused=True)
    t0 = time.perf_counter()
    synth(PROMPTS, seed=0, gl_iters=n_it)
    warm_s = time.perf_counter() - t0
    runtime.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = synth(PROMPTS, seed=1, gl_iters=n_it, stage_ms=True)
    wall = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    log(f"  warm call {warm_s:.3f} s, timed call {wall:.3f} s")
    for s_ in STAGES:
        log(f"  stage {s_}: {out['stage_ms'][s_]:.3f} ms")
    aps = out["audio_seconds"] / wall
    log(f"  audio_seconds {out['audio_seconds']:.3f}, audio_seconds_per_s {aps:.3f}; "
        f"launches {launches}")
    keys = synth.model.memory_proj(torch.zeros(1, 1, cfg.model.memory_dim, device="cuda"))
    require(keys.dtype == torch.bfloat16, "the keys are a bf16 product")
    require(launches.get("decode_loop") == 1 and launches.get("griffin_lim") == 3 * n_it,
            f"K3 launched once and K4 3 x {n_it} times")
    mel, wav = out["mel"], out["wavs"]
    require(mel.shape == mel_f32.shape and out["linear"].shape[:2] == mel.shape[:2]
            and wav.shape == (8, cfg.audio.hop_length * (2 * 500 - 1)),
            f"shapes: mel {mel.shape}, linear {out['linear'].shape}, wavs {wav.shape}")
    require(all(bool(np.isfinite(x).all()) for x in (mel, out["linear"], wav))
            and float(np.abs(wav).max()) > 0, "mel, linear and wavs finite, a peak > 0")
    d = np.abs(mel - mel_f32)
    drift = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
             "f32_mean_abs": float(np.abs(mel_f32).mean()),
             "first_50_steps_max_abs": float(d[:, :100].max())}
    log(f"  mel drift from [main]'s f32 mel (printed, not held): mean {drift['mean_abs']:.5f} "
        f"(f32 mean magnitude {drift['f32_mean_abs']:.5f}), max {drift['max_abs']:.5f}, max over "
        f"the first 50 steps {drift['first_50_steps_max_abs']:.5f}")
    report["main_bf16"] = {"stage_ms": out["stage_ms"], "wall_s": wall, "warm_s": warm_s,
                           "gl_iters": n_it, "audio_seconds": out["audio_seconds"],
                           "audio_seconds_per_s": aps, "launches": launches,
                           "mel_drift_from_f32": drift}


def phase_cli(report, cfg, vocab):
    """[cli] the synthesis CLI at synth_gl1000 width, as a user runs it: a
    run directory holding the port's checkpoint of seeded random weights,
    restored and held equal to the weights saved; then
    ``cli.synthesize.main`` on 2 prompts with ``--fused`` (K3 and K4 bf16)
    and with ``--preset synth_fast`` (early exit, trimming, K4 bf16), the
    launch counts set to 0 just before each, the wavs and the JSON line
    checked."""
    import contextlib
    import glob
    import io
    import shutil
    import wave

    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.cli import synthesize as cli
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.train import checkpoint, create_train_state

    log("[cli] python -m tacotron_tpu_torch.cli.synthesize at synth_gl1000, 2 prompts: "
        "--fused, then --preset synth_fast")
    root = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    run_dir, data_dir = os.path.join(root, "run"), os.path.join(root, "data")
    os.makedirs(run_dir)
    os.makedirs(data_dir)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    vocab.save(os.path.join(data_dir, "vocab.json"))
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed=0)
    checkpoint.save(os.path.join(run_dir, "ckpt"), 0, state, cfg.train)
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    fresh, step = checkpoint.restore(os.path.join(run_dir, "ckpt"),
                                     create_train_state(cfg, seed=1), cfg.train)
    require(step == 0 and all(torch.equal(v, saved[k])
                              for k, v in fresh.model.state_dict().items()),
            f"the checkpoint restores the {len(saved)} tensors saved, bit for bit "
            f"({time.perf_counter() - t0:.2f} s to write and restore)")
    del state, fresh, saved
    keys = ["audio_seconds", "audio_seconds_per_s", "n", "out_dir", "trimmed_audio_seconds",
            "trimmed_audio_seconds_per_s", "wall_seconds"]
    want_launches = {"fused": {"decode_loop": 1, "griffin_lim": 3 * cfg.audio.griffin_lim_iters},
                     "synth_fast": {"griffin_lim": 3 * get_config("synth_fast").audio.griffin_lim_iters}}
    runs = {}
    for name, flags in (("fused", ["--fused"]), ("synth_fast", ["--preset", "synth_fast"])):
        out_dir = os.path.join(root, name)
        argv = ["--run-dir", run_dir, "--data-dir", data_dir, "--out-dir", out_dir,
                "--text", PROMPTS[0], "--text", PROMPTS[1], *flags]
        buf = io.StringIO()
        runtime.LAUNCHES.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(runtime.LAUNCHES)
        lines = buf.getvalue().strip().splitlines()
        line = json.loads(lines[-1])
        samples = []
        for path in sorted(glob.glob(os.path.join(out_dir, "utt_*.wav"))):
            with wave.open(path) as w:
                samples.append(w.getnframes())
                require(w.getframerate() == cfg.audio.sample_rate and w.getsampwidth() == 2,
                        f"{name}: {os.path.basename(path)} is 16-bit PCM at "
                        f"{cfg.audio.sample_rate} Hz, {w.getnframes()} samples")
        runs[name] = {"wall_s": wall, "json": line, "launches": launches, "samples": samples}
        log(f"  {name}: {lines[0]}; {wall:.2f} s in the process; {line}; launches {launches}")
        require(sorted(line) == keys and line["n"] == 2 and len(samples) == 2 and min(samples) > 0,
                f"{name}: two wavs and the JSON line's keys")
        require(all(launches.get(k) == v for k, v in want_launches[name].items()),
                f"{name}: launches {want_launches[name]}")
    report["cli"] = runs
    runs["checks"] = check_cli_kernels(cfg, vocab, os.path.join(run_dir, "ckpt"))


def check_cli_kernels(cfg, vocab, ckpt_dir):
    """K3 and K4 at [cli]'s own inputs, against their plain versions: the
    run directory's weights restored as the CLI restores them, its 2
    prompts, its seed 0 and its configs (synth_gl1000, and synth_fast as
    ``--preset`` overlays it). K3 at the cluster size B 2 gives it, in both
    storage modes over 50 steps at K3_TOL, and over the path's 500 steps in
    bf16 at MAIN_TOL; K4 in its bf16 mode, the mode both runs launch, on
    each run's magnitudes: its first iteration component by component
    within one bf16 ulp of the magnitude's peak, then as GL_PATH sets out
    (depth: the run's iterations). -> the errors."""
    from tacotron_tpu_torch.cli.synthesize import overlay_preset
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference, griffin_lim_spectrum
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.models.tacotron import length_mask
    from tacotron_tpu_torch.ops.decode_loop import (cluster_plan, decode_loop,
                                                    decode_loop_reference, pack_decoder_weights)
    from tacotron_tpu_torch.train import checkpoint, create_train_state
    from tacotron_tpu_torch.weights import split_state

    dev = torch.device("cuda")
    state, _ = checkpoint.restore(ckpt_dir, create_train_state(cfg, seed=1), cfg.train)
    p, bs = split_state(state.model)
    del state
    synth = Synthesizer(cfg, p, bs, vocab, fused=True)
    m, texts = synth.model, PROMPTS[:2]
    text, lengths = synth.encode_texts(texts)
    mask = length_mask(text.shape[1], lengths)
    with torch.no_grad():
        # the Synthesizer's own draws: the encoder's from the call's generator
        memory = m.encoder(text, lengths, torch.Generator(device=dev).manual_seed(0))
        keys = m.memory_proj(memory)
    w = pack_decoder_weights(m.decoder.cell)
    b, t_in = memory.shape[:2]
    chosen, resident = cluster_plan(memory, keys, w)
    n_path = cfg.model.max_decode_steps
    log(f"  K3 at the CLI's inputs (B {b}, T_in {t_in}): cluster size {chosen} (resident "
        f"clusters by size {resident})")
    require(chosen > 1 and resident[chosen] >= b,
            f"a cluster of {chosen} > 1 blocks per row, all {b} resident at once")
    out = {"decode_cluster": chosen}
    for lowp, n in ((False, 50), (True, 50), (True, n_path)):
        tf, ta = K3_TOL[lowp] if n == 50 else (MAIN_TOL["decode"], None)
        with torch.no_grad():
            kf, ka = decode_loop(memory, keys, mask, w, n_steps=n, dropout=False, lowp=lowp)
            pf, pa = decode_loop_reference(memory, keys, mask, w, n_steps=n, dropout=False,
                                           lowp=lowp)
        ef, ea = max_err(kf, pf), max_err(ka, pa)
        name = f"decode_{'bf16' if lowp else 'f32'}_{n}_steps"
        out[name] = {"frames_max_abs_err": ef, "aligns_max_abs_err": ea,
                     "frames_peak": float(pf.abs().max()), "tol": (tf, ta), "cluster": chosen}
        log(f"  {name} (cluster {chosen}): frames err {ef:.3e} (peak "
            f"{out[name]['frames_peak']:.3f}), aligns err {ea:.3e}")
        require(bool(torch.isfinite(kf).all()) and ef <= tf and (ta is None or ea <= ta),
                f"{name} at the CLI's inputs finite, within frames {tf}"
                + ("" if ta is None else f", alignments {ta}"))

    for name, c, fused in (("fused", cfg, True), ("synth_fast", overlay_preset(cfg, "synth_fast"),
                                                  False)):
        acfg = c.audio
        # the run's spectrogram: the same call up to Griffin-Lim, which the
        # kernel is then held on at the run's shape
        res = Synthesizer(c, p, bs, vocab, fused=fused)(texts, seed=0, gl_iters=1)
        t_gl = res["wavs"].shape[1] // acfg.hop_length + 1
        mag = spectrogram_magnitude(torch.from_numpy(res["linear"][:, :t_gl]).to(dev), acfg)
        kw = dict(momentum=acfg.gl_momentum, **gl_kw(acfg))
        label = (f"cli {name}: griffin_lim bf16 (B {b}, F {t_gl}, momentum {acfg.gl_momentum})")
        with torch.no_grad():
            first = max(max_err(x, y) for x, y in zip(
                griffin_lim_spectrum(mag, n_iter=1, **kw),
                gl_spectrum_reference(mag, n_iter=1, **kw))) / float(mag.max())
        log(f"  {label}: first iteration max err / magnitude peak {first:.3e}")
        require(first <= GL_PATH["step_tol"], f"{label}: first iteration within one bf16 ulp "
                f"({GL_PATH['step_tol']:.2e}) of the magnitude's peak")
        chk = check_gl_path(label, mag, acfg, lambda n: griffin_lim_spectrum(mag, n_iter=n, **kw),
                            lambda n: gl_spectrum_reference(mag, n_iter=n, **kw),
                            acfg.griffin_lim_iters)
        out[f"griffin_lim_bf16_{name}"] = {"t_gl": t_gl, "first_iteration": first, **chk}
    return out


def run_cli(main, argv):
    """-> (stdout lines of ``main(argv)``, seconds)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines(), time.perf_counter() - t0


def loader_schedule(data_dir, cfg, n_steps):
    """The buckets of the training CLI's first ``n_steps`` batches: its
    loader's schedule replayed (the same seed), without assembling them."""
    from tacotron_tpu_torch.data.loader import DataLoader, Dataset
    dl = DataLoader(Dataset(data_dir), batch_size=cfg.train.batch_size,
                    num_buckets=cfg.data.num_buckets, r=cfg.model.r, seed=cfg.train.seed,
                    use_native=False)
    dl._make_batch = lambda b, items: b
    out = []
    while len(out) < n_steps:
        out += list(dl.epoch())
    return [dl.buckets[b].n_frames // cfg.model.r for b in out[:n_steps]]


def capture_energy_inputs(model, batch, gen):
    """(keys, q, v) of the model's first attention-energy call on ``batch``
    (the first decoder step's), detached."""
    from tacotron_tpu_torch.ops import attention
    seen = []
    inner = attention.attention_energy

    def spy(keys, q, v):
        if not seen:
            seen.append([x.detach().clone() for x in (keys, q, v)])
        return inner(keys, q, v)

    attention.attention_energy = spy
    try:
        with torch.no_grad():
            model.train()(batch[0], batch[1], gt_mel=batch[2].float(), generator=gen)
    finally:
        attention.attention_energy = inner
    return seen[0]


def check_train_cli_kernels(cfg, ckpt_dir, step, batch, bf16):
    """K1/K2 at [train-cli]'s own inputs: the run's checkpoint ``step``
    restored as the CLI restores it, the loader's first batch and one set of
    dropout masks, with deterministic convolutions and index reductions (the
    plain energy's run is held to repeat bit for bit). The teacher-forced
    loss and every parameter gradient through the fused energy against the
    plain one. f32: the loss at [train-e2e]'s rel 1e-5; each gradient within
    [train-e2e]'s 1e-4 of its peak + 1e-7, plus CLI_GRAD_FLOOR of the
    model's largest gradient entry. bf16: the loss at [train-bf16]'s 1e-3
    (the formula rounds elsewhere than K1/K2), the gradients' distance
    printed. Then K1 and K2 alone on the keys, query and v of the model's
    first energy call: f32 at ENERGY_TOL, bf16 as ENERGY_BF16 sets out."""
    from tacotron_tpu_torch.models.tacotron import Tacotron
    from tacotron_tpu_torch.train import checkpoint, create_train_state
    from tacotron_tpu_torch.train.loss import tacotron_loss

    dev = torch.device("cuda")
    tag = "bf16" if bf16 else "f32"
    state, _ = checkpoint.restore(ckpt_dir, create_train_state(cfg, seed=1), cfg.train, step)
    weights = state.model.state_dict()
    del state
    text, lengths, mel, linear, frame_len = batch
    res = {}
    # deterministic convolutions and index reductions, so that the plain
    # energy's run repeats bit for bit and what differs is K1/K2's
    flags = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for run, energy in (("xla", "xla"), ("xla_again", "xla"), ("fused", "fused")):
            model = Tacotron(dataclasses.replace(cfg.model, attention_energy=energy), device=dev)
            model.load_state_dict(weights)
            o = model.train()(text, lengths, gt_mel=mel.float(),
                              generator=torch.Generator(device=dev).manual_seed(7))
            loss, _ = tacotron_loss(o.mel, o.linear, mel.float(), linear.float(), frame_len,
                                    mask_padding=cfg.train.mask_padding,
                                    linear_weight=cfg.train.loss_linear_weight)
            loss.backward()
            res[run] = (float(loss.detach()), {k: p.grad for k, p in model.named_parameters()})
            if run == "fused":
                inputs = capture_energy_inputs(model, batch,
                                               torch.Generator(device=dev).manual_seed(7))
            del model
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])
    repeat = res["xla"][0] == res["xla_again"][0] and all(
        torch.equal(g, res["xla_again"][1][k]) for k, g in res["xla"][1].items())
    loss_rel = abs(res["fused"][0] - res["xla"][0]) / abs(res["xla"][0])
    grads = {k: (float((res["fused"][1][k] - w).abs().max()), float(w.abs().max()))
             for k, w in res["xla"][1].items()}
    worst = max(e / (p + 1e-12) for e, p in grads.values())
    top = max(p for _, p in grads.values())
    log(f"  {tag} at the CLI's inputs (step {step}, B {text.shape[0]}, T_in {text.shape[1]}, "
        f"T_out {mel.shape[1]}): loss fused {res['fused'][0]:.6f} xla {res['xla'][0]:.6f} "
        f"(rel {loss_rel:.3e}), worst gradient err / peak {worst:.3e}, the largest gradient "
        f"entry {top:.3e}; the plain energy's run repeats bit for bit: {repeat}")
    for k, (e, p) in sorted(grads.items(), key=lambda kv: -kv[1][0] / (kv[1][1] + 1e-12))[:4]:
        log(f"    {k}: err {e:.3e}, peak {p:.3e}")
    require(repeat, f"{tag}: the plain energy's loss and gradients repeat bit for bit")
    require(np.isfinite(res["fused"][0]) and np.isfinite(res["xla"][0]), f"{tag}: losses finite")
    tol = {k: 1e-4 * p + 1e-7 + CLI_GRAD_FLOOR * top for k, (_, p) in grads.items()}
    out = {"loss": {k: v[0] for k, v in res.items()}, "loss_rel_err": loss_rel,
           "worst_grad_err_of_peak": worst, "largest_grad": top,
           "largest_grad_err": max(e for e, _ in grads.values()),
           "worst_grad_err_of_tol": max(grads[k][0] / t for k, t in tol.items())}
    if bf16:
        require(loss_rel <= 1e-3, f"{tag}: loss through K1/K2 within rel 1e-3 of the plain "
                f"energy's")
    else:
        require(loss_rel <= 1e-5, f"{tag}: loss through K1/K2 within rel 1e-5 of the plain "
                f"energy's")
        bad = {k: grads[k][0] for k, t in tol.items() if grads[k][0] > t}
        log(f"  {tag}: largest gradient error {out['largest_grad_err']:.3e}, the worst "
            f"{out['worst_grad_err_of_tol']:.3f} of its tolerance")
        require(not bad, f"{tag}: every gradient within 1e-4 of its peak + 1e-7 + "
                f"{CLI_GRAD_FLOOR} x the largest gradient entry ({bad})")
    keys, q, v = inputs
    de = torch.randn(keys.shape[:2], generator=torch.Generator().manual_seed(5)).to(dev)
    log(f"  {tag} K1/K2 alone on the first energy call's keys {tuple(keys.shape)} "
        f"{keys.dtype}, q, v")
    if bf16:
        out["kernels"] = energy_bf16_check(keys.float(), q.float(), v, de, label=f"{tag} cli ")
    else:
        errs, same_dv = energy_check(keys, q, v, de)
        for n, (err, peak) in errs.items():
            log(f"  {tag} cli {n}: max abs err {err:.3e} (peak {peak:.3f})")
            require(err <= ENERGY_TOL * peak, f"{tag} cli {n} within {ENERGY_TOL} of its peak")
        require(same_dv, f"{tag} cli dv bit-identical across two runs")
        out["kernels"] = errs
    return out


def phase_train_cli(report):
    """[train-cli] the data pipeline and the training CLI at full_1chip
    width, as a user runs them: the char-tone corpus of the trained-weights
    recipe, ``cli.preprocess.main`` on the card (the first utterances'
    features also on the CPU, held at CLI_FEATURE_TOL), then
    ``cli.train.main`` for 20 f32 steps (scan decoder, native assembler,
    fused energy, a trace window, an eval at step 20) and its resume to
    step 30 in bf16 (hoisted + remat, the device cache). Each run's K1, K2
    and K4 launches equal what its steps' buckets, decoder form and remat
    and its eval give; the checkpoint restores bit for bit; the device
    cache's batches equal the native assembler's; K1/K2 and K4 bf16 are
    held against their plain versions on the runs' own inputs."""
    import shutil

    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.cli import preprocess as preprocess_cli
    from tacotron_tpu_torch.cli import train as train_cli
    from tacotron_tpu_torch.config import AudioConfig, Config
    from tacotron_tpu_torch.data import ljspeech
    from tacotron_tpu_torch.data.loader import DataLoader, Dataset, put_batch
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference, griffin_lim_spectrum
    from tacotron_tpu_torch.infer import Synthesizer
    from tacotron_tpu_torch.train import checkpoint, create_train_state
    from tacotron_tpu_torch.weights import split_state

    c = TRAIN_CLI
    dev = torch.device("cuda")
    log(f"[train-cli] the char-tone corpus ({c['n']} utterances, text_len {c['text_len']}, "
        f"char_sec {c['char_sec']} jitter {c['jitter']}), cli.preprocess on the card, then "
        f"cli.train at full_1chip, r 5, fused energy, B {c['batch']}: {c['steps'][0]} f32 steps "
        f"(scan, native assembler), resumed to {c['steps'][1]} in bf16 (hoisted + remat, "
        f"device cache)")
    root = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    corpus, data, run = (os.path.join(root, d) for d in ("corpus", "data", "run"))
    rep = {"card": smi()}
    ljspeech.generate_char_tone_corpus(corpus, n=c["n"], seed=0, char_sec=c["char_sec"],
                                       text_len=c["text_len"], char_sec_jitter=c["jitter"])
    lines, secs = run_cli(preprocess_cli.main, ["--corpus-dir", corpus, "--data-dir", data,
                                                "--preset", "full_1chip"])
    rep["preprocess"] = {"seconds_in_process": secs, "json": json.loads(lines[-1])}
    log(f"  preprocess: {lines[-1]}; {secs:.2f} s in the process")
    ds = Dataset(data)
    require(len(ds) == c["n"] and ds.mels.shape[1] == 80 and ds.linears.shape[1] == 1025,
            f"{c['n']} utterances, 80 mels, 1025 linear bins")

    # the card's f32 features against the CPU's (cuFFT is a third FFT)
    with open(os.path.join(data, "config.json")) as f:
        acfg = AudioConfig(**json.load(f))
    entries = ljspeech.read_metadata(corpus)[:c["cpu_check"]]
    wavs = [ljspeech.load_wav(p, acfg.sample_rate) for _, p, _ in entries]
    card = ljspeech._features_batched(wavs, acfg, 16, dev)
    cpu = ljspeech._features_batched(wavs, acfg, 16, "cpu")
    feat = {}
    for i, kind in ((0, "mel"), (1, "linear")):
        d = np.concatenate([np.abs(a[i] - b[i]).ravel() for a, b in zip(card, cpu)])
        stored = np.concatenate([a[i].astype(np.float16).ravel() for a in card])
        on_disk = (ds.mels if kind == "mel" else ds.linears)[:sum(n for _, _, n in card)]
        feat[kind] = {"max_abs_err": float(d.max()), "p999": float(np.quantile(d, 0.999)),
                      "tol": CLI_FEATURE_TOL[kind],
                      "f16_equal_to_disk": bool(np.array_equal(stored, np.asarray(on_disk).ravel()))}
        log(f"  {kind} card vs CPU, {len(wavs)} utterances: max abs err {d.max():.3e}, "
            f"99.9th percentile {feat[kind]['p999']:.3e} (tol {CLI_FEATURE_TOL[kind]})")
        require(d.max() <= CLI_FEATURE_TOL[kind], f"{kind}: card within {CLI_FEATURE_TOL[kind]} "
                f"of the CPU")
        require(feat[kind]["f16_equal_to_disk"], f"{kind}: the data directory holds the card's "
                f"features, cast to f16")
    rep["features_card_vs_cpu"] = feat

    base = ["--data-dir", data, "--run-dir", run, "--preset", "full_1chip", "--set", "model.r=5",
            "--set", "model.attention_energy=fused", "--batch-size", str(c["batch"]),
            "--summary-every", "5", "--checkpoint-every", "10", "--eval-every", "20"]
    runs = {}
    for name, extra in (
            ("f32", ["--steps", str(c["steps"][0]), "--trace-steps", "12:13"]),
            ("bf16", ["--steps", str(c["steps"][1]), "--device-cache",
                      "--set", "model.tf_decoder=hoisted", "--set", "model.remat_decoder=true",
                      "--set", "model.compute_dtype=bfloat16"])):
        runtime.LAUNCHES.clear()
        lines, secs = run_cli(train_cli.main, base + extra)
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        summaries = [json.loads(ln) for ln in lines if ln.startswith('{"step"')]
        cfg = Config.from_json(open(os.path.join(run, "config.json")).read())
        first, last = (c["steps"][0], c["steps"][1]) if name == "bf16" else (0, c["steps"][0])
        n_dec = loader_schedule(data, cfg, last - first)
        remat = 2 if cfg.model.remat_decoder else 1
        evals = [s for s in range(first + 1, last + 1) if s % 20 == 0]
        want = {"attn_energy_fwd": remat * sum(n_dec) + len(evals) * cfg.model.max_decode_steps,
                "attn_energy_bwd": sum(n_dec)}
        if evals:
            want["griffin_lim"] = 3 * 60 * len(evals)
        runs[name] = {"seconds_in_process": secs, "lines": lines[:2] + lines[-1:],
                      "summaries": summaries, "launches": launches, "want_launches": want,
                      "decoder_steps": n_dec}
        for ln in lines:
            log(f"  {name}: {ln}")
        log(f"  {name}: {secs:.2f} s in the process; launches {launches}; decoder steps per "
            f"training step {n_dec}")
        losses = [s[k] for s in summaries for k in ("mel_loss", "linear_loss", "total_loss")]
        require(len(summaries) == (last - first) // 5 and all(np.isfinite(losses)),
                f"{name}: every summary's loss finite")
        require(json.loads(lines[-1]) == {"done": True, "step": last}, f"{name}: done at step {last}")
        require(launches == want, f"{name}: launches {want} ({remat} K1 per decoder step, "
                f"{len(evals)} eval(s) of {cfg.model.max_decode_steps} steps and 60 "
                f"Griffin-Lim iterations)")
        if first:
            require(lines[1] == f"resumed from step {first}", f"{name}: {lines[1]}")
        else:
            require(f"trace written: {os.path.join(run, 'trace')}" in lines and any(
                f.endswith(".pt.trace.json") for f in os.listdir(os.path.join(run, "trace"))),
                f"{name}: a trace of steps 12-13 written")
        runs[name]["frames_per_s"] = [s["frames_per_s"] for s in summaries]
        log(f"  {name}: frames_per_s by summary {runs[name]['frames_per_s']} on {rep['card']}")
        runs[name]["cfg"] = cfg
    rep["runs"] = {k: {kk: vv for kk, vv in v.items() if kk != "cfg"} for k, v in runs.items()}

    cfg32, cfg16 = runs["f32"]["cfg"], runs["bf16"]["cfg"]
    ckpt = os.path.join(run, "ckpt")
    state, step = checkpoint.restore(ckpt, create_train_state(cfg32, seed=1), cfg32.train,
                                     c["steps"][0])
    saved = np.load(os.path.join(ckpt, f"step_{step}", "leaves.npz"))
    leaves = checkpoint.state_leaves(state, cfg32.train)
    require(all(np.array_equal(a, saved[f"leaf_{i}"]) for i, (_, a) in enumerate(leaves)),
            f"step {step}'s checkpoint restores its {len(leaves)} leaves bit for bit")

    # the eval's Griffin-Lim (K4 bf16) on the eval's own magnitudes: the same
    # call as the CLI's at step 20, up to Griffin-Lim
    synth = Synthesizer(cfg32, *split_state(state.model), ds.vocab)
    del state
    res = synth(["the quick brown fox jumps over the lazy dog"], gl_iters=1)
    t_gl = res["wavs"].shape[1] // cfg32.audio.hop_length + 1
    mag = spectrogram_magnitude(torch.from_numpy(res["linear"][:, :t_gl]).to(dev), cfg32.audio)
    kw = dict(momentum=cfg32.audio.gl_momentum, **gl_kw(cfg32.audio))
    rep["griffin_lim_bf16_eval"] = check_gl_path(
        f"train-cli eval: griffin_lim bf16 (B 1, F {t_gl})", mag, cfg32.audio,
        lambda n: griffin_lim_spectrum(mag, n_iter=n, **kw),
        lambda n: gl_spectrum_reference(mag, n_iter=n, **kw), 60,
        over_share=GL_EVAL_STEP_SHARE)
    del synth, res, mag

    # the device cache's batches against the native assembler's, and each
    # assembler's time per batch
    kw = dict(batch_size=c["batch"], num_buckets=cfg16.data.num_buckets, r=5, seed=0)
    native, cache = DataLoader(ds, **kw), DataLoader(ds, device_cache=True, **kw)
    nb, cb = list(native.epoch()), list(cache.epoch())
    require(len(nb) == len(cb) > 0 and all(
        n.bucket == k.bucket and n.items == k.items and all(
            torch.equal(torch.from_numpy(a), t.cpu()) for a, t in zip(n.arrays(), k.arrays()))
        for n, k in zip(nb, cb)), f"the device cache's {len(cb)} batches of an epoch equal the "
                                  f"native assembler's")
    ms = {}
    for name, dl in (("native", native), ("native_to_card", native), ("device_cache", cache)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in dl.epoch():
            if name == "native_to_card":
                put_batch(b, dev)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / len(nb)
    rep["assembler_ms_per_batch"] = ms
    log(f"  ms per batch, B {c['batch']}, an epoch of {len(nb)}: native {ms['native']:.3f} "
        f"(+ pinned copy to the card {ms['native_to_card']:.3f}), device cache "
        f"{ms['device_cache']:.3f}; {rep['card']}")
    del cache, cb

    # K1/K2 on the runs' inputs: the loader's first batch, each run's last checkpoint
    first = nb[0]
    batch = put_batch(first, dev)[0]
    rep["kernels_at_cli_inputs"] = {
        "f32": check_train_cli_kernels(cfg32, ckpt, c["steps"][0], batch, False),
        "bf16": check_train_cli_kernels(cfg16, ckpt, c["steps"][1], batch, True)}
    report["train_cli"] = rep
    return {"attn_energy_fwd": runs["f32"]["launches"].get("attn_energy_fwd", 0),
            "attn_energy_bwd": runs["f32"]["launches"].get("attn_energy_bwd", 0),
            "attn_energy_fwd_bf16": runs["bf16"]["launches"].get("attn_energy_fwd", 0),
            "attn_energy_bwd_bf16": runs["bf16"]["launches"].get("attn_energy_bwd", 0),
            "griffin_lim_bf16": runs["f32"]["launches"].get("griffin_lim", 0)}


def steps_done_of(mel, r):
    """Decoder steps that produced a nonzero frame (the early-exit decode
    leaves exact zeros past its exit)."""
    live = np.abs(mel).max(axis=(0, 2)) > 0
    return int(-(-(np.nonzero(live)[0].max() + 1) // r)) if live.any() else 0


def exit_threshold(mel, r, min_steps):
    """A silence threshold just above the first ``min_steps`` steps' group
    peaks of a full-length run, at which the same run exits after step
    ``min_steps``. With seeded random weights this is the only exit inside
    (0, n_steps) that any threshold reaches: every row's quietest window is
    its first (the decoder starts from zero state and its output grows), so
    a threshold either trips there or never. -> (threshold, quietest later
    window's peak)."""
    b, t, n = mel.shape
    g = mel.reshape(b, t // r, r * n).max(axis=(0, 2)).astype(np.float64)
    w = np.array([g[i:i + min_steps].max() for i in range(len(g) - min_steps + 1)])
    return float(w[0]) + 1e-3, float(w[1:].min())


def phase_fast(report, vocab):
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference, griffin_lim_spectrum
    from tacotron_tpu_torch.infer.synthesize import STAGES, Synthesizer
    from tacotron_tpu_torch.weights import split_state

    dev = torch.device("cuda")
    cfg = get_config("synth_fast")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    acfg, icfg, r = cfg.audio, cfg.infer, cfg.model.r
    n_steps, hop, q = cfg.model.max_decode_steps, acfg.hop_length, icfg.gl_length_quantum
    min_steps = max(1, -(-icfg.min_silence_frames // r))
    log(f"[fast] Synthesizer, synth_fast, B 8, up to {n_steps} steps (early exit after "
        f"{min_steps} silent steps), trim to a multiple of {q}, GL {acfg.griffin_lim_iters} x "
        f"momentum {acfg.gl_momentum}, bf16")
    p, bs = split_state(full_model(cfg, dev))

    def run(c, seed, label):
        synth = Synthesizer(c, p, bs, vocab)
        runtime.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = synth(PROMPTS, seed=seed, stage_ms=True)
        wall = time.perf_counter() - t0
        launches = dict(runtime.LAUNCHES)
        steps = steps_done_of(out["mel"], r)
        t_gl = out["wavs"].shape[1] // hop + 1
        res = {"stage_ms": out["stage_ms"], "wall_s": wall, "steps_done": steps, "t_gl": t_gl,
               "audio_seconds": out["audio_seconds"],
               "trimmed_audio_seconds": out["trimmed_audio_seconds"],
               "audio_seconds_per_s": out["audio_seconds"] / wall,
               "trimmed_audio_seconds_per_s": out["trimmed_audio_seconds"] / wall,
               "end_frames": out["end_frames"].tolist(), "launches": launches,
               "silence_threshold": c.infer.silence_threshold}
        log(f"  {label}: {wall:.3f} s; steps_done {steps}, t_gl {t_gl}, end_frames "
            f"{res['end_frames']}")
        for s_ in STAGES:
            log(f"    stage {s_}: {out['stage_ms'][s_]:.3f} ms")
        log(f"    audio_seconds {out['audio_seconds']:.3f} (as synthesized) -> "
            f"{res['audio_seconds_per_s']:.3f} per s; trimmed {out['trimmed_audio_seconds']:.3f}"
            f" -> {res['trimmed_audio_seconds_per_s']:.3f} per s; launches {launches}")
        wav = out["wavs"]
        require(launches.get("griffin_lim", 0) == 3 * acfg.griffin_lim_iters,
                f"{label}: the Griffin-Lim kernel launched 3 x {acfg.griffin_lim_iters} times")
        require(wav.shape == (8, hop * (t_gl - 1)) and bool(np.isfinite(wav).all())
                and float(np.abs(wav).max()) > 0, f"{label}: wavs {wav.shape} finite, peak > 0")
        return out, res

    run(cfg, 0, "warm call")
    out1, res1 = run(cfg, 1, "timed call, the preset's threshold")
    if res1["steps_done"] == n_steps:
        log(f"  the preset's threshold {icfg.silence_threshold} never tripped on random "
            f"weights: all {n_steps} steps ran and nothing was trimmed (a valid run)")
    # the same seed draws the same dropout masks, so the run repeats up to its exit
    full = out1 if res1["steps_done"] == n_steps else run(
        cfg.replace(infer=dataclasses.replace(icfg, silence_threshold=-1.0)), 1,
        "full-length call")[0]
    thr, later = exit_threshold(full["mel"], r, min_steps)
    log(f"  derived silence threshold {thr:.6f}, just above the first {min_steps} steps' peak; "
        f"the quietest later window peaks at {later:.4f}: the exit after step {min_steps} with "
        f"every end frame 0 is the only early exit these weights allow")
    cfg2 = cfg.replace(infer=dataclasses.replace(icfg, silence_threshold=thr))
    out2, res2 = run(cfg2, 1, "timed call, the derived threshold")
    steps, t_gl = res2["steps_done"], res2["t_gl"]
    require(0 < steps < n_steps, f"early exit strictly inside: 0 < {steps} < {n_steps}")
    require(steps == min_steps, f"the exit comes after step {min_steps}, as derived")
    require(float(np.abs(out2["mel"][:, steps * r:]).max()) == 0.0
            and float(np.abs(out2["alignments"][:, steps:]).max()) == 0.0,
            "frames and alignments past the exit are zero")
    require(np.array_equal(out2["mel"][:, :steps * r], full["mel"][:, :steps * r]),
            "frames up to the exit equal the full-length run's")
    require(t_gl % q == 0 and t_gl < n_steps * r, f"t_gl {t_gl} a multiple of {q} below "
            f"{n_steps * r}")
    require(out2["wavs"].shape[1] == hop * (t_gl - 1), "wav length hop x (t_gl - 1)")

    # this run's Griffin-Lim, kernel vs plain bf16 version at the trimmed shape
    mag = spectrogram_magnitude(torch.from_numpy(out2["linear"][:, :t_gl]).to(dev), acfg)
    kw = dict(momentum=acfg.gl_momentum, **gl_kw(acfg))
    chk = check_gl_path(f"griffin_lim bf16 at the trimmed shape (B 8, F {t_gl})", mag, acfg,
                        lambda n: griffin_lim_spectrum(mag, n_iter=n, **kw),
                        lambda n: gl_spectrum_reference(mag, n_iter=n, **kw),
                        acfg.griffin_lim_iters)
    chk["speech_like"] = check_gl_speech("griffin_lim bf16 at the trimmed shape", 8, t_gl, acfg,
                                         [(9, acfg.gl_momentum), (10, acfg.gl_momentum)])
    chk["f32_steps"] = check_gl_f32_steps(f"griffin_lim f32 at the trimmed shape (B 8, F {t_gl})",
                                          mag, acfg)
    # how far Griffin-Lim itself carries a difference on these magnitudes: the
    # f32 kernel against the f32 plain loop, which differ by summation order only
    with torch.no_grad():
        spread = {n: gl_errors(griffin_lim_spectrum(mag, n_iter=n, lowp=False, **kw),
                               gl_spectrum_reference(mag, n_iter=n, lowp=False, **kw), mag,
                               acfg)[0]
                  for n in (1, 10)}
    log(f"  the same magnitudes (min {float(mag.min()):.3e}, max {float(mag.max()):.3e}) through "
        f"the f32 kernel and the f32 plain loop: wav err / peak {spread[1]:.3e} after 1 "
        f"iteration, {spread[10]:.3e} after 10")
    chk["f32_wav_err_over_peak_by_iterations"] = spread
    report["checks"]["griffin_lim_bf16_trimmed_shape"] = chk
    report["fast"] = {"preset_threshold": res1, "derived_threshold": res2,
                      "expected_steps": min_steps}
    mag1 = spectrogram_magnitude(
        torch.from_numpy(out1["linear"][:, :res1["t_gl"]]).to(dev), acfg)
    return cfg, res1, mag1


def phase_stream(report, mag, acfg):
    """The streaming entry point in both modes and the probes' entry point,
    each with the counts set to 0 just before it; the f32 kernels' step
    check on [main]'s and a speech-like magnitude."""
    from tacotron_tpu_torch import probe, runtime
    from tacotron_tpu_torch.dsp.fused_gl import (gl_spectrum_reference, gl_step_reference,
                                                 griffin_lim_spectrum, zero_phase)

    n = 100
    kw = dict(n_iter=n, **gl_kw(acfg))
    log(f"[stream] griffin_lim(inner=1), B {mag.shape[0]}, F {mag.shape[1]}, bf16, {n} "
        f"iterations, momentum 0")
    res = {}
    with torch.no_grad():
        runtime.LAUNCHES.clear()
        call_ms = cuda_ms(lambda: res.update(k5=griffin_lim_spectrum(mag, inner=1, **kw)))
        launches = dict(runtime.LAUNCHES)
        res["k4"] = griffin_lim_spectrum(mag, **kw)
        plain_ms = cuda_ms(lambda: res.update(plain=gl_spectrum_reference(mag, **kw)))
    log(f"  {n} calls {call_ms:.3f} ms with the host; launches {launches}")
    require(launches.get("griffin_lim_step") == 4 * n and "griffin_lim" not in launches,
            f"the streaming kernel launched 4 x {n} times (pack + 3), the whole-loop kernel "
            f"not at all")
    require(all(torch.equal(a, b) for a, b in zip(res["k5"], res["k4"])),
            f"griffin_lim_step bf16 bit-equal to K4 bf16 at beta 0 after {n} iterations")
    k5 = lambda it: griffin_lim_spectrum(mag, inner=1, n_iter=it, **gl_kw(acfg))
    chk = {"vs_plain": check_gl_path(
               "griffin_lim_step bf16 vs plain steps", mag, acfg, k5,
               lambda it: gl_spectrum_reference(mag, n_iter=it, **gl_kw(acfg)), n,
               at_depth=(res["k5"], res["plain"])),
           "vs_k4": check_gl_path(
               "griffin_lim_step bf16 vs K4 bf16, beta 0", mag, acfg, k5,
               lambda it: griffin_lim_spectrum(mag, n_iter=it, **gl_kw(acfg)), n,
               at_depth=(res["k5"], res["k4"]), steps=False)}
    report["checks"]["griffin_lim_step_main_shapes"] = chk
    report["stream"] = {"calls": n, "ms_with_host": call_ms, "plain_ms": plain_ms,
                        "launches": launches}

    log(f"[stream-f32] griffin_lim(inner=1, lowp=False), B {mag.shape[0]}, F {mag.shape[1]}, "
        f"{n} iterations, momentum 0: the f32 streaming kernel (split TF32 products)")
    with torch.no_grad():
        runtime.LAUNCHES.clear()
        f32_call_ms = cuda_ms(lambda: res.update(k5f=griffin_lim_spectrum(
            mag, inner=1, lowp=False, **kw)))
        f32_counts = dict(runtime.LAUNCHES)
        res["k4f"] = griffin_lim_spectrum(mag, lowp=False, **kw)
        f32_plain_ms = cuda_ms(lambda: gl_step_reference(*zero_phase(mag, False), mag,
                                                         lowp=False, **gl_kw(acfg)), reps=10)
    f32_launches = f32_counts.get("griffin_lim_step", 0)
    log(f"  {n} calls {f32_call_ms:.3f} ms with the host; launches {f32_counts}")
    require(f32_launches == 4 * n and "griffin_lim" not in f32_counts,
            f"the f32 streaming kernel launched 4 x {n} times (pack + 3), the whole-loop kernel "
            f"not at all")
    require(all(torch.equal(a, b) for a, b in zip(res["k5f"], res["k4f"])),
            f"griffin_lim_step f32 bit-equal to K4 f32 at beta 0 after {n} iterations")
    f32_chk = {"steps_main_magnitudes": check_gl_f32_steps(
                   f"griffin_lim f32 on [main]'s magnitudes (B {mag.shape[0]}, F {mag.shape[1]})",
                   mag, acfg),
               "steps_speech_like": check_gl_f32_steps(
                   f"griffin_lim f32, speech-like B {mag.shape[0]} F {mag.shape[1]}",
                   sample_magnitude(*mag.shape[:2], acfg, mag.device, seed=6), acfg)}
    report["checks"]["griffin_lim_f32_steps"] = f32_chk
    report["stream_f32"] = {"calls": n, "ms_with_host": f32_call_ms,
                            "plain_step_ms": f32_plain_ms, "launches": f32_launches}
    f32_err = max(max(c["k4"], c["k5"]) for c in f32_chk.values())

    log("[probe] python -m tacotron_tpu_torch.probe smem 227 / ops")
    runtime.LAUNCHES.clear()
    require(probe.main(["smem", "227"]) == 0 and probe.main(["ops"]) == 0,
            "both probes answer True")
    launches.update(runtime.LAUNCHES)
    require(launches.get("probe_smem") == 1 and launches.get("probe_ops") == 1,
            "each probe launched its kernel once")
    launches["griffin_lim_step_f32"] = f32_launches
    return (launches, call_ms / n, plain_ms / n, chk["vs_plain"]["step_max_err_over_mag_peak"],
            f32_plain_ms, f32_err)


def phase_timing(report, synth, launches, mag, f32_spec, f32_time):
    """K3 and K4 (f32) at [main]'s shapes; ``f32_spec`` and ``f32_time``
    (device ms, gl_stages) are the f32 kernel's result and time from
    [main]'s Griffin-Lim run."""
    from tacotron_tpu_torch.dsp.fused_gl import f64_matmul, gl_spectrum_reference
    from tacotron_tpu_torch.ops.decode_loop import (CLUSTER_SIZES, _decode_loop_cuda,
                                                    cluster_plan, decode_loop,
                                                    decode_loop_reference, pack_decoder_weights)
    from tacotron_tpu_torch.probe import probe_cluster_barrier

    dev = torch.device("cuda")
    cfg, m = synth.cfg, synth.model
    log("[timing] K3 and K4 (f32) at [main]'s shapes")
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
    b = memory.shape[0]
    chosen, resident = cluster_plan(memory, keys, w)
    sweep, barrier_us, barrier_clusters = {}, {}, {}
    with torch.no_grad():
        for c in CLUSTER_SIZES:
            def run():
                _decode_loop_cuda(memory, keys, mask, w, seed=5, dropout=True, lowp=True,
                                  return_keep_counts=False, _cluster=c, **dkw)
            run()
            sweep[c] = cuda_ms(run, reps=3)
            # the cluster barrier alone: N barriers less none, over N, in as
            # many clusters of c as the card holds at once, up to B
            nb, k = 20000, min(b, resident[c])
            t0 = cuda_ms(lambda: probe_cluster_barrier(k, c, 0), reps=3)
            t1 = cuda_ms(lambda: probe_cluster_barrier(k, c, nb), reps=3)
            barrier_us[c], barrier_clusters[c] = (t1 - t0) / nb * 1e3, k
            log(f"  K3 cluster {c:2d}: {resident[c]:3d} clusters resident, {sweep[c]:.3f} ms, "
                f"{sweep[c] / n * 1e3:.2f} us per step; cluster barrier {barrier_us[c]:.3f} us "
                f"({k} clusters)")
    log(f"  K3 at the chosen cluster size {chosen}: {k_ms:.3f} ms, {sweep[1] / sweep[chosen]:.2f}x "
        f"faster than at 1 ({sweep[1]:.3f} ms)")
    require(sweep[1] >= 2 * sweep[chosen],
            f"K3 at cluster size {chosen} at least 2x faster than at 1")
    dec = {"name": "decode_loop", "route": "cuda",
           "source": "tacotron_tpu_torch/csrc/decode_loop.cu",
           "replaces": "tacotron_tpu/ops/pallas/decode_loop.py:103",
           "launches": launches.get("decode_loop", 0), "path": "[main]",
           "max_abs_err": d_err,
           "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": dbound[0], "bound_by": dbound[1], "library_ms": None,
           "shape": f"B {b} T_in {memory.shape[1]} steps {n} bf16",
           "cluster": chosen, "us_per_step": k_ms / n * 1e3,
           "resident_clusters": resident, "ms_by_cluster": sweep,
           "us_per_step_by_cluster": {c: v / n * 1e3 for c, v in sweep.items()},
           "cluster_barrier_us": barrier_us, "cluster_barrier_clusters": barrier_clusters}

    acfg = cfg.audio
    n_it = acfg.griffin_lim_iters
    kw = dict(n_iter=n_it, momentum=acfg.gl_momentum, **gl_kw(acfg))
    res = {}
    with torch.no_grad():
        gp_ms = cuda_ms(lambda: res.update(plain=gl_spectrum_reference(mag, lowp=False, **kw)))
        exact = gl_spectrum_reference(mag, lowp=False, product=f64_matmul, **kw)
        gl_lib_ms = dft_products_ms(mag, acfg, n_it, torch.float32)
        gl_lib_pad_ms = dft_products_ms(mag, acfg, n_it, torch.float32, padded=True)
    log(f"  griffin_lim f32 at main shapes ({n_it} iterations):")
    chk = check_gl("griffin_lim f32 at main shapes", f32_spec, res["plain"], mag, acfg, None)
    tol = MAIN_TOL["griffin_lim"]
    chk["kernel_vs_f64_sums"] = gl_errors(f32_spec, exact, mag, acfg)[0]
    chk["plain_f32_vs_f64_sums"] = gl_errors(res["plain"], exact, mag, acfg)[0]
    factor = MAIN_TOL["griffin_lim_f32_vs_f64"]
    log(f"  its waveform {chk['wav_max_abs_err_over_peak']:.3e} of the peak from the plain f32 "
        f"loop is " + ("within" if chk["wav_max_abs_err_over_peak"] <= tol else "PAST")
        + f" MAIN_TOL {tol} (printed); the loop with f64 sums ends "
        f"{chk['kernel_vs_f64_sums']:.3e} from the kernel and {chk['plain_f32_vs_f64_sums']:.3e} "
        f"from the plain f32 loop")
    chk["f64_factor"] = factor
    require(chk["kernel_vs_f64_sums"] <= factor * chk["plain_f32_vs_f64_sums"],
            f"griffin_lim f32 at main shapes: the kernel's waveform within {factor} x the plain "
            f"f32 loop's distance from the loop with f64 sums")
    report["checks"]["griffin_lim_main_shapes"] = chk
    gl_err = chk["wav_max_abs_err_over_peak"]
    rows, nb, win = mag.shape[0] * mag.shape[1], mag.shape[2], acfg.win_length
    gbound, cores_ms = gl_bound_f32(rows, nb, win, n_it)
    gk_ms, stages = f32_time
    it_ms = gk_ms / n_it
    gl = {"name": "griffin_lim_f32", "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/griffin_lim.cu",
          "replaces": "tacotron_tpu/dsp/pallas_gl.py:419",
          "launches": launches.get("griffin_lim_f32", 0),
          "path": "direct call of griffin_lim_spectrum(lowp=False) after [main]; no preset "
                  "selects the f32 kernel",
          "max_abs_err": gl_err,
          "max_abs_err_of": "the waveform against the plain f32 loop's after the 1000 iterations, "
                            "over its peak (printed; held: the distance from the loop with f64 "
                            "sums, kernel_vs_f64_sums, within the plain f32 loop's)",
          "kernel_vs_f64_sums": chk["kernel_vs_f64_sums"],
          "plain_f32_vs_f64_sums": chk["plain_f32_vs_f64_sums"],
          "ms": gk_ms, "plain_ms": gp_ms,
          "bound_ms": gbound[0], "bound_by": gbound[1], "library_ms": gl_lib_ms,
          "library_padded_ms": gl_lib_pad_ms, "bound_cuda_cores_ms": cores_ms,
          "shape": f"B {mag.shape[0]} F {mag.shape[1]} iters {n_it} f32 (split TF32 products)",
          "ms_per_iteration": it_ms,
          "stage_ms_per_iteration": {k: v[0] / n_it for k, v in stages.items()},
          "tf32_products_taken": tf32_products_taken(),
          "tf32_products_bound": TF32_PRODUCTS_BOUND,
          "tf32_tflops": (tf32_products_taken() * 2 * 2 * rows * win * 2 * nb
                          / (it_ms * 1e-3) / 1e12),
          "bound_share": gbound[0] / gk_ms}
    log(f"  griffin_lim_f32: {it_ms * 1e3:.1f} us per iteration of device time: "
        + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in gl["stage_ms_per_iteration"].items()
                    if stages[k][1])
        + f"; {gl['tf32_tflops']:.1f} TFLOP/s of TF32 work ({tf32_products_taken()} products "
        f"per f32 product), {100 * gl['bound_share']:.1f}% of the TF32 bound "
        f"{gbound[0] / n_it * 1e3:.1f} us ({TF32_PRODUCTS_BOUND} products; CUDA-core f32 bound "
        f"{cores_ms / n_it * 1e3:.1f} us); two f32 torch.matmul {gl_lib_ms / n_it * 1e3:.1f} us, "
        f"at the padded shapes {gl_lib_pad_ms / n_it * 1e3:.1f} us; plain "
        f"{gp_ms / n_it * 1e3:.1f} us")
    for k in (dec, gl):
        log(f"  {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f} ms, "
            f"bound {k['bound_ms']:.3f} ms by {k['bound_by']}, library {k['library_ms']})")
    return [dec, gl]


# the bf16 Griffin-Lim kernels (csrc/griffin_lim.cu) by device-side name
GL_STAGES = {"synthesis": "gl_wgmma<0", "ola_frame": "gl_ola_frame", "analysis": "gl_wgmma<1",
             "pack": "gl_pack"}


def gl_stages(fn, reps=1):
    """Run ``fn`` ``reps`` times under torch.profiler -> {stage: (device ms
    per rep, launches per rep)} of the bf16 Griffin-Lim kernels."""
    rows = device_kernels(fn, reps)
    return {st: (sum(v[0] for k, v in rows.items() if pat in k),
                 sum(v[1] for k, v in rows.items() if pat in k))
            for st, pat in GL_STAGES.items()}


def ptxas_report(log_text):
    """The ``-Xptxas -v`` build log -> [{kernel, registers, spill_stores,
    spill_loads, static_smem}] per compiled entry function."""
    import re
    out, cur = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", ln)):
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(k["kernel"] for k in out),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for k, n in zip(out, names):
            k["kernel"] = n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
    except (OSError, subprocess.CalledProcessError):
        pass
    return out


def kernel_ms(fn, names, reps=1):
    """Device milliseconds per rep of the kernels whose name holds one of
    ``names`` while ``fn`` runs (torch.profiler), and their launches per rep."""
    rows = [v for k, v in device_kernels(fn, reps).items() if any(n in k for n in names)]
    return sum(ms for ms, _ in rows), sum(n for _, n in rows)


def phase_timing_serving(report, fast_cfg, fast_res, mag_fast, mag_main, main_launches, stream):
    """K4 (bf16), K5 and the probes at their paths' shapes: device time by
    torch.profiler beside the plain version, the library yardstick (the two
    DFT products as bf16 torch.matmul; for P1 ``torch.mul``) and the bound.
    K4 bf16 is also held to its plain version as [main] runs it (its
    magnitudes, momentum 0, 1000 iterations) and on a speech-like magnitude
    of that shape."""
    from tacotron_tpu_torch import probe, runtime
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference, griffin_lim_spectrum

    dev = torch.device("cuda")
    acfg = fast_cfg.audio
    nb, win = acfg.n_freq, acfg.win_length
    log("[timing] K4 (bf16), K5, P1, P2 at their paths' shapes")

    n_it = acfg.griffin_lim_iters
    kw = dict(n_iter=n_it, momentum=acfg.gl_momentum, **gl_kw(acfg))
    res = {}

    def timed(fn, reps=1):
        """gl_stages of fn, and the wrapper's launch counts over the same reps."""
        before = dict(runtime.LAUNCHES)
        st = gl_stages(fn, reps)
        counted = {k: (v - before.get(k, 0)) / reps for k, v in runtime.LAUNCHES.items()}
        return st, counted

    with torch.no_grad():
        st_fast, cnt_fast = timed(lambda: res.update(k=griffin_lim_spectrum(mag_fast, **kw)))
        p_ms = cuda_ms(lambda: res.update(p=gl_spectrum_reference(mag_fast, **kw)))
        lib_ms = dft_products_ms(mag_fast, acfg, n_it, torch.bfloat16)
        lib_pad_ms = dft_products_ms(mag_fast, acfg, n_it, torch.bfloat16, padded=True)
        # [main]'s shape and depth: momentum 0, 1000 iterations
        m_it = 1000
        st_main, cnt_main = timed(lambda: res.update(km=griffin_lim_spectrum(
            mag_main, n_iter=m_it, **gl_kw(acfg))))
        res["pm"] = gl_spectrum_reference(mag_main, n_iter=m_it, **gl_kw(acfg))
        lib_main = dft_products_ms(mag_main, acfg, 10, torch.bfloat16) / 10
        lib_pad_main = dft_products_ms(mag_main, acfg, 10, torch.bfloat16, padded=True) / 10
    for label, st, cnt, it in (("[fast]", st_fast, cnt_fast, n_it), ("[main]", st_main, cnt_main,
                                                                       m_it)):
        dev_launches = sum(n for _, n in st.values())
        require(dev_launches == cnt.get("griffin_lim") == 3 * it and st["pack"][1] == 0,
                f"K4 bf16 at {label}'s shape: {dev_launches:.0f} device launches = LAUNCHES "
                f"{cnt.get('griffin_lim')} = 3 per iteration")
    k_ms = sum(ms for ms, _ in st_fast.values())
    main_ms = sum(ms for ms, _ in st_main.values())
    chk = check_gl_path(
        f"griffin_lim bf16 at [fast]'s shape (B {mag_fast.shape[0]}, F {mag_fast.shape[1]})",
        mag_fast, acfg,
        lambda it: griffin_lim_spectrum(mag_fast, **{**kw, "n_iter": it}),
        lambda it: gl_spectrum_reference(mag_fast, **{**kw, "n_iter": it}), n_it,
        at_depth=(res["k"], res["p"]), steps=False)
    report["checks"]["griffin_lim_bf16_fast_shape"] = chk
    chk_main = check_gl_path(
        f"griffin_lim bf16 as [main] runs it (B {mag_main.shape[0]}, F {mag_main.shape[1]}, "
        f"momentum 0)", mag_main, acfg,
        lambda it: griffin_lim_spectrum(mag_main, n_iter=it, **gl_kw(acfg)),
        lambda it: gl_spectrum_reference(mag_main, n_iter=it, **gl_kw(acfg)), m_it,
        at_depth=(res["km"], res["pm"]), steps=False)
    chk_main["speech_like"] = check_gl_speech(
        "griffin_lim bf16 at [main]'s and [fast]'s shape", *mag_main.shape[:2], acfg,
        [(10, 0.0), (9, acfg.gl_momentum), (10, acfg.gl_momentum)])
    report["checks"]["griffin_lim_bf16_main_shape"] = chk_main
    rows = mag_fast.shape[0] * mag_fast.shape[1]
    rows_main = mag_main.shape[0] * mag_main.shape[1]
    b4 = gl_bound_bf16(rows, nb, win, n_it)
    b4_main = gl_bound_bf16(rows_main, nb, win, 1)
    main_it_ms = main_ms / m_it
    tflops = 2 * 2 * rows_main * win * 2 * nb / (main_it_ms * 1e-3) / 1e12
    k4 = {"name": "griffin_lim_bf16", "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/griffin_lim.cu",
          "replaces": "tacotron_tpu/dsp/pallas_gl.py:419",
          "launches": fast_res["launches"].get("griffin_lim", 0), "path": "[fast]",
          "main_launches": main_launches.get("griffin_lim", 0),
          "max_abs_err": max(chk["max_abs_err"], chk_main["speech_like"]["max_abs_err"]),
          "max_abs_err_of": f"waveform over its peak: the path's magnitudes after "
                            f"{GL_PATH['iters']} iterations, a speech-like magnitude of its "
                            f"shape after 9 and 10",
          "ms": k_ms, "plain_ms": p_ms, "bound_ms": b4[0], "bound_by": b4[1],
          "library_ms": lib_ms, "library_padded_ms": lib_pad_ms,
          "shape": f"B {mag_fast.shape[0]} F {mag_fast.shape[1]} iters {n_it} momentum "
                   f"{acfg.gl_momentum} bf16",
          "ms_per_iteration": k_ms / n_it, "device_launches": sum(n for _, n in st_fast.values()),
          "stage_ms_per_iteration": {k: v[0] / n_it for k, v in st_fast.items()},
          "main_shape_ms": main_ms, "main_shape_ms_per_iteration": main_it_ms,
          "main_shape": f"B {mag_main.shape[0]} F {mag_main.shape[1]} iters {m_it} momentum 0 bf16",
          "main_shape_bound_ms_per_iteration": b4_main[0],
          "main_shape_stage_ms_per_iteration": {k: v[0] / m_it for k, v in st_main.items()},
          "main_shape_tflops": tflops, "main_shape_bound_share": b4_main[0] / main_it_ms,
          "main_shape_library_ms_per_iteration": lib_main,
          "main_shape_library_padded_ms_per_iteration": lib_pad_main}
    log(f"  griffin_lim_bf16 at [fast]'s shape: {k_ms:.3f} ms per call, "
        f"{k_ms / n_it * 1e3:.1f} us per iteration (plain {p_ms:.3f} ms, bound {b4[0]:.3f} ms by "
        f"{b4[1]}, two bf16 torch.matmul {lib_ms:.3f} ms, at the padded shapes {lib_pad_ms:.3f} "
        f"ms); per iteration "
        + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in k4["stage_ms_per_iteration"].items()))
    log(f"  griffin_lim_bf16 at [main]'s shape: {main_ms:.3f} ms per {m_it} iterations, "
        f"{main_it_ms * 1e3:.1f} us per iteration: "
        + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in
                    k4["main_shape_stage_ms_per_iteration"].items())
        + f"; {tflops:.1f} TFLOP/s, {100 * b4_main[0] / main_it_ms:.1f}% of the bound "
        f"{b4_main[0] * 1e3:.1f} us; two bf16 torch.matmul {lib_main * 1e3:.1f} us, at the padded "
        f"shapes {lib_pad_main * 1e3:.1f} us")

    launches, call_ms, plain_step_ms, s_err, f32_plain_step_ms, f32_err = stream
    reps = 20
    with torch.no_grad():
        st5, cnt5 = timed(lambda: griffin_lim_spectrum(mag_main, n_iter=reps, inner=1,
                                                       **gl_kw(acfg)))
        s_lib = dft_products_ms(mag_main, acfg, reps, torch.bfloat16) / reps
        s_lib_pad = dft_products_ms(mag_main, acfg, reps, torch.bfloat16, padded=True) / reps
    s_ms = sum(ms for ms, _ in st5.values())
    s_n = sum(n for _, n in st5.values())
    require(s_n == cnt5.get("griffin_lim_step") == 4 * reps and st5["pack"][1] == reps,
            f"K5: {s_n:.0f} device launches = LAUNCHES {cnt5.get('griffin_lim_step')} = 4 per "
            f"call, one of them the pack")
    b5 = gl_bound_bf16(rows_main, nb, win, 1, planar_io=True)
    k5 = {"name": "griffin_lim_step", "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/griffin_lim.cu",
          "replaces": "tacotron_tpu/dsp/pallas_gl.py:535",
          "launches": launches.get("griffin_lim_step", 0), "path": "[stream]",
          "max_abs_err": s_err,
          "max_abs_err_of": "one call from the plain loop's state, over the magnitude's peak",
          "ms": s_ms / reps, "plain_ms": plain_step_ms, "bound_ms": b5[0], "bound_by": b5[1],
          "library_ms": s_lib, "library_padded_ms": s_lib_pad,
          "shape": f"B {mag_main.shape[0]} F {mag_main.shape[1]} one iteration per call bf16",
          "call_ms": call_ms, "device_launches_per_call": s_n / reps,
          "stage_ms_per_call": {k: v[0] / reps for k, v in st5.items()}}
    log(f"  griffin_lim_step: {k5['ms']:.3f} ms of device time per call in "
        f"{k5['device_launches_per_call']:.0f} launches ("
        + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in k5["stage_ms_per_call"].items())
        + f"), {call_ms:.3f} ms per call with the host (plain {plain_step_ms:.3f} ms, bound "
        f"{b5[0]:.3f} ms by {b5[1]}, library {s_lib:.3f} ms, at the padded shapes "
        f"{s_lib_pad:.3f} ms)")

    # K5 f32 at [stream-f32]'s shape: [main]'s magnitudes, one iteration per call
    with torch.no_grad():
        st5f, cnt5f = timed(lambda: griffin_lim_spectrum(mag_main, n_iter=reps, inner=1,
                                                         lowp=False, **gl_kw(acfg)))
        f_lib = dft_products_ms(mag_main, acfg, reps, torch.float32) / reps
        f_lib_pad = dft_products_ms(mag_main, acfg, reps, torch.float32, padded=True) / reps
    f_ms = sum(ms for ms, _ in st5f.values())
    f_n = sum(n for _, n in st5f.values())
    require(f_n == cnt5f.get("griffin_lim_step") == 4 * reps and st5f["pack"][1] == reps,
            f"K5 f32: {f_n:.0f} device launches = LAUNCHES {cnt5f.get('griffin_lim_step')} = 4 "
            f"per call, one of them the pack")
    b5f, cores5f = gl_bound_f32(rows_main, nb, win, 1, planar_io=True)
    k5f = {"name": "griffin_lim_step_f32", "route": "cuda",
           "source": "tacotron_tpu_torch/csrc/griffin_lim.cu",
           "replaces": "tacotron_tpu/dsp/pallas_gl.py:535",
           "launches": launches.get("griffin_lim_step_f32", 0), "path": "[stream-f32]",
           "max_abs_err": f32_err,
           "max_abs_err_of": "one K4 or K5 f32 step against the f64 step, over the magnitude's "
                             "peak ([main]'s and a speech-like magnitude)",
           "ms": f_ms / reps, "plain_ms": f32_plain_step_ms, "bound_ms": b5f[0],
           "bound_by": b5f[1], "library_ms": f_lib, "library_padded_ms": f_lib_pad,
           "bound_cuda_cores_ms": cores5f,
           "shape": f"B {mag_main.shape[0]} F {mag_main.shape[1]} one iteration per call f32 "
                    f"(split TF32 products)",
           "device_launches_per_call": f_n / reps,
           "stage_ms_per_call": {k: v[0] / reps for k, v in st5f.items()}}
    log(f"  griffin_lim_step_f32: {k5f['ms']:.3f} ms of device time per call in "
        f"{k5f['device_launches_per_call']:.0f} launches ("
        + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in k5f["stage_ms_per_call"].items())
        + f") (plain {f32_plain_step_ms:.3f} ms, bound {b5f[0]:.3f} ms by {b5f[1]}, CUDA-core "
        f"bound {cores5f:.3f} ms, two f32 torch.matmul {f_lib:.3f} ms, at the padded shapes "
        f"{f_lib_pad:.3f} ms)")

    x = torch.ones(probe.SMEM_SHAPE, device=dev)
    ops_in = probe.ops_inputs(dev)
    reps = 50
    with torch.no_grad():
        p1_ms, _ = kernel_ms(lambda: probe.probe_smem(x, 227), ("probe_smem_kernel",), reps)
        p1_48_ms, _ = kernel_ms(lambda: probe.probe_smem(x, 48), ("probe_smem_kernel",), reps)
        p1_plain = sum(ms for ms, _ in device_kernels(
            lambda: probe.probe_smem_reference(x), reps).values())
        p1_lib = sum(ms for ms, _ in device_kernels(lambda: torch.mul(x, 2), reps).values())
        kern = device_kernels(lambda: probe.probe_ops(*ops_in), reps)
        require(len(kern) == 1 and "probe_ops_kernel" in next(iter(kern)),
                f"probe_ops: one device kernel per call ({sorted(kern)})")
        p2_ms = launch_ms(kern)
        plan = probe.ops_plan()
        grid = (plan.cluster, plan.threads, plan.cluster)
        probe.probe_empty(*grid, smem_bytes=plan.smem_bytes)
        kern = device_kernels(lambda: probe.probe_empty(*grid, smem_bytes=plan.smem_bytes), reps)
        require(len(kern) == 1, "the empty kernel on the ops probe's cluster was profiled")
        p2_floor = launch_ms(kern)
        p2_plain = sum(ms for ms, _ in device_kernels(
            lambda: probe.probe_ops_reference(*ops_in), reps).values())
        # on seeded normal operands: the all-ones ones sum exactly in any order
        seeded = probe.ops_inputs(dev, seed=0)
        p2_err = max_err(probe.probe_ops(*seeded), probe.probe_ops_reference(*seeded))
        p1_err = max_err(probe.probe_smem(x, 227)[0], probe.probe_smem_reference(x))
    f, s_, h = probe.OPS_F, probe.OPS_S, probe.OPS_H
    # P1: x read, out written; one multiply per element. P2: spec, d, p read,
    # out written; the NT product, the permutation product, the accumulations
    bp1 = bound(2 * x.numel() * 4, x.numel(), PEAK_FLOPS["f32"])
    bp2 = bound((f * s_ + h * s_ + h * h + (f + 8) * h) * 4,
                2 * f * h * s_ + 2 * h * h + 4 * f * h, PEAK_FLOPS["f32"])
    p1 = {"name": "probe_smem", "route": "cuda", "source": "tacotron_tpu_torch/csrc/probe.cu",
          "replaces": "scripts/probe_pallas.py:16", "launches": launches.get("probe_smem", 0),
          "path": "[probe]",
          "max_abs_err": p1_err, "ms": p1_ms, "plain_ms": p1_plain, "bound_ms": bp1[0],
          "bound_by": bp1[1], "library_ms": p1_lib, "shape": "x (8, 512) f32, 227 KiB",
          "ms_48kib": p1_48_ms}
    log(f"  probe_smem at 48 KiB: {p1_48_ms * 1e3:.2f} us, at 227 KiB: {p1_ms * 1e3:.2f} us of "
        f"device time per launch; torch.mul {p1_lib * 1e3:.2f} us")
    p2 = {"name": "probe_ops", "route": "cuda", "source": "tacotron_tpu_torch/csrc/probe.cu",
          "replaces": "scripts/probe_pallas.py:35", "launches": launches.get("probe_ops", 0),
          "path": "[probe]",
          "max_abs_err": p2_err, "ms": p2_ms, "plain_ms": p2_plain, "bound_ms": bp2[0],
          "bound_by": bp2[1], "library_ms": None,
          "shape": "spec (64, 256), d (275, 256), p (275, 275) f32",
          "cluster": probe.OPS_CLUSTER, "floor_ms": p2_floor}
    for k in (p1, p2):
        log(f"  {k['name']}: {k['ms'] * 1e3:.2f} us of device time per launch (plain "
            f"{k['plain_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.3f} us by "
            f"{k['bound_by']}, library "
            + ("none)" if k["library_ms"] is None else f"torch.mul {k['library_ms'] * 1e3:.2f} us)"))
    log(f"  probe_ops on a cluster of {probe.OPS_CLUSTER}: floor (an empty kernel on {grid} "
        f"with {plan.smem_bytes} bytes of shared memory) {p2_floor * 1e3:.2f} us; "
        f"{bp2[0] / p2_ms:.2%} of the bound")
    return [k4, k5, k5f, p1, p2]


def phase_lowp_convergence(report, acfg, mag_main):
    """What the bf16 mode costs in convergence: the magnitude error of the
    bf16 kernel's waveform beside the f32 kernel's, on a speech-like
    magnitude at the serving recipes' depths and on [main]'s own magnitudes."""
    from tacotron_tpu_torch.dsp.fused_gl import griffin_lim_spectrum

    dev = torch.device("cuda")
    log("[bf16 vs f32] magnitude error of the Griffin-Lim kernel's result, by mode")
    speech = sample_magnitude(4, 400, acfg, dev, seed=3)
    cases = [("speech-like B 4 F 400", speech, 100, 0.99), ("speech-like B 4 F 400", speech, 100, 0.0),
             ("speech-like B 4 F 400", speech, 1000, 0.0),
             ("[main]'s magnitudes B 8 F 1000", mag_main, 1000, 0.0)]
    rows = []
    for name, mag, n_iter, mom in cases:
        errs = {}
        for lowp in (False, True):
            with torch.no_grad():
                spec = griffin_lim_spectrum(mag, n_iter=n_iter, momentum=mom, lowp=lowp,
                                            **gl_kw(acfg))
            errs["bf16" if lowp else "f32"] = gl_errors(spec, spec, mag, acfg)[1]
        log(f"  {name}, {n_iter} iterations, momentum {mom}: f32 {errs['f32']:.5f}, bf16 "
            f"{errs['bf16']:.5f} ({100 * (errs['bf16'] / errs['f32'] - 1):+.2f}%)")
        require(all(np.isfinite(list(errs.values()))), "both finite")
        rows.append({"input": name, "n_iter": n_iter, "momentum": mom, **errs})
    report["bf16_vs_f32_magnitude_error"] = rows


def train_config(compute_dtype):
    """bench.py's training recipe at full_1chip widths: hoisted teacher-forced
    decoder, remat, the fused energy, in ``compute_dtype``."""
    from tacotron_tpu_torch.config import get_config
    base = get_config("full_1chip")
    return base.replace(model=dataclasses.replace(
        base.model, tf_decoder="hoisted", attention_energy="fused", remat_decoder=True,
        compute_dtype=compute_dtype))


def train_batch(cfg, dev):
    """The training path's batch, as bench.py makes it."""
    b, t_in, t_out = TRAIN_B, TRAIN_T_IN, TRAIN_T_OUT
    g = torch.Generator().manual_seed(0)
    batch = [torch.randint(1, 60, (b, t_in), generator=g),
             torch.full((b,), t_in), torch.rand(b, t_out, cfg.model.n_mels, generator=g),
             torch.rand(b, t_out, cfg.model.n_freq, generator=g), torch.full((b,), t_out)]
    return [x.to(dev) for x in batch]


def phase_train_save_attn(report):
    """[train-save-attn] remat_policy="save_attn" at the training path's
    widths and batch, on the plain energy ("xla": the only energy whose tanh
    is a tensor to keep), hoisted, remat, f32: one warm and one timed step
    under "all" and under "save_attn" (same weights, batch and dropout
    seed); the timed step's peak memory under each, the difference held
    within 25% of the tensor save_attn keeps, S B T_in A 4 bytes; then one
    step under the profiler for each one's device time and launches."""
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.train import create_train_state, train_step

    dev = torch.device("cuda")
    base = get_config("full_1chip")
    b, t_in, t_out = TRAIN_B, TRAIN_T_IN, TRAIN_T_OUT
    n_dec, a = t_out // base.model.r, base.model.attention_dim
    log(f"[train-save-attn] train_step, full_1chip widths, hoisted + xla + remat, f32, B {b}, "
        f"T_in {t_in}, T_out {t_out}: remat_policy all, then save_attn; 1 warm + 1 timed step each")
    rep = {}
    for policy in ("all", "save_attn"):
        cfg = base.replace(model=dataclasses.replace(
            base.model, tf_decoder="hoisted", attention_energy="xla", remat_decoder=True,
            remat_policy=policy))
        state = create_train_state(cfg, seed=0)
        batch = train_batch(cfg, dev)
        state, m, _ = train_step(state, *batch, cfg=cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m, _ = train_step(state, *batch, cfg=cfg)
        loss = float(m["total_loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
        rep[policy] = {"step_ms": step_ms, "loss": loss,
                       "max_memory_allocated": torch.cuda.max_memory_allocated()}
        kern = device_kernels(lambda: train_step(state, *batch, cfg=cfg))
        rep[policy].update(profiled_device_ms=sum(ms for ms, _ in kern.values()),
                           profiled_launches=sum(n for _, n in kern.values()))
        log(f"  {policy}: step {step_ms:.3f} ms, loss {loss:.6f}, max_memory_allocated "
            f"{rep[policy]['max_memory_allocated'] / 2**30:.3f} GiB; one more step under the "
            f"profiler: {rep[policy]['profiled_device_ms']:.3f} ms of device time in "
            f"{rep[policy]['profiled_launches']:.0f} launches")
        del state, batch, m
    kept = n_dec * b * t_in * a * 4
    diff = rep["save_attn"]["max_memory_allocated"] - rep["all"]["max_memory_allocated"]
    rep.update(kept_tensor_bytes=kept, peak_difference_bytes=diff)
    report["train_save_attn"] = rep
    log(f"  peak difference {diff / 2**20:.1f} MiB; the kept tanh, {n_dec} x {b} x {t_in} x {a} "
        f"x 4 bytes, {kept / 2**20:.1f} MiB")
    require(abs(diff - kept) <= 0.25 * kept,
            "save_attn's peak exceeds all's by the kept tanh within 25%")
    require(abs(rep["save_attn"]["loss"] - rep["all"]["loss"]) <= 1e-5 * abs(rep["all"]["loss"]),
            "the timed step's loss under save_attn within rel 1e-5 of all's")


def phase_train(report, compute_dtype="float32"):
    """The training path in ``compute_dtype``: [train] (f32) or [train-bf16]."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.train import create_train_state, train_step
    from tacotron_tpu_torch.train.step import STAGES

    dev = torch.device("cuda")
    bf16 = compute_dtype == "bfloat16"
    tag, key = ("[train-bf16]", "train_bf16") if bf16 else ("[train]", "train")
    cfg = train_config(compute_dtype)
    steps = TRAIN_STEPS[compute_dtype]
    b, t_in, t_out = TRAIN_B, TRAIN_T_IN, TRAIN_T_OUT
    n_dec = t_out // cfg.model.r
    log(f"{tag} train_step, full_1chip widths, hoisted + fused + remat, {compute_dtype}, "
        f"B {b}, T_in {t_in}, T_out {t_out}: 1 warm step, {steps} timed")
    state = create_train_state(cfg, seed=0)
    batch = train_batch(cfg, dev)
    t0 = time.perf_counter()
    state, m, _ = train_step(state, *batch, cfg=cfg)
    first = float(m["total_loss"])
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    runtime.LAUNCHES.clear()
    step_ms, stages, losses = [], [], []
    for _ in range(steps):
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
    per_step = {k: v / steps for k, v in launches.items()}
    log(f"  warm step {warm_s:.3f} s; losses {first:.5f} (warm) -> {losses}")
    log(f"  step ms median {med:.3f}, range {min(step_ms):.3f}-{max(step_ms):.3f} "
        f"over {steps} steps")
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
    rep = {"step_ms": step_ms, "step_ms_median": med, "train_frames_per_s": fps,
           "split_ms_median": split, "max_memory_allocated": peak,
           "losses": [first] + losses, "warm_s": warm_s,
           "launches": launches, "launches_per_step": per_step}
    report[key] = rep
    rep["profile"] = prof = profile_step(state, batch, cfg, med)
    kinds = prof["energy_kernels"]
    mode = "__nv_bfloat16" if bf16 else "float"
    log(f"  attention energy kernels in the profiled step: {kinds}")
    want = {f"energy_fwd<{mode}, true>": 2 * n_dec, f"energy_bwd<{mode}, true>": n_dec}
    require(kinds == want, f"the profiled step ran K1 {2 * n_dec} times and K2 {n_dec} times "
            f"(one kernel per call), both <{mode}> on 16-byte vectors, and no other energy "
            f"kernel: {want}")
    if bf16:
        params = [p_ for p_ in state.model.parameters()]
        moments = [v_ for st in state.opt.state.values() for k_, v_ in st.items()
                   if k_ in ("exp_avg", "exp_avg_sq")]
        require(all(p_.dtype == torch.float32 and p_.grad.dtype == torch.float32 for p_ in params)
                and len(moments) == 2 * len(params)
                and all(v_.dtype == torch.float32 for v_ in moments),
                "parameters, their gradients and the Adam moments are f32")
        rep["same_weights"] = bf16_forward_checks(state, batch, cfg)
    rep["fused_vs_xla_step_ms"] = compare_energy_forms(state, batch, cfg,
                                                       TRAIN_ROUNDS[compute_dtype])
    return state, batch, launches


def bf16_forward_checks(state, batch, cfg):
    """On the state's weights, one batch and one set of dropout masks: the
    teacher-forced loss through the plain energy beside the fused one (K1/K2
    bf16 in place of the formula), and the bf16 mel against the f32 model's
    under JAX's drift rule (tests/unit/test_mixed_precision.py: mean |d mel|
    < 0.1 mean |mel_f32| + 0.05)."""
    from tacotron_tpu_torch.models.tacotron import Tacotron
    from tacotron_tpu_torch.train.loss import tacotron_loss

    dev = torch.device("cuda")
    text, lengths, mel, linear, frame_len = batch
    weights = state.model.state_dict()
    out = {}
    for name, over in (("bf16_fused", {}), ("bf16_xla", {"attention_energy": "xla"}),
                       ("f32_fused", {"compute_dtype": "float32"})):
        model = Tacotron(dataclasses.replace(cfg.model, **over), device=dev)
        model.load_state_dict(weights)
        gen = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            o = model.train()(text, lengths, gt_mel=mel, generator=gen)
            loss, _ = tacotron_loss(o.mel, o.linear, mel, linear, frame_len,
                                    mask_padding=cfg.train.mask_padding,
                                    linear_weight=cfg.train.loss_linear_weight)
        out[name] = (float(loss), o.mel)
        del model
    gap = abs(out["bf16_fused"][0] - out["bf16_xla"][0])
    m16, m32 = out["bf16_fused"][1], out["f32_fused"][1]
    drift = float((m16 - m32).abs().mean())
    scale = float(m32.abs().mean()) + 1e-3
    log(f"  same weights and masks: loss bf16 fused {out['bf16_fused'][0]:.6f}, bf16 xla "
        f"{out['bf16_xla'][0]:.6f} (gap {gap:.3e}), f32 {out['f32_fused'][0]:.6f}; mel drift "
        f"bf16 vs f32 {drift:.5f} against {0.1 * scale + 0.05:.5f} (0.1 x {scale:.5f} + 0.05)")
    require(all(np.isfinite(v[0]) for v in out.values()), "losses finite")
    require(gap <= 1e-3 * abs(out["bf16_xla"][0]),
            "bf16 loss through K1/K2 within 1e-3 of the plain energy's")
    require(drift < 0.1 * scale + 0.05, "bf16 mel within JAX's drift rule of the f32 mel")
    return {"loss": {k: v[0] for k, v in out.items()}, "loss_gap_fused_xla": gap,
            "mel_drift_mean_abs": drift, "mel_f32_mean_abs": scale - 1e-3,
            "drift_limit": 0.1 * scale + 0.05}


def compare_energy_forms(state, batch, cfg, pairs: int):
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
    energy, energy_ms = {}, {}
    for k, (ms, n) in rows:
        for kern in ("energy_fwd", "energy_bwd"):
            if kern in k:
                name = k[k.index(kern):k.index(">", k.index(kern)) + 1]
                energy[name] = energy.get(name, 0) + n
                energy_ms[name] = energy_ms.get(name, 0.0) + ms
    log(f"  profile: device busy {busy:.3f} ms in {launches:.0f} kernel launches = "
        f"{100 * busy / step_ms:.1f}% of the median step ({step_ms:.3f} ms)")
    for k, (ms, n) in rows[:15]:
        log(f"    {ms:9.3f} ms  {n:6.0f}x  {k[:100]}")
    return {"device_busy_ms": busy, "kernel_launches": launches,
            "busy_share_of_median_step": busy / step_ms, "energy_kernels": energy,
            "energy_kernels_ms": energy_ms,
            "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in rows[:30]]}


def phase_train_timing(report, state, batch, launches):
    """K1/K2 at the training path's shapes, in the mode of the state's
    model: keys and q are that model's (bf16 under bf16 compute)."""
    from tacotron_tpu_torch.ops.attn_energy import (WARPS, attention_energy_reference,
                                                    energy_bwd, energy_bwd_reference, energy_fwd,
                                                    fwd_grid, plan_of)
    from tacotron_tpu_torch.probe import probe_empty

    dev = torch.device("cuda")
    m = state.model
    bf16 = m.cfg.cdtype == torch.bfloat16
    sfx, path = ("_bf16", "[train-bf16]") if bf16 else ("", "[train]")
    log(f"[timing] K1/K2{' bf16' if bf16 else ''} at the training path's shapes")
    with torch.no_grad():
        text, lengths = batch[0], batch[1]
        keys = m.memory_proj(m.encoder(text, lengths))
        h = torch.tanh(torch.randn(keys.shape[0], m.cfg.attention_gru_dim,
                                   generator=torch.Generator().manual_seed(1))).to(dev)
        q = m.decoder.cell.attention.query(h)
        v = m.decoder.cell.attention.v.detach()
    de = torch.randn(keys.shape[:2], generator=torch.Generator().manual_seed(2)).to(dev)
    require(keys.dtype == q.dtype == (torch.bfloat16 if bf16 else torch.float32),
            f"the path's keys and q are {keys.dtype}")
    if bf16:
        errs = energy_bf16_check(keys, q, v, de, label="at main shapes: ")
        report["checks"]["attn_energy_bf16_main_shapes"] = errs
    else:
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
    bwd_plain = ((lambda: energy_bwd_reference(keys, q, v, de)) if bf16 else
                 (lambda: torch.autograd.grad(e_ref, leaves, de, retain_graph=True)))
    calls = {"fwd": lambda: energy_fwd(keys, q, v),
             "fwd_plain": lambda: attention_energy_reference(keys, q, v),
             "bwd": lambda: energy_bwd(keys, q, v, de),
             "bwd_plain": bwd_plain}
    dev_ms, call_ms = {}, {}
    for name, fn in calls.items():
        with torch.no_grad() if name != "bwd_plain" else torch.enable_grad():
            fn()
            call_ms[name] = cuda_ms(fn, reps)
            kern = device_kernels(fn, reps)
        # the kernels: one launch each a call; the plain versions: all of a call's launches
        plain = name.endswith("_plain")
        if not plain:
            require(len(kern) == 1, f"{name}: one device kernel per call ({sorted(kern)})")
        dev_ms[name] = sum(ms for ms, _ in kern.values()) if plain else launch_ms(kern)
        log(f"  {name}: device {dev_ms[name] * 1e3:.2f} us per call in "
            f"{sum(n for _, n in kern.values()):.2f} kernels recorded per call; "
            f"{call_ms[name] * 1e3:.2f} us per call with the host")
    f_ms, fp_ms, b_ms, bp_ms = (dev_ms[k] for k in ("fwd", "fwd_plain", "bwd", "bwd_plain"))
    b, t, a = keys.shape
    # the floor: an empty kernel on each kernel's grid (K2's in its clusters)
    plan = plan_of(keys)
    grids = {"fwd": (*fwd_grid(b, t, keys.dtype), 1), "bwd": (b * plan.cluster, WARPS * 32, plan.cluster)}
    floor = {}
    for name, grid in grids.items():
        probe_empty(*grid)
        kern = [(ms, n) for k, (ms, n) in device_kernels(lambda: probe_empty(*grid), reps).items()
                if "probe_empty" in k]
        require(len(kern) == 1 and kern[0][1] > 0, f"the empty kernel on {grid} was profiled")
        floor[name] = kern[0][0] / kern[0][1]
    log(f"  floor (an empty kernel on the same grid): K1 {floor['fwd'] * 1e3:.2f} us on "
        f"{grids['fwd']}, K2 {floor['bwd'] * 1e3:.2f} us on {grids['bwd']} (blocks, threads, "
        f"cluster)")
    # each kernel's device time per launch inside the profiled training step
    prof = report["train_bf16" if bf16 else "train"]["profile"]
    mode = "__nv_bfloat16" if bf16 else "float"
    in_step = {d: prof["energy_kernels_ms"][f"energy_{d}<{mode}, true>"]
               / prof["energy_kernels"][f"energy_{d}<{mode}, true>"] for d in ("fwd", "bwd")}
    el, es = b * t * a, keys.element_size()
    # K1: keys, q (in their dtype), v read, e written; add, tanh, multiply,
    # accumulate per element (f32 arithmetic in both modes).
    # K2: keys, q, v, de read, dkeys, dq, dv written; add, tanh, 1 - t^2,
    # de * v, times (1 - t^2), dq accumulate, t * de, dv accumulate per element.
    fb = bound((el + b * a) * es + (a + b * t) * 4, 4 * el, PEAK_FLOPS["f32"])
    bb = bound((2 * el + 2 * b * a) * es + (2 * a + b * t) * 4, 9 * el, PEAK_FLOPS["f32"])
    steps = TRAIN_STEPS[m.cfg.compute_dtype]
    per_step = {k: launches.get(k, 0) / steps for k in ("attn_energy_fwd", "attn_energy_bwd")}
    shape = f"B {b} T_in {t} A {a} {'bf16' if bf16 else 'f32'}"
    k1 = {"name": "attn_energy_fwd" + sfx, "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/attn_energy.cu",
          "replaces": "tacotron_tpu/ops/pallas/attn_energy.py:63",
          "launches": launches.get("attn_energy_fwd", 0), "path": path,
          "max_abs_err": errs["e"][0],
          "ms": f_ms, "plain_ms": fp_ms, "bound_ms": fb[0], "bound_by": fb[1],
          "library_ms": None, "shape": shape, "call_ms": call_ms["fwd"],
          "plain_call_ms": call_ms["fwd_plain"],
          "ms_per_step": f_ms * per_step["attn_energy_fwd"],
          "ms_in_step": in_step["fwd"], "floor_ms": floor["fwd"]}
    k2 = {"name": "attn_energy_bwd" + sfx, "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/attn_energy.cu",
          "replaces": "tacotron_tpu/ops/pallas/attn_energy.py:69",
          "launches": launches.get("attn_energy_bwd", 0), "path": path,
          "max_abs_err": max(errs[n][0] for n in ("dkeys", "dq", "dv")),
          "ms": b_ms, "plain_ms": bp_ms, "bound_ms": bb[0], "bound_by": bb[1],
          "library_ms": None, "shape": shape, "call_ms": call_ms["bwd"],
          "plain_call_ms": call_ms["bwd_plain"],
          "plain_is": "energy_bwd_reference" if bf16 else "autograd through the formula",
          "ms_per_step": b_ms * per_step["attn_energy_bwd"],
          "ms_in_step": in_step["bwd"], "floor_ms": floor["bwd"], "cluster": plan.cluster}
    for k in (k1, k2):
        log(f"  {k['name']}: {k['ms'] * 1e3:.2f} us per launch, {k['ms_per_step']:.3f} ms per "
            f"step on the device; {k['ms_in_step'] * 1e3:.2f} us per launch in the profiled "
            f"step (plain {k['plain_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.2f} us by "
            f"{k['bound_by']}, floor {k['floor_ms'] * 1e3:.2f} us, library none)")
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
    report["ptxas"] = {}
    for name, p in paths.items():
        log_path = p.with_suffix(".log")
        rows = ptxas_report(log_path.read_text() if log_path.exists() else "")
        report["ptxas"][name] = rows
        for k in rows:
            log(f"  ptxas {name}: {k['kernel']}: {k.get('registers')} registers, "
                f"{k.get('spill_stores')} / {k.get('spill_loads')} bytes spill stores / loads, "
                f"{k.get('static_smem')} bytes static smem")
    k3 = [k for k in report["ptxas"]["decode_loop"] if k["kernel"].startswith("decode_loop_kernel")]
    require(len(k3) == 2 and all(k.get("spill_stores") == k.get("spill_loads") == 0 for k in k3),
            "both K3 instantiations (bf16, f32) built without spills")
    from tacotron_tpu_torch.dsp.fused_gl import tensor_core_smem_bytes
    report["gl_wgmma_dynamic_smem"] = tensor_core_smem_bytes()
    log(f"  gl_wgmma dynamic shared memory per block, bytes, by mode: "
        f"{report['gl_wgmma_dynamic_smem']}")

    cfg, vocab = phase_kernels(report)
    phase_energy(report)
    phase_train_e2e(report)
    kernels = None
    if not args.quick:
        synth, out, launches, mag_main, f32_spec, f32_time = phase_main(report, cfg, vocab)
        kernels = phase_timing(report, synth, launches, mag_main, f32_spec, f32_time)
        mel_main = out["mel"]
        del synth, out, f32_spec
        fast_cfg, fast_res, mag_fast = phase_fast(report, vocab)
        stream = phase_stream(report, mag_main, fast_cfg.audio)
        kernels += phase_timing_serving(report, fast_cfg, fast_res, mag_fast, mag_main, launches,
                                        stream)
        phase_lowp_convergence(report, fast_cfg.audio, mag_main)
        del mag_main, mag_fast
        state, batch, train_launches = phase_train(report)
        kernels = phase_train_timing(report, state, batch, train_launches) + kernels
        del state
        phase_train_save_attn(report)
        state, batch, train_launches = phase_train(report, "bfloat16")
        kernels = kernels[:2] + phase_train_timing(report, state, batch, train_launches) + kernels[2:]
        del state
        phase_main_bf16(report, cfg, vocab, mel_main)
        phase_cli(report, cfg, vocab)
        cli_launches = phase_train_cli(report)
        for k in kernels:
            require(k["launches"] > 0, f"{k['name']} launched on its path ({k['launches']})")
            if k["name"] in cli_launches:
                k["train_cli_launches"] = cli_launches[k["name"]]
                require(k["train_cli_launches"] > 0, f"{k['name']} launched on [train-cli]'s "
                        f"path ({k['train_cli_launches']})")
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
