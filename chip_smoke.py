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
   then (f) the early-exit decode at a threshold that never trips against
   the fixed decode on the same weights, prenet dropout 0, over calls
   eager / capture + replay / replay: mel and alignments equal bit for bit,
   and at a threshold derived by the same rule on that mel the frames up to
   the exit equal too (``check_exit_vs_fixed``);
6. [stream] ``griffin_lim(inner=1)``: 100 calls of the streaming kernel at
   B 8, F 1000 in bf16, against K4 and the plain step; [stream-f32] the same
   in f32, bit-equal to K4 f32, and the f32 kernels' steps against an f64
   step on [main]'s and a speech-like magnitude; and the probes' entry
   point;
7. K3's, K4's, K5's, the step decode's (its 63 launches at [fast]'s shapes,
   held within STEP_DECODE_TOL of ``WhileDecode.run_chunk_plain`` on the same
   masks), Tacotron 2's step decode's ([t2]: its launches counted on the
   serving path, ``Synthesizer`` at the published widths, B 8, T_in 160,
   1000 steps; held within T2_DECODE_TOL of ``run_chunk_plain`` on the same
   masks over the whole decode) and the probes' time at their paths' shapes beside
   the plain version, a library yardstick and the bound (P1 at 48 and 227
   KiB; P2 with its floor, an empty kernel on the same cluster, threads and
   shared memory); K3 at every cluster size (1, 2, 4, 8, 16) with the card's count of
   resident clusters of each, microseconds per step and one cluster
   barrier's cost, the chosen size held at least 2x faster than 1; for
   the Griffin-Lim kernels in both modes each launch's device
   time per iteration (synthesis, overlap-add + frame, analysis, K5's
   pack), the achieved TFLOP/s and
   share of the bound, the device launches per iteration (the kernel
   nodes of a CUDA graph captured around one call, ``gl_graph_nodes``: the
   profiler can drop an event, a graph holds every launch) against
   ``runtime.LAUNCHES``, and a second yardstick at the padded shapes; K4's
   f32 mode against the plain f32 loop as [main] runs it (converging as
   well; its waveform held at least as close to the loop with f64 sums as
   the plain f32 loop's, the distance between the two f32 loops printed,
   as MAIN_TOL says); K4's
   bf16 mode against its plain version as [main] runs it (1000 iterations,
   momentum 0) and on a speech-like magnitude of that shape (9 and 10
   iterations); the magnitude error that the bf16 mode of Griffin-Lim
   reaches beside the f32 mode's; then [synth-graph], [main]'s path
   through its CUDA graph (one per shape: a shape's first call eager, its
   second captures): (a) under
   deterministic algorithms, calls of seeds 1, 2, 1 (eager, capture +
   replay, replay) each bit-equal to an eager call of its seed; (b) a new
   Synthesizer under torch's default algorithms, the one timed: its
   graph's nodes, K3's one and K4's 3000 kernel nodes, capture and
   instantiate seconds and pool bytes, one replay held against the eager
   call of its seed (SYNTH_GRAPH's rule), K4 held against its plain
   version on the replay's own spectrogram (GL_PATH); (c) 5 replays and 3
   eager calls in turns, the launch counts set to 0 just before (one K3 and
   3000 K4 per replay): medians, spreads, audio-s/s; (d) one replay under
   the profiler (the device's busy share); K3 held against its plain
   version on the graph's own encoder outputs; then [fast-graph]:
   [synth-graph]'s (a)-(d) on [fast]'s path and its graphs
   (preamble, decode_while's chunk of 8 steps replayed until the device
   says done, post-net; Griffin-Lim eager at t_gl) with the preset's
   threshold (no exit: 63 chunks) and with the derived one (the exit after
   step 6: one chunk, t_gl 64; every call at seed 1, the seed the
   threshold was derived on), the decode alone (the chunk graph's
   replays, host clock) beside the eager calls' decode stage, and (e) the
   decode alone at chunk sizes 4, 8, 16, 32 and 64;
8. the training path: ``create_train_state`` + ``train_step`` at the
   full_1chip widths (hoisted teacher-forced decoder, fused energy, remat,
   f32) on B 32, T_in 128, T_out 400: one warm step, then 2 timed eager
   steps with the launch counts set to 0 just before them; step milliseconds,
   train frames per second, peak memory and a forward / backward /
   optimizer split; the device's busy share of one profiled step; the
   same steps through the plain energy, interleaved with the fused ones;
   then [train-graph]: ``make_train_step``'s graphed step (one CUDA graph
   per batch shape) at the same recipe: (a) 3 graphed steps after the
   shape's eager first one, against eager ``train_step``s from the same
   seeded state, bit for bit under deterministic convolutions and index
   reductions (losses, grad norms, alignments, weights, gradients, Adam's
   moments and counts, batch statistics, the generator), after printing
   which gradients two eager steps from one state differ in with torch's
   default algorithms; (b) the last of those Adam updates (capturable: f32
   bias corrections on the device) against optax's formula in f64,
   within ADAM_F64_OF_LR of the LR; (c) a new step under the default
   algorithms: its graph's nodes, K1 400 and K2 200 kernel nodes, capture
   and instantiate seconds and pool bytes, and one replay of that graph
   against an eager ``train_step`` from a copy of its state by [dp]'s
   common-state rule, the alignments within GRAPH_ALIGN_ATOL; (d) 5 replays and 3 eager steps
   in turns, each ending in its loss read back, the launch counts set to 0
   just before them (K1 400 and K2 200 per replay), one replay under the
   profiler (device busy share, K1/K2 device time per launch), ``mfu`` and
   ``mfu_device_busy``; (e) T_out 200, which gets a graph of its own, then
   T_out 400's graph again;
9. K1's and K2's time at that path's shapes beside the plain version, the
   bound, the floor (an empty kernel launched on the same grid and
   clusters, ``probe.probe_empty``) and each one's device time per launch
   inside the profiled step; then [train-save-attn]: the same widths and
   batch on the plain energy, one warm and one timed step under
   remat_policy "all" and under "save_attn", the timed steps' peak memory
   apart by the kept tanh (S B T_in A 4 bytes) within 25%;
10. [train-bf16] bench.py's training recipe (compute_dtype="bfloat16",
   hoisted, remat, fused energy) at the same widths and batch, as 8: one
   warm and 2 timed steps, the profiled step (400 bf16 K1 and 200 bf16 K2
   kernels, one per call), the plain energy interleaved, f32 parameters and Adam
   moments; on one set of weights and dropout masks the loss through the
   plain energy beside the fused one and the mel against the f32 model's
   (JAX's drift rule); [train-graph-bf16], [train-graph] in bf16; then bf16
   K1's and K2's time at that path's shapes; K1's and K2's rows count their
   launches over [train-graph]'s timed replays (``eager_launches``:
   [train]'s eager steps'), with their nodes in the graph and device time
   per launch inside the profiled replay;
11. [main-bf16] ``Synthesizer(fused=True)`` at synth_gl1000 with
   compute_dtype="bfloat16" (K3 on bf16-computed keys, Griffin-Lim 100
   iterations to keep the script short): a warm and a timed call, and the
   mel's drift from [main]'s f32 mel, printed, not held (500 feed-previous
   steps on random weights may diverge); then its graph and an f32 one at
   the same depth (GL 100), 3 replays of each in turns;
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
   the resume to step 30 in bf16 with hoisted + remat and the device cache,
   both through the graphed step (one eager step and then a graph per
   bucket shape; each step timed by CUDA events that a wrapper around the
   step the CLI builds records on either side of it, read after the run,
   so the CLI's loop runs unsynchronised: frames/s of eager, capturing and
   replayed steps, and each graph's nodes, capture seconds and pool bytes);
   each run's K1, K2 and K4 launches equal to what its steps' buckets (the
   loader's schedule replayed), decoder form, remat and eval give, the
   losses finite, the checkpoint restored bit for bit, the device cache's
   batches equal to the native assembler's (ms per batch of each), and
   K1/K2 (f32 and bf16) and K4 bf16 held against their plain versions on
   the runs' own inputs; the kernel rows gain ``train_cli_launches``;
14. [dp] the parallel layer (``torch.distributed``) on the one card, kernels
   built before any rank starts: (1) ``make_train_step(cfg, mesh)`` at
   [train]'s width and batch over a 1-rank NCCL group, graphed: each bucket
   shape's eager first step, capture and replays bit-equal to the
   one-process graphed step and to the eager mesh step under deterministic
   algorithms, K1/K2 on its inputs against their plain versions, then with
   the default algorithms one replay held against ``train_step`` by
   dp_hold and replays and eager mesh steps in turns (nodes by kind, the
   device's busy share); (1b) ``Synthesizer(mesh=...)`` over that group at
   synth_gl1000 B 8 through its model and Griffin-Lim graphs, within
   GRAPH_SYNTH_ATOL of the no-mesh graphed call, K4's 3 nodes per
   iteration, K4 held on the replay's spectrogram, replays in turns with
   the no-mesh replays and eager mesh calls; the gloo paths below are held
   eager by the rule (``parallel.collectives.capturable``): two
   gloo ranks of 16 rows against one process on the 32 rows (dropout on, 3
   steps; losses, gradients, parameters and batch statistics as DP_* sets
   out; each rank's K1/K2 launches and step ms); the tensor-parallel step
   on (data 1, model 2) at tiny widths against one process, linear_proj
   half on each rank; ``Synthesizer(mesh=...)`` at synth_gl1000 on 8
   prompts over the two ranks against one process (mel, linear 1e-5; each
   rank's K4 launches; the waveforms against K4 on the gathered
   spectrogram); then ``cli.train`` as two processes (--coordinator, the
   per-chip batch, --debug-sync, a checkpoint by process 0 only), their
   resume, and ``cli.synthesize --data-parallel``; the kernel rows of K1,
   K2 (f32) and K4 bf16 gain ``dp_launches``, one count per rank, and
   ``dp_nccl_graph_launches`` / ``dp_nccl_graph_nodes`` from (1) and (1b);
15. [tooling] the port's utils on the card: (a) ``utils/roofline.py``'s
   whole-step shares, which [train], [train-bf16] (``train_step_flops`` at
   their shapes with remat, over the median step and the profiled step's
   device-busy time, against the f32 or bf16 peak: ``mfu``,
   ``mfu_device_busy``) and [main] (the forward plus 1000 Griffin-Lim
   iterations over the call, against the bf16 peak) print on their own
   lines, gathered, and a Griffin-Lim iteration's count over the exact
   window (the K4/K5 bounds) beside ``gl_iteration_flops``' over the
   128-aligned span; every bound above comes from the same roofline
   (``bound``); (b) seeded synth_gl1000 weights named as a TF1 checkpoint
   names them (three decoder cells), ``tf1_converter.convert``-ed with
   nothing unplaced and loaded through ``from_flax`` bit for bit, then
   ``Synthesizer(fused=True)`` on the 8 prompts at GL 100 (1 K3 and 300 K4
   launches, mel and linear bit-equal to the weights loaded directly), K3
   and K4 bf16 held on these inputs as [cli] holds them; (c)
   ``enable_compilation_cache`` in two child processes (the first builds
   every library in a fresh directory, the second starts no compiler),
   ``force`` / ``time_fn`` of a [main]-shaped call beside this script's
   own timing, and ``cli.train --profile-port`` on [train-cli]'s corpus (8
   f32 steps, fused energy): a capture of 2 steps asked for over HTTP after
   step 2, a second request while its window is open refused, the trace's
   K1/K2 device events equal to the captured steps' decoder steps; the
   kernel rows of K1, K2 (f32), K3 and K4 bf16 gain ``tooling_launches``;
16. [evidence] the evidence runners at the flagship recipe's widths
   (full_1chip, r 5, char_sec 0.06 with jitter 0.3, text length 20, B 32):
   ``cli.alignment_run`` on 64 utterances, 40 steps with a save at step
   30, then a resume from its run directory for 20 more, each run one
   eager step, one capturing and replays of one graph (CUDA events around
   each step), the summary at step 60 on the card's name, its alignments
   re-scored; then ``cli.audio_evidence`` on 2 held-out prompts at GL 100
   from that run directory: its K4 launches equal to the kernel nodes of
   its Griffin-Lim call captured again, and K4 held against its plain
   version on that call's own magnitudes and arguments (the evidence STFT,
   n_fft 512, 257 bins) as GL_PATH sets out; steps/s and the phase's
   seconds; K4 bf16's row gains ``evidence_launches`` and
   ``evidence_max_abs_err``;
17. last line: {"ok": true, "device": {...}}.

``--report PATH`` also writes every check and measurement as JSON.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks are utils/roofline.py's H100 dicts (dense,
# at the 700 W limit): 3.35 TB/s; 989 TFLOP/s bf16, 495 TF32, 67 f32.
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
TRAIN_STEPS = {"float32": 2, "bfloat16": 2}
TRAIN_ROUNDS = {"float32": 1, "bfloat16": 3}
# [train-graph]: make_train_step's graphed step at [train]'s recipe. "compare":
# graphed steps held bit for bit against eager ones from one state, after the
# shape's first (eager) step; "turns": the timed calls, G a replay and E an
# eager train_step on a state of its own, each ending in its loss read back;
# "t_out_2": the second shape's T_out. Bit for bit under deterministic
# convolutions and index reductions: with torch's default algorithms two
# eager f32 steps from one state already differ (the phase prints where)
TRAIN_GRAPH = {"compare": 3, "turns": "GEGGEGGE", "t_out_2": 200}
# [train-graph] (c): the measured graph, captured with torch's default
# algorithms, against an eager train_step from a copy of its state (weights,
# batch statistics, Adam's moments and count, the dropout generator): one
# replay, held by [dp]'s common-state rule (dp_hold: losses rel DP_LOSS_RTOL,
# gradients 1e-4 of their peak, updated weights where Adam's step is well
# conditioned, statistics) and the alignments within this
GRAPH_ALIGN_ATOL = 1e-5
# [synth-graph] / [fast-graph]: the Synthesizer's graphs (one shape's eager
# first call, then its capture). "compare": the seeds of the calls held bit
# for bit against eager calls under deterministic algorithms (eager,
# capture + replay, replay of the first seed again); "turns": the timed
# calls, G a replay and E an eager call (stage_ms=True) of the same shape
# and seed, each ending with its outputs on the host. The graph that is
# timed is captured with torch's default algorithms and held against the
# eager call of its seed: bit for bit where it is, else the mel, linear and
# alignments within GRAPH_SYNTH_ATOL, the end frames, steps done and t_gl
# equal, and the waveform by GL_PATH's rules on the graph's own linear
# spectrogram (Griffin-Lim multiplies any difference 3-10x an iteration at
# the spectrogram's floor: the waveform at depth says nothing of the graph)
SYNTH_GRAPH = {"compare": (1, 2, 1), "turns": "GEGGEGGE"}
# [fast-graph] (e): decode_while's chunk sizes timed (the decode alone, graphed)
CHUNK_SWEEP = (4, 8, 16, 32, 64)
GRAPH_SYNTH_ATOL = 1e-5
# [timing]: the step decode's kernel against its plain counterpart on the same
# masks, 500 steps at [fast]'s shapes, f32 (summation order only)
STEP_DECODE_TOL = 1e-5
# [t2]: Tacotron 2's step decode kernel against its plain chunk on the same
# masks over 1000 steps at the serving cell's shapes, f32 (summation order
# only): frames, alignments and the state
T2_DECODE_TOL = 1e-5
# [train-graph] (b): one capturable Adam update (f32, bias corrections on the
# device) against optax's formula in f64 on the same moments and clipped
# gradients: every updated weight within this share of the update's LR
ADAM_F64_OF_LR = 1e-3

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


def bound(byts, flops, kind):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and operations over the peak rate of their type, ``kind`` "bf16",
    "tf32" or "f32" (``utils/roofline.speed_of_light`` on the H100 dicts,
    the max that ``KernelRoofline.report()`` takes)."""
    from tacotron_tpu_torch.utils.roofline import H100, speed_of_light
    s, by = speed_of_light(flops, byts, H100[kind])
    return s * 1e3, by


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
    return bound(byts, flops, "bf16" if lowp else "f32")


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
    from tacotron_tpu_torch.utils.roofline import H100_F32
    return (bound(byts, TF32_PRODUCTS_BOUND * flops, "tf32"),
            flops / H100_F32["flops_peak"] * 1e3)


def gl_bound_bf16(rows, nb, win, n_iter, planar_io=False):
    """bf16 mode: the same two products per iteration against the tensor
    cores' bf16 peak. Bytes: the f32 magnitude read and the bf16 (re, im)
    spectrum written; the streaming kernel also reads a bf16 spectrum."""
    byts = rows * nb * (4 + 2 * 2 + (2 * 2 if planar_io else 0))
    return bound(byts, n_iter * 2 * 2 * rows * win * 2 * nb, "bf16")


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
    report["main"]["roofline"] = synth_roofline(
        cfg, synth.encode_texts(PROMPTS)[0].shape[1], out["linear"].shape[1],
        cfg.audio.griffin_lim_iters, wall, report["card"])

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
    # the device's count from a captured call's kernel nodes; the profiler only times
    nodes = gl_graph_nodes(lambda: griffin_lim_spectrum(
        mag, n_iter=acfg.griffin_lim_iters, momentum=acfg.gl_momentum, lowp=False, **gl_kw(acfg)))
    gl_ms = out["stage_ms"]["griffin_lim"]
    aps_f32 = out["audio_seconds"] / (wall + (f32_ms - gl_ms) / 1e3)
    log(f"  Griffin-Lim stage: bf16 kernel (the default) {gl_ms:.3f} ms, f32 kernel "
        f"{f32_ms:.3f} ms of device time ({f32_launches} launches); with the f32 kernel the "
        f"call would give {aps_f32:.3f} audio_seconds_per_s (timed call less its stage plus "
        f"this)")
    require(f32_launches == nodes["k4"] == nodes["launches"].get("griffin_lim")
            == 3 * acfg.griffin_lim_iters and nodes["pack"] == 0,
            f"the f32 kernel launched: {nodes['k4']} kernel nodes of a captured call = LAUNCHES "
            f"{f32_launches} = 3 per iteration, no pack")
    report["main"].update(griffin_lim_f32_ms=f32_ms, audio_seconds_per_s_f32_gl=aps_f32)
    launches["griffin_lim_f32"] = f32_launches
    return synth, out, launches, mag, res["f32"], (f32_ms, stages)


def synth_graph_report(synth) -> dict:
    """Every captured graph of ``synth``'s one shape: its nodes, K3 and K4
    kernel nodes (K4: both products and the overlap-add), the launches a
    replay adds to ``runtime.LAUNCHES``, capture and instantiate seconds
    and its memory pool's bytes."""
    from tacotron_tpu_torch.utils.profiling import graph_nodes
    (entry,) = synth.graphs.values()
    out = {}
    for name, g in entry.captured():
        nodes = graph_nodes(g.graph)
        out[name] = {
            "nodes": sum(nodes.values()),
            "kernel_nodes": sum(n for k, n in nodes.items() if not k.startswith("<")),
            "other_nodes": {k: n for k, n in nodes.items() if k.startswith("<")},
            "k3_nodes": sum(n for k, n in nodes.items() if "decode_loop_kernel" in k),
            "k4_nodes": sum(n for k, n in nodes.items() if "gl_wgmma" in k or "gl_ola_frame" in k),
            "step_decode_nodes": sum(n for k, n in nodes.items() if "decode_chunk_kernel" in k),
            "kernels": {k: n for k, n in nodes.items() if not k.startswith("<")},
            "launches_per_replay": dict(g.launches), "capture_s": g.capture_s,
            "instantiate_s": g.instantiate_s, "pool_bytes": g.pool_bytes}
        log(f"    graph {name}: {out[name]['nodes']} nodes ({out[name]['kernel_nodes']} kernels, "
            f"{out[name]['other_nodes']}), K3 {out[name]['k3_nodes']}, K4 "
            f"{out[name]['k4_nodes']}, the step decode {out[name]['step_decode_nodes']}; capture "
            f"{g.capture_s:.3f} s, instantiate {g.instantiate_s:.3f} s, pool "
            f"{g.pool_bytes / 2**20:.1f} MiB")
        if name == "chunk":
            log(f"    graph chunk's kernel nodes: {out[name]['kernels']}")
    return out


def synth_outputs_equal(got, want) -> dict:
    """{output: bit-equal} of two Synthesizer calls."""
    return {k: bool(np.array_equal(got[k], want[k]))
            for k in ("mel", "linear", "alignments", "wavs", "end_frames")}


def synth_graph_phase(report, key, tag, cfg, p, bs, vocab, fused, seeds=SYNTH_GRAPH["compare"]):
    """One Synthesizer path through its graphs, at ``cfg`` on PROMPTS. (a)
    under deterministic(): calls of ``seeds`` (eager, capture + replay,
    replay) each bit-equal to an eager call of its seed;
    (b) a new Synthesizer with torch's default algorithms, the one timed:
    its first call (eager) and second (capture + replay) timed, its graphs'
    nodes, K3/K4 nodes, seconds and pool bytes, one replay held against
    the eager call of its seed (SYNTH_GRAPH's rule), and K4 held against its
    plain version on the replay's own spectrogram (GL_PATH); (c) replays
    and eager calls in turns (SYNTH_GRAPH["turns"]), the launch counts set
    to 0 just before and read after each replay: medians and spreads,
    audio-s/s and trimmed audio-s/s; (d) one replay under the profiler: the
    device's busy share; on the split path the decode alone (the chunk
    graph's replays until the device says done, host clock). -> (the phase's
    results, K3/K4 launches over the timed replays, the timed Synthesizer)."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.infer.synthesize import Synthesizer

    dev = torch.device("cuda")
    acfg, r = cfg.audio, cfg.model.r
    gl_iters = acfg.griffin_lim_iters
    kw = {}
    rep = report[key] = {"card": report["card"]}
    t_phase = time.perf_counter()
    with deterministic():
        graphed, eager = (Synthesizer(cfg, p, bs, vocab, fused=fused) for _ in range(2))
        calls = []
        for seed in seeds:
            got = graphed(PROMPTS, seed=seed, **kw)
            want = eager(PROMPTS, seed=seed, stage_ms=True, **kw)
            calls.append({"seed": seed, "graphed": got["graphed"],
                          "equal": synth_outputs_equal(got, want)})
        del graphed, eager, got, want
    rep["compare_deterministic"] = calls
    log(f"  (a) deterministic algorithms, seeds {seeds}: {calls}")
    require([c["graphed"] for c in calls] == [False, True, True]
            and all(all(c["equal"].values()) for c in calls),
            f"(a) {tag}: eager, capture + replay, replay, each bit-equal to an eager call of its "
            f"seed")

    synth = Synthesizer(cfg, p, bs, vocab, fused=fused)
    first = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = synth(PROMPTS, seed=1, **kw)
        first.append((time.perf_counter() - t0) * 1e3)
    rep["first_calls_ms"] = first
    log(f"  (b) default algorithms: the eager first call {first[0]:.1f} ms, the second "
        f"(capture, instantiate, replay) {first[1]:.1f} ms")
    rep["graphs"] = synth_graph_report(synth)
    want = synth(PROMPTS, seed=1, stage_ms=True, **kw)
    eq = synth_outputs_equal(out, want)
    err = {k: float(np.abs(out[k] - want[k]).max()) for k in ("mel", "linear", "alignments")}
    t_gl = [x["wavs"].shape[1] // acfg.hop_length + 1 for x in (out, want)]
    steps = [steps_done_of(x["mel"], r) for x in (out, want)]
    rep["replay_vs_eager"] = {"equal": eq, "max_abs_err": err, "t_gl": t_gl,
                              "steps_done": steps, "atol": GRAPH_SYNTH_ATOL}
    log(f"  the replay against the eager call of its seed: bit-equal {eq}; max abs err {err}; "
        f"t_gl {t_gl}, steps done {steps}")
    require(all(e <= GRAPH_SYNTH_ATOL for e in err.values()) and eq["end_frames"]
            and t_gl[0] == t_gl[1] and steps[0] == steps[1],
            f"(b) {tag}: the timed graph's mel, linear and alignments within "
            f"{GRAPH_SYNTH_ATOL} of eager, end frames, t_gl and steps done equal")
    mag = spectrogram_magnitude(torch.from_numpy(out["linear"][:, :t_gl[0]]).to(dev), acfg)
    rep["griffin_lim_on_the_replay"] = check_k4_at(
        f"{tag} griffin_lim bf16 on the replay's spectrogram (B {mag.shape[0]}, F "
        f"{mag.shape[1]})", mag, acfg, gl_iters)

    ms = {"G": [], "E": []}
    runtime.LAUNCHES.clear()
    launches = collections.Counter()
    for kind in SYNTH_GRAPH["turns"]:
        counts = collections.Counter(runtime.LAUNCHES)
        t0 = time.perf_counter()
        res = synth(PROMPTS, seed=1, stage_ms=kind == "E", **kw)
        ms[kind].append((time.perf_counter() - t0) * 1e3)
        require(res["graphed"] == (kind == "G"), f"(c) {kind} call graphed {res['graphed']}")
        if kind == "G":
            launches.update(runtime.LAUNCHES)
            launches.subtract(counts)
        else:
            rep.setdefault("eager_stage_ms", []).append(res["stage_ms"])
    launches = dict(+launches)
    n_g = len(ms["G"])
    med, med_e = float(np.median(ms["G"])), float(np.median(ms["E"]))
    secs, trimmed = res["audio_seconds"], res["trimmed_audio_seconds"]
    rep.update(replay_ms=ms["G"], eager_ms=ms["E"], replay_ms_median=med, eager_ms_median=med_e,
               replay_ms_spread=(min(ms["G"]), max(ms["G"])),
               eager_ms_spread=(min(ms["E"]), max(ms["E"])),
               audio_seconds=secs, trimmed_audio_seconds=trimmed,
               audio_seconds_per_s=secs / (med / 1e3),
               trimmed_audio_seconds_per_s=trimmed / (med / 1e3),
               eager_audio_seconds_per_s=secs / (med_e / 1e3),
               steps_done=steps_done_of(res["mel"], r), launches=launches,
               launches_per_replay={k: v / n_g for k, v in launches.items()})
    log(f"  (c) in turns {SYNTH_GRAPH['turns']}: replay ms {[round(x, 2) for x in ms['G']]} "
        f"(median {med:.2f}), eager ms {[round(x, 2) for x in ms['E']]} (median {med_e:.2f}); "
        f"audio-s/s {rep['audio_seconds_per_s']:.2f} graphed, "
        f"{rep['eager_audio_seconds_per_s']:.2f} eager; trimmed audio-s/s "
        f"{rep['trimmed_audio_seconds_per_s']:.2f} graphed; steps done {rep['steps_done']}; "
        f"launches per replay {rep['launches_per_replay']}; {report['card']}")
    # the split path's step decode: one launch a chunk of the steps run
    (entry,) = synth.graphs.values()
    chunks = -(-rep["steps_done"] // entry.model["preamble"].outputs.chunk) if synth.split else 0
    want_launches = {"griffin_lim": 3 * gl_iters,
                     **({"decode_loop": 1} if fused else {"decode_chunk": chunks})}
    require(rep["launches_per_replay"] == want_launches,
            f"(c) {tag}: each of {n_g} replays counted {want_launches}")
    rows = sorted(device_kernels(lambda: synth(PROMPTS, seed=1, **kw)).items(),
                  key=lambda x: -x[1][0])
    busy = sum(v[0] for _, v in rows)
    rep["profile"] = {"device_busy_ms": busy, "busy_share_of_median_replay": busy / med,
                      "kernel_launches": sum(v[1] for _, v in rows),
                      "top": [{"name": k, "ms": v[0], "count": v[1]} for k, v in rows[:15]]}
    log(f"  (d) one replay under the profiler: device busy {busy:.2f} ms = "
        f"{100 * busy / med:.1f}% of the median replay")
    for k, (m_, n_) in rows[:6]:
        log(f"    {m_:9.3f} ms  {n_:6.0f}x  {k[:90]}")
    if synth.split:
        rep["decode_ms"], rep["decode_chunks"] = graphed_decode_ms(synth, cfg.model.max_decode_steps)
        log(f"  (d) the decode alone, graphed: {[round(x, 2) for x in rep['decode_ms']]} ms, "
            f"{rep['decode_chunks']} chunks (the eager calls' decode stage: "
            f"{[round(x['decode'], 2) for x in rep['eager_stage_ms']]} ms)")
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"  {tag} {rep['seconds']:.1f} s")
    nodes = {"decode_loop": sum(x["k3_nodes"] for x in rep["graphs"].values()),
             "griffin_lim": sum(x["k4_nodes"] for x in rep["graphs"].values()),
             "decode_chunk": sum(x["step_decode_nodes"] for x in rep["graphs"].values())}
    return rep, launches, nodes, synth


def graphed_decode_ms(synth, n_steps, reps=3):
    """The early-exit decode alone through a split-path Synthesizer's graphs
    (its one shape captured, seed 1): the preamble replayed, then the host
    clock around the chunk graph's replays until the device says done. ->
    (ms of each rep, chunks run)."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.infer.early_exit import run_until_done

    (entry,) = synth.graphs.values()
    g, ms = entry.model, []

    def chunk():
        runtime.replay_graph(g["chunk"])
        return g["chunk"].outputs

    with torch.cuda.stream(synth._stream), torch.no_grad():
        for _ in range(reps):
            synth._gen.manual_seed(1)
            runtime.replay_graph(g["preamble"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunks = run_until_done(chunk, n_steps, g["preamble"].outputs.chunk)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms, chunks


def chunk_sweep(cfg, p, bs, vocab, steps):
    """(e) ``decode_while``'s chunk size: for each of CHUNK_SWEEP a
    Synthesizer made with that ``DECODE_CHUNK``, its eager call and its
    capture, then the decode alone (``graphed_decode_ms``) and one whole
    replayed call, its steps done held to ``steps``. -> {chunk: results}."""
    from tacotron_tpu_torch.infer import early_exit
    from tacotron_tpu_torch.infer.synthesize import Synthesizer

    out, default = {}, early_exit.DECODE_CHUNK
    try:
        for k in CHUNK_SWEEP:
            early_exit.DECODE_CHUNK = k
            synth = Synthesizer(cfg, p, bs, vocab)
            for _ in range(2):
                synth(PROMPTS, seed=1)
            ms, chunks = graphed_decode_ms(synth, cfg.model.max_decode_steps)
            t0 = time.perf_counter()
            res = synth(PROMPTS, seed=1)
            call = (time.perf_counter() - t0) * 1e3
            require(res["graphed"] and steps_done_of(res["mel"], cfg.model.r) == steps,
                    f"(e) chunk {k}: a replayed call, {steps} steps done")
            out[k] = {"decode_ms": ms, "decode_ms_median": float(np.median(ms)), "chunks": chunks,
                      "call_ms": call, "steps_done": steps_done_of(res["mel"], cfg.model.r)}
            log(f"  (e) chunk {k:2d}: the decode alone {[round(x, 2) for x in ms]} ms over "
                f"{chunks} chunks, the replayed call {call:.2f} ms")
            del synth
    finally:
        early_exit.DECODE_CHUNK = default
    return out


def phase_synth_graph(report, cfg, vocab):
    """[synth-graph]: [main]'s path, ``Synthesizer(fused=True)`` at
    synth_gl1000 B 8 (GL 1000, bf16 kernel), through its one graph
    (``synth_graph_phase``), then K3 held against its plain version on the
    graph's own encoder outputs (the deterministic eager encoder at the
    call's seed, which (a) holds bit-equal to the graph's). -> K3/K4
    launches over the timed replays and their graph nodes."""
    from tacotron_tpu_torch.models.tacotron import length_mask
    from tacotron_tpu_torch.ops.decode_loop import pack_decoder_weights
    from tacotron_tpu_torch.weights import split_state

    log("[synth-graph] Synthesizer(fused=True), synth_gl1000, B 8, 500 steps, GL 1000: one CUDA "
        "graph per shape after its eager first call")
    p, bs = split_state(full_model(cfg, torch.device("cuda")))
    rep, launches, nodes, synth = synth_graph_phase(report, "synth_graph", "[synth-graph]", cfg,
                                                    p, bs, vocab, fused=True)
    require(nodes == {"decode_loop": 1, "griffin_lim": 3 * cfg.audio.griffin_lim_iters,
                      "decode_chunk": 0},
            f"[synth-graph]: the graph holds K3's one node and K4's 3 per iteration ({nodes})")
    rep["roofline"] = synth_roofline(cfg, synth.encode_texts(PROMPTS)[0].shape[1],
                                     cfg.model.max_decode_steps * cfg.model.r,
                                     cfg.audio.griffin_lim_iters, rep["replay_ms_median"] / 1e3,
                                     report["card"])
    text, lengths = synth.encode_texts(PROMPTS)
    with deterministic(), torch.no_grad():
        synth._gen.manual_seed(1)
        memory = synth.model.encoder(text, lengths, synth._gen)
        keys = synth.model.memory_proj(memory)
    rep["decode_on_the_graph_inputs"] = check_k3_at(
        "[synth-graph]'s", memory, keys, length_mask(text.shape[1], lengths),
        pack_decoder_weights(synth.model.decoder.cell), cfg.model.max_decode_steps)
    del synth
    return {"launches": launches, "graph_nodes": nodes}


def phase_fast_graph(report, vocab, cfg):
    """[fast-graph]: [fast]'s path, ``Synthesizer`` at synth_fast B 8
    (early exit, trim, GL 100 at momentum 0.99), through its graphs
    (``synth_graph_phase``): with the preset's threshold (no exit on random
    weights: 63 chunks of 8 steps, Griffin-Lim on every frame) and with
    [fast]'s derived threshold (the exit after step 6: one chunk, t_gl 64);
    for each, (e) the decode alone at each chunk size of CHUNK_SWEEP
    (``chunk_sweep``). Griffin-Lim runs eagerly after the graphs. -> K4
    launches over the timed replays and its graph nodes (none)."""
    from tacotron_tpu_torch.weights import split_state

    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.infer import early_exit
    from tacotron_tpu_torch.utils.profiling import graph_nodes

    thr = report["fast"]["derived_threshold"]["silence_threshold"]
    p, bs = split_state(full_model(cfg, torch.device("cuda")))
    launches, nodes = collections.Counter(), collections.Counter()
    # the derived threshold sits just above seed 1's first steps' peaks, so
    # only seed 1 is sure to exit there: its calls all take that seed
    for label, key, c, seeds in (
            ("no exit", "fast_graph", cfg, SYNTH_GRAPH["compare"]),
            ("exit at step 6", "fast_graph_exit",
             cfg.replace(infer=dataclasses.replace(cfg.infer, silence_threshold=thr)), (1, 1, 1))):
        tag = f"[fast-graph] {label}"
        log(f"{tag}: Synthesizer, synth_fast, B 8, silence threshold "
            f"{c.infer.silence_threshold}: preamble, chunk and post-net graphs, Griffin-Lim "
            f"eager")
        rep, l_, n_, synth = synth_graph_phase(report, key, tag, c, p, bs, vocab, fused=False,
                                               seeds=seeds)
        rep["chunk_sweep"] = chunk_sweep(c, p, bs, vocab, rep["steps_done"])
        launches.update(l_)
        nodes.update(n_)
        fast = report["fast"]["preset_threshold" if key == "fast_graph" else "derived_threshold"]
        require(rep["steps_done"] == fast["steps_done"],
                f"{tag}: the replays' steps done equal [fast]'s eager call's "
                f"({fast['steps_done']})")
        require(sorted(rep["graphs"]) == ["chunk", "postnet", "preamble"]
                and not any(g["k4_nodes"] for g in rep["graphs"].values()),
                f"{tag}: preamble, chunk and post-net graphs, none holding K4 (Griffin-Lim "
                f"eager at t_gl {fast['t_gl']}, its launches counted in (c))")
        # the chunk graph: the step decode's one launch and the nodes of the
        # chunk's dropout draws, as a capture of the draws alone holds them
        (entry,) = synth.graphs.values()
        loop, chunk = entry.model["preamble"].outputs, rep["graphs"]["chunk"]
        with torch.cuda.stream(synth._stream):
            draws = graph_nodes(runtime.capture_graph(loop.draw_masks, synth._stream,
                                                      synth._gen).graph)
        n_draws = sum(n for k, n in draws.items() if "distribution" in k)
        rep["chunk_graph_draw_nodes"] = dict(draws)
        log(f"    the chunk's dropout draws captured alone: {dict(draws)}")
        require(chunk["step_decode_nodes"] == 1 and n_draws == 2 * early_exit.DECODE_CHUNK
                and chunk["nodes"] == sum(draws.values()) + 1
                and chunk["kernels"] == {**{k: n for k, n in draws.items() if not k.startswith("<")},
                                         **{k: 1 for k in chunk["kernels"]
                                            if "decode_chunk_kernel" in k}},
                f"{tag}: the chunk graph is the step decode's one launch and the nodes of the "
                f"chunk's {n_draws} dropout draws ({chunk['nodes']} nodes)")
        del synth
    return {"launches": dict(launches), "graph_nodes": dict(nodes)}


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
    graphed = main_bf16_graphed(cfg, vocab, synth, n_it, report["card"])
    report["main_bf16"] = {"stage_ms": out["stage_ms"], "wall_s": wall, "warm_s": warm_s,
                           "gl_iters": n_it, "audio_seconds": out["audio_seconds"],
                           "audio_seconds_per_s": aps, "launches": launches,
                           "mel_drift_from_f32": drift, "graphed": graphed}


def main_bf16_graphed(cfg, vocab, synth16, n_it, card):
    """[main-bf16] through its graph, in turns with [main]'s f32 model at the
    same Griffin-Lim depth: each Synthesizer's eager first call and capture
    (``synth16`` has had its eager call), then 3 replays of each in turns.
    -> the replays' ms by compute dtype."""
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.weights import split_state

    f32 = Synthesizer(cfg, *split_state(full_model(cfg, torch.device("cuda"))), vocab, fused=True)
    for s_ in (f32, f32, synth16):
        s_(PROMPTS, seed=1, gl_iters=n_it)
    ms = {"float32": [], "bfloat16": []}
    for _ in range(3):
        for name, s_ in (("float32", f32), ("bfloat16", synth16)):
            t0 = time.perf_counter()
            out = s_(PROMPTS, seed=1, gl_iters=n_it)
            ms[name].append((time.perf_counter() - t0) * 1e3)
            require(out["graphed"], f"the {name} call replayed its graph")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"  graphed, GL {n_it}, in turns: f32 replay ms {[round(x, 2) for x in ms['float32']]} "
        f"(median {med['float32']:.2f}), bf16 {[round(x, 2) for x in ms['bfloat16']]} (median "
        f"{med['bfloat16']:.2f}); {card}")
    return {"replay_ms": ms, "replay_ms_median": med}


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
    """K3 and K4 at [cli]'s own inputs (``check_synth_kernels``): the run
    directory's weights restored as the CLI restores them, its 2 prompts,
    its seed 0 and its configs (synth_gl1000, and synth_fast as
    ``--preset`` overlays it). -> the errors."""
    from tacotron_tpu_torch.cli.synthesize import overlay_preset
    from tacotron_tpu_torch.train import checkpoint, create_train_state
    from tacotron_tpu_torch.weights import split_state

    state, _ = checkpoint.restore(ckpt_dir, create_train_state(cfg, seed=1), cfg.train)
    p, bs = split_state(state.model)
    del state
    return check_synth_kernels("the CLI's", "cli", cfg, p, bs, vocab, PROMPTS[:2],
                               [("fused", cfg, True),
                                ("synth_fast", overlay_preset(cfg, "synth_fast"), False)])


def check_synth_kernels(where, tag, cfg, p, bs, vocab, texts, runs, gl_iters=None):
    """K3 and K4 against their plain versions at a synthesis path's own
    inputs: weights ``p``, ``bs``, ``texts``, seed 0, and ``runs``, each
    (name, config, fused). K3 at the cluster size the batch gives it, in
    both storage modes over 50 steps at K3_TOL, and over the path's steps in
    bf16 at MAIN_TOL; K4 in its bf16 mode, the mode the runs launch, on each
    run's magnitudes: its first iteration component by component within one
    bf16 ulp of the magnitude's peak, then as GL_PATH sets out (depth: the
    run's ``gl_iters``, by default its config's). -> the errors."""
    from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.models.tacotron import length_mask
    from tacotron_tpu_torch.ops.decode_loop import pack_decoder_weights

    dev = torch.device("cuda")
    synth = Synthesizer(cfg, p, bs, vocab, fused=True)
    m = synth.model
    text, lengths = synth.encode_texts(texts)
    mask = length_mask(text.shape[1], lengths)
    with torch.no_grad():
        # the Synthesizer's own draws: the encoder's from the call's generator
        memory = m.encoder(text, lengths, torch.Generator(device=dev).manual_seed(0))
        keys = m.memory_proj(memory)
    out = check_k3_at(where, memory, keys, mask, pack_decoder_weights(m.decoder.cell),
                      cfg.model.max_decode_steps)
    b = memory.shape[0]
    for name, c, fused in runs:
        acfg = c.audio
        # the run's spectrogram: the same call up to Griffin-Lim, which the
        # kernel is then held on at the run's shape
        res = Synthesizer(c, p, bs, vocab, fused=fused)(texts, seed=0, gl_iters=1)
        t_gl = res["wavs"].shape[1] // acfg.hop_length + 1
        mag = spectrogram_magnitude(torch.from_numpy(res["linear"][:, :t_gl]).to(dev), acfg)
        label = (f"{tag} {name}: griffin_lim bf16 (B {b}, F {t_gl}, momentum {acfg.gl_momentum})")
        out[f"griffin_lim_bf16_{name}"] = {
            "t_gl": t_gl, **check_k4_at(label, mag, acfg, gl_iters or acfg.griffin_lim_iters)}
    return out


def check_k3_at(where, memory, keys, mask, w, n_path):
    """K3 against its plain version on a path's encoder outputs: at the
    cluster size the batch gives it, in both storage modes over 50 steps at
    K3_TOL, and over the path's ``n_path`` steps in bf16 at MAIN_TOL. ->
    the errors."""
    from tacotron_tpu_torch.ops.decode_loop import (cluster_plan, decode_loop,
                                                    decode_loop_reference)

    b, t_in = memory.shape[:2]
    chosen, resident = cluster_plan(memory, keys, w)
    log(f"  K3 at {where} inputs (B {b}, T_in {t_in}): cluster size {chosen} (resident "
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
                f"{name} at {where} inputs finite, within frames {tf}"
                + ("" if ta is None else f", alignments {ta}"))
    return out


def check_k4_at(label, mag, acfg, n_iter, kernel=None, plain=None, over_share=0.0):
    """K4's bf16 mode, the mode the paths launch, against its plain version
    on a path's magnitudes ``mag``: its first iteration component by
    component within one bf16 ulp of the magnitude's peak, then as GL_PATH
    sets out at depth ``n_iter``. ``kernel(m, n)`` / ``plain(m, n)``: the
    spectrum after n iterations on m (by default ``griffin_lim_spectrum`` /
    ``gl_spectrum_reference`` at ``acfg``'s STFT and momentum);
    ``over_share`` as ``check_gl_steps``'. -> the errors."""
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference, griffin_lim_spectrum

    kw = dict(momentum=acfg.gl_momentum, **gl_kw(acfg))
    kernel = kernel or (lambda m, n: griffin_lim_spectrum(m, n_iter=n, **kw))
    plain = plain or (lambda m, n: gl_spectrum_reference(m, n_iter=n, **kw))
    with torch.no_grad():
        first = max(max_err(x, y) for x, y in zip(kernel(mag, 1), plain(mag, 1))) / float(mag.max())
    log(f"  {label}: first iteration max err / magnitude peak {first:.3e}")
    require(first <= GL_PATH["step_tol"], f"{label}: first iteration within one bf16 ulp "
            f"({GL_PATH['step_tol']:.2e}) of the magnitude's peak")
    chk = check_gl_path(label, mag, acfg, lambda n: kernel(mag, n), lambda n: plain(mag, n),
                        n_iter, over_share=over_share)
    return {"first_iteration": first, **chk}


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


@contextlib.contextmanager
def first_energy_call():
    """A list that receives (keys, q, v), detached, of the first
    attention-energy call made while the context is open."""
    from tacotron_tpu_torch.ops import attention
    seen = []
    inner = attention.attention_energy

    def spy(keys, q, v):
        if not seen:
            seen.append([x.detach().clone() for x in (keys, q, v)])
        return inner(keys, q, v)

    attention.attention_energy = spy
    try:
        yield seen
    finally:
        attention.attention_energy = inner


def capture_energy_inputs(model, batch, gen):
    """(keys, q, v) of the model's first attention-energy call on ``batch``
    (the first decoder step's), detached."""
    with first_energy_call() as seen, torch.no_grad():
        model.train()(batch[0], batch[1], gt_mel=batch[2].float(), generator=gen)
    return seen[0]


@contextlib.contextmanager
def graphed_steps():
    """A list that receives, for each ``GraphedTrainStep`` that
    ``make_train_step`` returns while the context is open (``cli.train``
    builds one), (the step, its calls): each call's kind ("eager": the
    shape's first step, "capture": its second, which captures and replays,
    "replay"), its padded frames and two CUDA events recorded on the
    caller's stream on either side of it. Nothing synchronises: the CLI's
    loop runs as a user's does, and a call's seconds are read after the run
    (``cli_graph_report``), on the device's timeline from the start event
    to the end event."""
    from tacotron_tpu_torch import train as train_pkg
    from tacotron_tpu_torch.train.step import GraphedTrainStep
    made = []
    inner = train_pkg.make_train_step

    def spy(*args, **kwargs):
        fn = inner(*args, **kwargs)
        if not isinstance(fn, GraphedTrainStep):
            return fn
        calls = []
        made.append((fn, calls))

        def timed(state, *batch):
            dev = next(state.model.parameters()).device
            entry = fn.graphs.get(fn.shape_key(dev, *batch), "new")
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
            out = fn(state, *batch)
            events[1].record()
            calls.append({"kind": "eager" if entry == "new" else "capture" if entry is None
                          else "replay", "frames": batch[2].shape[0] * batch[2].shape[1],
                          "events": events})
            return out

        return timed

    train_pkg.make_train_step = spy
    try:
        yield made
    finally:
        train_pkg.make_train_step = inner


def cli_graph_report(made, model_cfg) -> dict:
    """[train-cli]'s graphed step: each shape's graph (``graph_report``) and
    the steps' frames per second by kind (the first step of each bucket
    eager, its second capturing)."""
    require(len(made) == 1, f"cli.train built one graphed step ({len(made)})")
    fn, calls = made[0]
    remat = 2 if model_cfg.remat_decoder else 1
    graphs = [graph_report(e, e.inputs[2].shape[1] // model_cfg.r, remat)
              for e in fn.graphs.values() if e is not None]
    for c_ in calls:
        c_["events"][1].synchronize()
        c_["s"] = c_["events"][0].elapsed_time(c_.pop("events")[1]) / 1e3
    rate = {}
    for kind in ("eager", "capture", "replay"):
        sel = [c_ for c_ in calls if c_["kind"] == kind]
        rate[kind] = {"steps": len(sel), "frames_per_s": sum(c_["frames"] for c_ in sel)
                      / sum(c_["s"] for c_ in sel) if sel else None,
                      "ms": [round(c_["s"] * 1e3, 3) for c_ in sel]}
    return {"shapes": len(fn.graphs), "graphs": graphs, "by_kind": rate,
            "capture_s": [g["capture_s"] for g in graphs],
            "instantiate_s": [g["instantiate_s"] for g in graphs],
            "nodes": [g["nodes"] for g in graphs], "pool_bytes": [g["pool_bytes"] for g in graphs]}


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
    with deterministic():
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
        with graphed_steps() as made:
            lines, secs = run_cli(train_cli.main, base + extra)
        launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
        summaries = [json.loads(ln) for ln in lines if ln.startswith('{"step"')]
        cfg = Config.from_json(open(os.path.join(run, "config.json")).read())
        graphs = cli_graph_report(made, cfg.model)
        del made
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
                      "decoder_steps": n_dec, "graphed_step": graphs}
        for ln in lines:
            log(f"  {name}: {ln}")
        kinds = graphs["by_kind"]
        log(f"  {name}: the graphed step: {graphs['shapes']} shapes; steps by kind "
            f"{ {k: v['steps'] for k, v in kinds.items()} }; frames/s eager "
            f"{kinds['eager']['frames_per_s']}, capture {kinds['capture']['frames_per_s']}, "
            f"replay {kinds['replay']['frames_per_s']} (CUDA events, the loop unsynchronised); "
            f"capture s "
            f"{[round(x, 3) for x in graphs['capture_s']]}, instantiate s "
            f"{[round(x, 3) for x in graphs['instantiate_s']]}, nodes {graphs['nodes']}, pool "
            f"GiB {[round(x / 2**30, 3) for x in graphs['pool_bytes']]}; {rep['card']}")
        require(kinds["replay"]["steps"] > 0 and graphs["shapes"] == len(set(n_dec))
                == kinds["eager"]["steps"], f"{name}: one eager step and then a graph for each "
                f"of the run's {len(set(n_dec))} bucket shapes, and replays")
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
    report["checks"]["exit_vs_fixed"] = check_exit_vs_fixed(cfg, p, bs, vocab, min_steps)
    report["fast"] = {"preset_threshold": res1, "derived_threshold": res2,
                      "expected_steps": min_steps}
    mag1 = spectrogram_magnitude(
        torch.from_numpy(out1["linear"][:, :res1["t_gl"]]).to(dev), acfg)
    return cfg, res1, mag1


def check_exit_vs_fixed(cfg, p, bs, vocab, min_steps):
    """[fast] (f): the early-exit decode against the fixed decode on the same
    weights at full width (B 8, the 8 prompts, 500 steps), prenet dropout 0:
    a Synthesizer with ``early_exit`` at threshold -1 against one with
    ``early_exit=False, trim_before_gl=False``, three calls of seed 1 each
    (eager, capture + replay, replay), the mel and alignments equal bit for
    bit in every call; then the early exit at a threshold derived from the
    dropout-0 mel by [fast]'s rule (``exit_threshold``): its frames and
    alignments up to the exit equal the fixed decode's, zero after. Held
    under torch's default algorithms, the ones ``Synthesizer`` serves
    with. -> the gaps and the exit."""
    from tacotron_tpu_torch.infer.synthesize import Synthesizer

    r, n_steps = cfg.model.r, cfg.model.max_decode_steps
    model = dataclasses.replace(cfg.model, prenet_dropout=0.0)
    fixed_cfg = cfg.replace(model=model, infer=dataclasses.replace(
        cfg.infer, early_exit=False, trim_before_gl=False))
    exit_cfg = cfg.replace(model=model, infer=dataclasses.replace(cfg.infer,
                                                                  silence_threshold=-1.0))

    def calls(c):
        synth = Synthesizer(c, p, bs, vocab)
        outs = [synth(PROMPTS, seed=1) for _ in range(3)]
        require([o["graphed"] for o in outs] == [False, True, True],
                f"[fast] (f) early_exit={c.infer.early_exit}, threshold "
                f"{c.infer.silence_threshold}: calls eager, capture + replay, replay")
        return outs

    def gaps(a, b):
        """Per call: the largest mel and alignment difference, and the first
        decoder step at which the mels part (None where equal)."""
        out = []
        for x, y in zip(a, b):
            d = np.abs(x["mel"] - y["mel"]).reshape(8, n_steps, -1).max(axis=(0, 2))
            part = np.nonzero(d > 0)[0]
            out.append({"mel": float(d.max()),
                        "alignments": float(np.abs(x["alignments"] - y["alignments"]).max()),
                        "first_step_apart": int(part[0]) + 1 if len(part) else None})
        return out

    def equal(a, b):
        return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in ("mel", "alignments"))

    log(f"[fast] (f) the early exit at threshold -1 against the fixed decode, prenet dropout 0, "
        f"B 8, {n_steps} steps, calls eager / capture + replay / replay of seed 1")
    fixed, early = calls(fixed_cfg), calls(exit_cfg)
    rep = {"gaps": gaps(early, fixed)}
    log(f"  largest differences, by call: {rep['gaps']}")
    require(equal(early, fixed), "[fast] (f) the early exit at threshold -1 is bit-equal to the "
            "fixed decode in each call, mel and alignments")
    thr, _ = exit_threshold(fixed[0]["mel"], r, min_steps)
    exits = calls(exit_cfg.replace(infer=dataclasses.replace(exit_cfg.infer,
                                                             silence_threshold=thr)))
    steps = [steps_done_of(o["mel"], r) for o in exits]
    rep.update(derived_threshold=thr, steps_done=steps, exit_gaps=[
        {"mel": float(np.abs(o["mel"][:, :s_ * r] - f["mel"][:, :s_ * r]).max()),
         "alignments": float(np.abs(o["alignments"][:, :s_] - f["alignments"][:, :s_]).max())}
        for o, f, s_ in zip(exits, fixed, steps)])
    log(f"  derived threshold {thr:.6f}: steps done {steps}; largest differences up to the exit "
        f"{rep['exit_gaps']}")
    require(all(0 < s_ < n_steps for s_ in steps),
            f"[fast] (f) the derived threshold exits strictly inside (0, {n_steps}): {steps}")
    require(all(np.array_equal(o["mel"][:, :s_ * r], f["mel"][:, :s_ * r])
                and np.array_equal(o["alignments"][:, :s_], f["alignments"][:, :s_])
                and not np.abs(o["mel"][:, s_ * r:]).any()
                and not np.abs(o["alignments"][:, s_:]).any()
                for o, f, s_ in zip(exits, fixed, steps)),
            "[fast] (f) at the derived threshold the frames and alignments up to the exit equal "
            "the fixed decode's, zero after")
    return rep


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


def gl_graph_nodes(fn) -> dict:
    """Count the Griffin-Lim kernels of one call of ``fn`` from the kernel
    nodes of a CUDA graph captured around it (``utils.profiling.graph_nodes``),
    after an eager call on the capture stream that fills the lazy caches:
    {"k4": synthesis + overlap-add + analysis nodes, "pack": K5's pack nodes,
    "launches": what the capture's wrapper calls added to
    ``runtime.LAUNCHES``}. A graph's nodes are every launch of the call,
    where torch.profiler can drop a short kernel's event (2,999 of 3,000
    once); ``runtime.LAUNCHES`` is left as it was."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.utils.profiling import graph_nodes
    saved = collections.Counter(runtime.LAUNCHES)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.no_grad():
        with torch.cuda.stream(stream):
            fn()
        g = runtime.capture_graph(fn, stream)
    torch.cuda.current_stream().wait_stream(stream)
    nodes = graph_nodes(g.graph)
    out = {"k4": sum(n for k, n in nodes.items() if "gl_wgmma" in k or "gl_ola_frame" in k),
           "pack": sum(n for k, n in nodes.items() if "gl_pack" in k),
           "launches": dict(g.launches)}
    del g
    runtime.LAUNCHES.clear()
    runtime.LAUNCHES.update(saved)
    return out


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


def step_decode_timing(report, fast_cfg, fast_res, vocab):
    """The step decode's kernel (``ops/decode_chunk.py``) at [fast]'s shapes:
    the 8 prompts' encoder outputs of synth_fast with seed-0 weights, B 8,
    500 steps in 63 chunks of 8 with prenet dropout 0.5 and a threshold that
    never trips, as ``WhileDecode`` runs them on the card (mask draws, one
    launch a chunk). The kernel's device time by torch.profiler, the whole
    loop's (draws included) by CUDA events, its plain counterpart's
    (``run_chunk_plain`` on the card, eager), the kernel held to it on the
    same masks (STEP_DECODE_TOL), and the bound (weights, memory, keys once
    in f32; ``decode_bound``). -> the kernel table's row."""
    from tacotron_tpu_torch.infer.early_exit import WhileDecode, run_until_done
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.models.tacotron import length_mask
    from tacotron_tpu_torch.ops.decode_chunk import resident
    from tacotron_tpu_torch.ops.decode_loop import pack_decoder_weights
    from tacotron_tpu_torch.weights import split_state

    dev = torch.device("cuda")
    mcfg = fast_cfg.model
    n = mcfg.max_decode_steps
    log(f"[timing] the step decode's kernel at [fast]'s shapes ({n} steps, chunks of 8)")
    synth = Synthesizer(fast_cfg, *split_state(full_model(fast_cfg, dev)), vocab)
    text, lengths = synth.encode_texts(PROMPTS)
    with torch.no_grad():
        memory = synth.model.encoder(text, lengths, torch.Generator(device=dev).manual_seed(0))
        keys = synth.model.memory_proj(memory)
    mask, w = length_mask(text.shape[1], lengths), pack_decoder_weights(synth.model.decoder.cell)

    def loop():
        return WhileDecode(memory, keys, mask, w, torch.Generator(device=dev).manual_seed(5),
                           n_steps=n, r=mcfg.r, n_mels=mcfg.n_mels,
                           dropout_rate=mcfg.prenet_dropout, silence_threshold=-1.0)

    def run(lp, plain=False):
        step = lp.run_chunk_plain if plain else lp.run_chunk
        return run_until_done(step, n, lp.chunk)

    with torch.no_grad():
        kernel, plain = loop(), loop()
        chunks = run(kernel)
        run(plain, plain=True)
        err = {"frames": max_err(kernel.frames, plain.frames),
               "alignments": max_err(kernel.aligns, plain.aligns)}
        kern = device_kernels(lambda: run(loop()))
        k_ms = sum(ms for k, (ms, _) in kern.items() if "decode_chunk_kernel" in k)
        draws_ms = sum(ms for k, (ms, _) in kern.items() if "decode_chunk_kernel" not in k)
        loops = [loop() for _ in range(3)]
        loop_ms = cuda_ms(lambda: run(loops.pop()), reps=3)
        p_ms = cuda_ms(lambda: run(loop(), plain=True))
    require(chunks == -(-n // kernel.chunk) and int(kernel.t) == n,
            f"the step decode ran {chunks} chunks, all {n} steps")
    require(max(err.values()) <= STEP_DECODE_TOL,
            f"the step decode's kernel within {STEP_DECODE_TOL} of its plain counterpart at "
            f"[fast]'s shapes over {n} steps: {err}")
    cluster = kernel._launch.cluster(kernel.chunk)
    res = resident(kernel._launch.dims, kernel.chunk, dev)
    dbound = decode_bound(w, memory, keys, n, lowp=False)
    row = {"name": "decode_chunk", "route": "cuda",
           "source": "tacotron_tpu_torch/csrc/decode_chunk.cu",
           "replaces": "the early-exit decode's chunk of while_decoder_step (JAX decode_while's "
                       "XLA loop body); no TPU kernel",
           "launches": fast_res["launches"].get("decode_chunk", 0), "path": "[fast]",
           "max_abs_err": max(err.values()), "max_abs_err_of": err,
           "ms": k_ms, "loop_ms": loop_ms, "draws_ms": draws_ms, "plain_ms": p_ms,
           "bound_ms": dbound[0], "bound_by": dbound[1], "library_ms": None,
           "shape": f"B {memory.shape[0]} T_in {memory.shape[1]} steps {n} f32, chunks of "
                    f"{kernel.chunk}",
           "cluster": cluster, "resident_clusters": res, "us_per_step": k_ms / n * 1e3,
           "launches_per_call": chunks}
    log(f"  decode_chunk: {k_ms:.3f} ms of device time over {chunks} launches, "
        f"{k_ms / n * 1e3:.2f} us per step at cluster {cluster} ({res}); the loop with its "
        f"{2 * n}+ mask draws ({draws_ms:.3f} ms) {loop_ms:.3f} ms; plain {p_ms:.3f} ms; bound "
        f"{dbound[0]:.4f} ms by {dbound[1]}; against its plain counterpart {err}")
    report["checks"]["step_decode_fast_shapes"] = {**err, "tol": STEP_DECODE_TOL}
    del synth
    return row


def t2_config(vocab, n_steps=1000):
    """``synth_fast`` at Tacotron 2's published widths (the serving cell's
    ``tacotron2_f32``: r 1, pre-net 2 x 256, attention 128, 1000 steps, mels
    125 Hz-7.6 kHz, power 1.2)."""
    from tacotron_tpu_torch.config import Tacotron2Config, get_config
    base = get_config("synth_fast")
    return base.replace(
        model=dataclasses.replace(base.model, vocab_size=len(vocab), embed_dim=512,
                                  prenet_dims=(256, 256), attention_dim=128, r=1,
                                  max_decode_steps=n_steps),
        audio=dataclasses.replace(base.audio, fmin=125.0, fmax=7600.0, griffin_lim_power=1.2),
        tacotron2=Tacotron2Config())


def t2_model(cfg, dev, seed=0):
    """Tacotron 2 with seeded random weights (``init_params``, every bias 0)
    and its stop gate shut (bias -10): every row decodes all the steps."""
    from tacotron_tpu_torch.models.tacotron2 import Tacotron2
    from tacotron_tpu_torch.weights import init_params
    model = init_params(Tacotron2(cfg.model, cfg.tacotron2, cfg.audio, device=dev), seed=seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("bias"):
                p.zero_()
        model.decoder.gate.bias.fill_(-10.0)
    return model.eval()


def t2_decode_timing(report, vocab):
    """[t2] Tacotron 2's step decode kernel (S2, ``ops/t2_decode_chunk.py``)
    on its serving path: ``Synthesizer`` at the published widths
    (``t2_config``, ``t2_model``) on 8 prompts of 146-160 characters (B 8,
    T_in 160), 1000 steps a row; after an eager call, a capture and a
    replay, one replayed call with the launch counts set to 0 just before
    it, its kernel launches = its stage clock's ``chunks`` and
    ``decode_kernel_chunks`` (125). Then on that call's encoder outputs,
    as ``WhileDecode`` runs them (draws, one launch a chunk, pre-net
    dropout 0.5): the kernel held to ``run_chunk_plain`` on the same masks
    over the 1000 steps (T2_DECODE_TOL), its device time by torch.profiler,
    the whole loop's by CUDA events, the plain chunk's (eager), and the
    byte bound (every step weight, memory and keys read once a step, f32).
    -> the kernel table's row."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.infer.early_exit import WhileDecode, run_until_done
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.models.tacotron import length_mask
    from tacotron_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    cfg = t2_config(vocab)
    n = cfg.model.max_decode_steps
    texts = [(p + " " + PROMPTS[(i + 1) % len(PROMPTS)])[:160 - 2 * i]
             for i, p in enumerate(PROMPTS)]
    log(f"[t2] Tacotron 2 at the published widths: Synthesizer, B {len(texts)}, "
        f"{min(map(len, texts))}-{max(map(len, texts))} characters, {n} steps (gate shut)")
    model = t2_model(cfg, dev)
    params = dict(model.named_parameters())
    synth = Synthesizer(cfg, params, {k: v for k, v in model.state_dict().items()
                                      if k not in params}, vocab)
    for seed in range(3):                       # eager, capture, replay
        synth(texts, seed=seed)
    runtime.LAUNCHES.clear()
    with profiling.tracing():
        t0 = time.perf_counter()
        out = synth(texts, seed=3)
        wall = time.perf_counter() - t0
        counters = profiling.records()[-1]["counters"]
    launches = dict(runtime.LAUNCHES)
    chunks = -(-n // 8)
    log(f"  replayed call: {wall * 1e3:.2f} ms, {out['audio_seconds'] / wall:.2f} audio-s/s; "
        f"launches {launches}; counters {counters}")
    require(out["graphed"] and launches.get("t2_decode_chunk") == counters["chunks"]
            == counters["decode_kernel_chunks"] == chunks,
            f"[t2] the replayed call launched the kernel once a chunk, {chunks} chunks "
            f"({launches.get('t2_decode_chunk')}, {counters['chunks']}, "
            f"{counters['decode_kernel_chunks']})")

    text, lengths = synth.encode_texts(texts)
    mask = length_mask(text.shape[1], lengths)
    with torch.no_grad():
        memory = model.encoder(text, lengths)
        keys = model.memory_proj(memory)
    w = model.decoder.step_weights()

    def loop():
        return WhileDecode(memory, keys, mask, w, torch.Generator(device=dev).manual_seed(5),
                           n_steps=n, r=1, n_mels=cfg.model.n_mels,
                           dropout_rate=cfg.model.prenet_dropout)

    def run(lp, plain=False):
        return run_until_done(lp.run_chunk_plain if plain else lp.run_chunk, n, lp.chunk)

    with torch.no_grad():
        kernel, plain = loop(), loop()
        k_chunks = run(kernel)
        run(plain, plain=True)
        err = {"frames": max_err(kernel.frames, plain.frames),
               "alignments": max_err(kernel.aligns, plain.aligns),
               "state": max(max_err(a, b) for a, b in zip(kernel.state, plain.state))}
        carry = all(torch.equal(a, b) for a, b in ((kernel.t, plain.t),
                                                    (kernel.ended, plain.ended),
                                                    (kernel.lengths, plain.lengths)))
        kern = device_kernels(lambda: run(loop()))
        k_ms = sum(ms for k, (ms, _) in kern.items() if "t2_decode_kernel" in k)
        draws_ms = sum(ms for k, (ms, _) in kern.items() if "t2_decode_kernel" not in k)
        loops = [loop() for _ in range(3)]
        loop_ms = cuda_ms(lambda: run(loops.pop()), reps=3)
        p_ms = cuda_ms(lambda: run(loop(), plain=True))
    require(k_chunks == chunks and int(kernel.t) == n and carry,
            f"[t2] the kernel ran {chunks} chunks, all {n} steps, its carry equal to the plain "
            f"chunk's")
    require(max(err.values()) <= T2_DECODE_TOL,
            f"[t2] the kernel within {T2_DECODE_TOL} of run_chunk_plain at B {memory.shape[0]}, "
            f"T_in {memory.shape[1]} over {n} steps: {err}")
    tensors = [x for f in w if isinstance(f, (tuple, torch.Tensor))
               for x in (f if isinstance(f, tuple) else (f,))]
    byts = sum(x.numel() * x.element_size() for x in tensors) + 4 * (memory.numel()
                                                                    + keys.numel())
    flops = 2 * memory.shape[0] * sum(x.numel() for x in tensors if x.ndim >= 2)
    step_ms, by = bound(byts, flops, "f32")
    row = {"name": "t2_decode_chunk", "route": "cuda",
           "source": "tacotron_tpu_torch/csrc/t2_decode_chunk.cu",
           "replaces": "Tacotron 2's early-exit decode chunk in library operations "
                       "(run_chunk_plain); no TPU kernel",
           "launches": launches["t2_decode_chunk"], "path": "[t2]",
           "max_abs_err": max(err.values()), "max_abs_err_of": err,
           "ms": k_ms, "loop_ms": loop_ms, "draws_ms": draws_ms, "plain_ms": p_ms,
           "bound_ms": step_ms * n, "bound_ms_per_step": step_ms, "bound_by": by,
           "bound_bytes_per_step": byts, "library_ms": None,
           "shape": f"B {memory.shape[0]} T_in {memory.shape[1]} steps {n} f32, chunks of "
                    f"{kernel.chunk}, ring of {kernel._launch.stages} stages",
           "us_per_step": k_ms / n * 1e3, "roofline_pct": 100 * step_ms * n / k_ms,
           "launches_per_call": chunks, "call_ms": wall * 1e3}
    log(f"  t2_decode_chunk: {k_ms:.3f} ms of device time over {chunks} launches, "
        f"{k_ms / n * 1e3:.2f} us per step against a bound of {step_ms:.4f} ms per step "
        f"({byts / 1e6:.2f} MB by {by}; {row['roofline_pct']:.2f}%); the loop with its "
        f"{2 * n} mask draws ({draws_ms:.3f} ms) {loop_ms:.3f} ms; plain {p_ms:.3f} ms; "
        f"against its plain counterpart {err}")
    report["checks"]["t2_decode_serving_shapes"] = {**err, "tol": T2_DECODE_TOL}
    del synth
    return row


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
    # the device's count from a captured call's kernel nodes; the profiler only times
    node_counts = {
        "[fast]": gl_graph_nodes(lambda: griffin_lim_spectrum(mag_fast, **kw)),
        "[main]": gl_graph_nodes(lambda: griffin_lim_spectrum(mag_main, n_iter=m_it,
                                                              **gl_kw(acfg)))}
    for label, cnt, it in (("[fast]", cnt_fast, n_it), ("[main]", cnt_main, m_it)):
        nodes = node_counts[label]
        require(nodes["k4"] == cnt.get("griffin_lim") == nodes["launches"].get("griffin_lim")
                == 3 * it and nodes["pack"] == 0,
                f"K4 bf16 at {label}'s shape: {nodes['k4']} kernel nodes of a captured call = "
                f"LAUNCHES {cnt.get('griffin_lim')} = 3 per iteration, no pack")
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
          "ms_per_iteration": k_ms / n_it, "device_launches": node_counts["[fast]"]["k4"],
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
    nodes = gl_graph_nodes(lambda: griffin_lim_spectrum(mag_main, n_iter=reps, inner=1,
                                                        **gl_kw(acfg)))
    s_n = nodes["k4"] + nodes["pack"]
    require(s_n == cnt5.get("griffin_lim_step") == 4 * reps and nodes["pack"] == reps,
            f"K5: {s_n} kernel nodes of a captured call = LAUNCHES "
            f"{cnt5.get('griffin_lim_step')} = 4 per call, one of them the pack")
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
    nodes = gl_graph_nodes(lambda: griffin_lim_spectrum(mag_main, n_iter=reps, inner=1,
                                                        lowp=False, **gl_kw(acfg)))
    f_n = nodes["k4"] + nodes["pack"]
    require(f_n == cnt5f.get("griffin_lim_step") == 4 * reps and nodes["pack"] == reps,
            f"K5 f32: {f_n} kernel nodes of a captured call = LAUNCHES "
            f"{cnt5f.get('griffin_lim_step')} = 4 per call, one of them the pack")
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
    bp1 = bound(2 * x.numel() * 4, x.numel(), "f32")
    bp2 = bound((f * s_ + h * s_ + h * h + (f + 8) * h) * 4,
                2 * f * h * s_ + 2 * h * h + 4 * f * h, "f32")
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


def train_batch(cfg, dev, t_out=TRAIN_T_OUT):
    """The training path's batch, as bench.py makes it."""
    b, t_in = TRAIN_B, TRAIN_T_IN
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
    rep["profile"] = prof = profile_step(lambda: train_step(state, *batch, cfg=cfg), med)
    rep["roofline"] = train_roofline(cfg, med, prof["device_busy_ms"], report["card"])
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


def profile_step(step, step_ms):
    """One training step (``step()``) under torch.profiler: the kernels'
    device time, its share of the unprofiled median step (the device's busy
    share), and the kernels with the most device time."""
    rows = sorted(device_kernels(step).items(), key=lambda r: -r[1][0])
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


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic convolutions and torch's deterministic index
    reductions while the context is open (a warning, not an error, where an
    operation has none), the previous flags after."""
    flags = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])


def step_tensors(state) -> dict:
    """Copies of every tensor a training step updates, by kind and name,
    and the dropout generator's state."""
    m, opt = state.model, state.opt
    out = {}
    for k, p_ in m.named_parameters():
        out[f"param {k}"], out[f"grad {k}"] = p_.detach().clone(), p_.grad.clone()
        out.update({f"adam {slot} {k}": t.clone() for slot, t in opt.state[p_].items()})
    out.update({f"buffer {k}": b_.clone() for k, b_ in m.named_buffers()})
    out["generator"] = state.generator.get_state()
    return out


def graph_report(entry, n_dec, k1_per_step=2) -> dict:
    """One captured step's nodes (``utils.profiling.graph_nodes``), its K1,
    K2 and NCCL kernel nodes and the launches a replay adds, its capture and
    instantiate seconds and pool bytes; K1 held to ``k1_per_step`` nodes per
    decoder step (2 with remat: forward + recompute) and K2 to 1."""
    from tacotron_tpu_torch.utils.profiling import graph_nodes
    nodes = graph_nodes(entry.graph)
    out = {"nodes": sum(nodes.values()),
           "kernel_nodes": sum(n for k, n in nodes.items() if not k.startswith("<")),
           "other_nodes": {k: n for k, n in nodes.items() if k.startswith("<")},
           "k1_nodes": sum(n for k, n in nodes.items() if "energy_fwd" in k),
           "k2_nodes": sum(n for k, n in nodes.items() if "energy_bwd" in k),
           "nccl_nodes": sum(n for k, n in nodes.items() if "nccl" in k.lower()),
           "launches_per_replay": dict(entry.launches), "capture_s": entry.capture_s,
           "instantiate_s": entry.instantiate_s, "pool_bytes": entry.pool_bytes}
    k1 = k1_per_step * n_dec
    require(out["k1_nodes"] == k1 and out["k2_nodes"] == n_dec
            and out["launches_per_replay"] == {"attn_energy_fwd": k1, "attn_energy_bwd": n_dec},
            f"the graph holds {k1} K1 and {n_dec} K2 kernel nodes ({n_dec} decoder steps), "
            f"and a replay adds as many to runtime.LAUNCHES")
    return out


def adam_against_f64(before, state, train_cfg, count):
    """(b) update ``count`` (0-based) of the capturable Adam: the weights,
    moments and clipped gradients after it (``state``) against optax's
    formula in f64 from ``before`` (``step_tensors`` before the update) ->
    the largest gaps, the weights' over the update's LR."""
    from tacotron_tpu_torch.train.schedule import learning_rate
    b1, b2 = train_cfg.adam_b1, train_cfg.adam_b2
    lr, t = learning_rate(train_cfg, count), count + 1
    gap = {"param": 0.0, "exp_avg": 0.0, "exp_avg_sq": 0.0}
    for k, p_ in state.model.named_parameters():
        g = p_.grad.double()
        m0, v0 = before[f"adam exp_avg {k}"].double(), before[f"adam exp_avg_sq {k}"].double()
        st = state.opt.state[p_]
        want = before[f"param {k}"].double() - adam_move(g, m0, v0, t, lr, train_cfg)
        gap["param"] = max(gap["param"], float((p_.detach().double() - want).abs().max()))
        gap["exp_avg"] = max(gap["exp_avg"], float(
            (st["exp_avg"].double() - (b1 * m0 + (1 - b1) * g)).abs().max()))
        gap["exp_avg_sq"] = max(gap["exp_avg_sq"], float(
            (st["exp_avg_sq"].double() - (b2 * v0 + (1 - b2) * g * g)).abs().max()))
    gap.update(lr=lr, count=t, param_of_lr=gap["param"] / lr)
    return gap


def phase_train_graph(report, compute_dtype="float32"):
    """[train-graph] / [train-graph-bf16]: ``make_train_step``'s graphed step
    (``GraphedTrainStep``) at [train]'s recipe in ``compute_dtype``. (a) one
    eager first step, then TRAIN_GRAPH["compare"] graphed steps against as
    many eager ``train_step``s from the same seeded state, bit for bit under
    deterministic(): losses, grad norms, alignments every step, then the
    weights, gradients, Adam's moments and counts, batch statistics and the
    generator's state (f32: first, with the default algorithms, where two
    eager steps from one state differ); (b) the last of those updates against
    optax's formula in f64; (c) the graph's K1/K2 kernel nodes, nodes, capture
    and instantiate seconds and pool bytes, and one replay held against an
    eager ``train_step`` from a copy of the state (``dp_hold``); (d) replays and eager steps in
    turns (TRAIN_GRAPH["turns"]), the launch counts set to 0 just before and
    each replay's read, one replay under the profiler, the roofline; (e) a
    second shape (T_out TRAIN_GRAPH["t_out_2"]) with a graph of its own, then
    the first shape's graph again. -> K1/K2's launches over the timed replays,
    their graph nodes and device time per launch inside the replay."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.train import create_train_state, make_train_step, train_step
    from tacotron_tpu_torch.train.step import GraphedTrainStep

    dev = torch.device("cuda")
    bf16 = compute_dtype == "bfloat16"
    tag, key = ("[train-graph-bf16]", "train_graph_bf16") if bf16 else ("[train-graph]", "train_graph")
    cfg = train_config(compute_dtype)
    b, t_out, c = TRAIN_B, TRAIN_T_OUT, TRAIN_GRAPH
    n_dec = t_out // cfg.model.r
    batch = train_batch(cfg, dev)
    rep = report[key] = {"card": report["card"]}
    log(f"{tag} make_train_step at [train]'s recipe ({compute_dtype}, B {b}, T_in {TRAIN_T_IN}, "
        f"T_out {t_out}): one CUDA graph per shape after its eager first step")
    t_phase = time.perf_counter()
    if not bf16:
        pair = [create_train_state(cfg, seed=0) for _ in range(2)]
        pair = [train_step(st, *batch, cfg=cfg)[0] for st in pair]
        torch.cuda.synchronize()
        grads = [dict(st.model.named_parameters()) for st in pair]
        differ = [k for k in grads[0] if not torch.equal(grads[0][k].grad, grads[1][k].grad)]
        rep["eager_twice_default_algorithms"] = differ
        log(f"  two eager steps from one state, torch's default algorithms: {len(differ)} of "
            f"{len(grads[0])} gradients differ: {differ[:8]}")
        del pair, grads

    with deterministic():
        graphed, eager = create_train_state(cfg, seed=0), create_train_state(cfg, seed=0)
        step = make_train_step(cfg)
        require(isinstance(step, GraphedTrainStep), "make_train_step on the card is a GraphedTrainStep")
        steps = []
        for i in range(1 + c["compare"]):
            if i == c["compare"]:
                before = step_tensors(graphed)
            graphed, m_g, a_g = step(graphed, *batch)
            eager, m_e, a_e = train_step(eager, *batch, cfg=cfg)
            steps.append({"graphed": i > 0, "loss": float(m_g["total_loss"]),
                          "grad_norm": float(m_g["grad_norm"]),
                          "equal": all(torch.equal(m_g[k], m_e[k]) for k in m_e)
                          and torch.equal(a_g, a_e)})
        g_t, e_t = step_tensors(graphed), step_tensors(eager)
        differ = [k for k in e_t if not torch.equal(g_t[k], e_t[k])]
        rep["compare"] = {"steps": steps, "tensors": len(e_t), "tensors_differ": differ}
        log(f"  (a) {steps}; {len(e_t)} tensors after the run, {len(differ)} differ {differ[:6]}")
        require(all(s_["equal"] for s_ in steps), f"(a) every step's losses, grad norm and "
                f"alignments bit-equal, graphed ({c['compare']} steps) against eager")
        require(not differ, "(a) weights, gradients, Adam's moments and counts, batch statistics "
                "and the generator's state bit-equal after the run")
        rep["adam_f64"] = gap = adam_against_f64(before, graphed, cfg.train, graphed.step - 1)
        del before, g_t, e_t
        log(f"  (b) update {gap['count']} (LR {gap['lr']:.3g}) against optax's formula in f64: "
            f"weights {gap['param']:.3e} ({gap['param_of_lr']:.3e} of the LR), exp_avg "
            f"{gap['exp_avg']:.3e}, exp_avg_sq {gap['exp_avg_sq']:.3e}")
        require(gap["param_of_lr"] <= ADAM_F64_OF_LR, f"(b) every weight within {ADAM_F64_OF_LR} "
                f"of the LR of optax's update in f64")
    # the deterministic algorithms' graph is not the one users run: a new
    # step, with torch's default algorithms, captures the measured graph
    step = make_train_step(cfg)
    for _ in range(2):
        t0 = time.perf_counter()
        graphed, m, _ = step(graphed, *batch)
        float(m["total_loss"])
        rep.setdefault("first_steps_ms", []).append((time.perf_counter() - t0) * 1e3)
    entry = step.graphs[next(iter(step.graphs))]
    rep["graph"] = graph_report(entry, n_dec)
    gr = rep["graph"]
    log(f"  (c) a new step with the default algorithms: the eager first step "
        f"{rep['first_steps_ms'][0]:.1f} ms, the second (capture, instantiate, replay) "
        f"{rep['first_steps_ms'][1]:.1f} ms; the graph: {gr['nodes']} nodes "
        f"({gr['kernel_nodes']} kernels, {gr['other_nodes']}), K1 {gr['k1_nodes']}, K2 "
        f"{gr['k2_nodes']}; capture {gr['capture_s']:.3f} s, instantiate "
        f"{gr['instantiate_s']:.3f} s, pool {gr['pool_bytes'] / 2**30:.3f} GiB")
    graphed, rep["replay_vs_eager"] = replay_vs_eager("(c)", step, graphed, cfg, batch)

    ms = {"G": [], "E": []}
    runtime.LAUNCHES.clear()
    graph_launches = collections.Counter()
    for kind in c["turns"]:
        counts = collections.Counter(runtime.LAUNCHES)
        t0 = time.perf_counter()
        if kind == "G":
            graphed, m, _ = step(graphed, *batch)
        else:
            eager, m, _ = train_step(eager, *batch, cfg=cfg)
        loss = float(m["total_loss"])
        ms[kind].append((time.perf_counter() - t0) * 1e3)
        require(np.isfinite(loss), f"{kind} loss finite")
        if kind == "G":
            graph_launches.update(runtime.LAUNCHES)
            graph_launches.subtract(counts)
    graph_launches = dict(+graph_launches)
    n_g = len(ms["G"])
    med, med_e = float(np.median(ms["G"])), float(np.median(ms["E"]))
    per_replay = {k: v / n_g for k, v in graph_launches.items()}
    require(per_replay == {"attn_energy_fwd": 2 * n_dec, "attn_energy_bwd": n_dec},
            f"(d) each of {n_g} replays counted {2 * n_dec} K1 and {n_dec} K2 launches")
    rep.update(replay_ms=ms["G"], eager_ms=ms["E"], replay_ms_median=med, eager_ms_median=med_e,
               train_frames_per_s=b * t_out / (med / 1e3),
               eager_frames_per_s=b * t_out / (med_e / 1e3), launches=graph_launches)
    log(f"  (d) in turns {c['turns']}: replay ms {[round(x, 3) for x in ms['G']]} (median "
        f"{med:.3f}), eager ms {[round(x, 3) for x in ms['E']]} (median {med_e:.3f}); train "
        f"frames/s {rep['train_frames_per_s']:.1f} graphed, {rep['eager_frames_per_s']:.1f} "
        f"eager; {report['card']}")
    rep["profile"] = prof = profile_step(lambda: step(graphed, *batch), med)
    rep["roofline"] = train_roofline(cfg, med, prof["device_busy_ms"], report["card"])
    mode = "__nv_bfloat16" if bf16 else "float"
    in_graph = {d: prof["energy_kernels_ms"][f"energy_{d}<{mode}, true>"]
                / prof["energy_kernels"][f"energy_{d}<{mode}, true>"] for d in ("fwd", "bwd")}
    log(f"  K1/K2 in the profiled replay: {prof['energy_kernels']}; device us per launch "
        f"{ {d: round(v * 1e3, 3) for d, v in in_graph.items()} }")

    t2 = c["t_out_2"]
    batch2 = train_batch(cfg, dev, t_out=t2)
    losses = []
    for bt in (batch2, batch2, batch):
        graphed, m, _ = step(graphed, *bt)
        losses.append(float(m["total_loss"]))
    entries = [e_ for e_ in step.graphs.values() if e_ is not None]
    require(len(step.graphs) == 2 and len(entries) == 2 and all(np.isfinite(losses)),
            f"(e) T_out {t2} got a graph of its own, then T_out {t_out}'s replayed ({losses})")
    rep["second_shape"] = graph_report(step.graphs[next(
        k for k in step.graphs if k[4][0][1] == t2)], t2 // cfg.model.r)
    rep["seconds"] = time.perf_counter() - t_phase
    log(f"  (e) T_out {t2}: {rep['second_shape']['nodes']} nodes, capture "
        f"{rep['second_shape']['capture_s']:.3f} s, pool "
        f"{rep['second_shape']['pool_bytes'] / 2**30:.3f} GiB; {tag} {rep['seconds']:.1f} s")
    del step, graphed, eager
    return {"launches": graph_launches, "graph_nodes": {"attn_energy_fwd": gr["k1_nodes"],
                                                        "attn_energy_bwd": gr["k2_nodes"]},
            "ms_in_graph": {"attn_energy_fwd": in_graph["fwd"],
                            "attn_energy_bwd": in_graph["bwd"]}}


def replay_vs_eager(tag, step, state, cfg, batch):
    """One replay of ``step``'s graph for ``batch`` against an eager
    ``train_step`` from a copy of ``state`` (weights, batch statistics,
    Adam's moments and count, the dropout generator), held by dp_hold, and
    the alignments within GRAPH_ALIGN_ATOL -> (the state after the replay,
    the errors)."""
    m_ = state.model
    prev = {"params": {k: host_copy(p_.detach()) for k, p_ in m_.named_parameters()},
            "stats": {k: host_copy(b_) for k, b_ in m_.named_buffers()},
            "opt": host_copy(state.opt.state_dict())}
    gen = state.generator.get_state()
    state, got = dp_run(state, step, batch, 1)
    want = dp_restart(cfg, batch, prev, gen)
    rec = dp_hold(f"{tag} one replay of that graph against train_step from a copy of its state",
                  {**got["steps"][0], "metrics": got["metrics"][0]},
                  {**want["steps"][0], "metrics": want["metrics"][0]}, prev, cfg.train)
    align = float((got["alignments"][0] - want["alignments"][0]).abs().max())
    rec.update(alignments=align, metrics=(got["metrics"][0], want["metrics"][0]))
    require(align <= GRAPH_ALIGN_ATOL, f"{tag} the replay's alignments within "
            f"{GRAPH_ALIGN_ATOL} of train_step's ({align:.3e})")
    return state, rec


def whole_step_share(flops, ms, kind):
    """(TFLOP/s, share of the H100's ``kind`` peak) of ``flops`` done in ``ms``."""
    from tacotron_tpu_torch.utils.roofline import H100
    rate = flops / (ms / 1e3)
    return rate / 1e12, rate / H100[kind]["flops_peak"]


def train_roofline(cfg, step_ms, busy_ms, card):
    """The training path's whole-step work, ``train_step_flops`` at its
    shapes with remat as it runs, over the median step and over the
    profiled step's device-busy time, against the peak of the step's
    compute dtype: f32 (TF32 is off) or bf16."""
    from tacotron_tpu_torch.utils.roofline import H100, train_step_flops
    kind = "bf16" if cfg.model.compute_dtype == "bfloat16" else "f32"
    flops = train_step_flops(cfg.model, TRAIN_B, TRAIN_T_IN, TRAIN_T_OUT)
    tflops, mfu = whole_step_share(flops, step_ms, kind)
    busy_tflops, mfu_busy = whole_step_share(flops, busy_ms, kind)
    log(f"  roofline: train_step_flops {flops / 1e9:.1f} GFLOP a step (remat_decoder "
        f"{cfg.model.remat_decoder}); the median step {tflops:.4f} TFLOP/s, mfu {mfu:.3e} of "
        f"the {H100[kind]['name']} peak ({H100[kind]['flops_peak'] / 1e12:g} TFLOP/s); the "
        f"profiled step's device-busy {busy_ms:.3f} ms: {busy_tflops:.3f} TFLOP/s, "
        f"mfu_device_busy {mfu_busy:.3e}; {card}")
    return {"train_step_flops": flops, "peak": H100[kind]["name"], "tflops": tflops,
            "mfu": mfu, "tflops_device_busy": busy_tflops, "mfu_device_busy": mfu_busy}


def synth_roofline(cfg, t_in, frames, gl_iters, wall_s, card):
    """One ``Synthesizer`` call's work from the roofline's functions: the
    model forward (``train_step_flops(fwd_only=True)`` at T_out = the
    decode's frames) plus ``gl_iters`` x ``gl_iteration_flops``, over the
    call's wall time, reckoned against the H100's bf16 peak."""
    from tacotron_tpu_torch.utils.roofline import H100_BF16, gl_iteration_flops, train_step_flops
    b, a = len(PROMPTS), cfg.audio
    fwd = train_step_flops(cfg.model, b, t_in, cfg.model.max_decode_steps * cfg.model.r,
                           fwd_only=True)
    per_it = gl_iteration_flops(b, frames, a.n_fft, a.win_length)
    tflops, mfu = whole_step_share(fwd + gl_iters * per_it, wall_s * 1e3, "bf16")
    log(f"  roofline: forward {fwd / 1e9:.2f} GFLOP (train_step_flops fwd_only, B {b}, T_in "
        f"{t_in}, T_out {cfg.model.max_decode_steps * cfg.model.r}) + Griffin-Lim {gl_iters} x "
        f"{per_it / 1e9:.2f} GFLOP (gl_iteration_flops, F {frames}, the 128-aligned span) = "
        f"{(fwd + gl_iters * per_it) / 1e12:.3f} TFLOP; the call {tflops:.3f} TFLOP/s, mfu "
        f"{mfu:.3e}, reckoned against the {H100_BF16['name']} peak "
        f"({H100_BF16['flops_peak'] / 1e12:g} TFLOP/s); {card}")
    return {"forward_flops": fwd, "gl_iteration_flops": per_it, "gl_iters": gl_iters,
            "peak": H100_BF16["name"], "tflops": tflops, "mfu": mfu}


def phase_train_timing(report, state, batch, launches, graph):
    """K1/K2 at the training path's shapes, in the mode of the state's
    model: keys and q are that model's (bf16 under bf16 compute). Each row's
    ``launches`` are the graphed step's over [train-graph]'s timed replays
    (``graph``, ``phase_train_graph``'s result), beside its graph nodes and
    device time per launch inside the replay; ``eager_launches`` are
    [train]'s timed eager steps'."""
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
    fb = bound((el + b * a) * es + (a + b * t) * 4, 4 * el, "f32")
    bb = bound((2 * el + 2 * b * a) * es + (2 * a + b * t) * 4, 9 * el, "f32")
    steps = TRAIN_STEPS[m.cfg.compute_dtype]
    per_step = {k: launches.get(k, 0) / steps for k in ("attn_energy_fwd", "attn_energy_bwd")}
    shape = f"B {b} T_in {t} A {a} {'bf16' if bf16 else 'f32'}"
    gpath = "[train-graph-bf16]" if bf16 else "[train-graph]"
    k1 = {"name": "attn_energy_fwd" + sfx, "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/attn_energy.cu",
          "replaces": "tacotron_tpu/ops/pallas/attn_energy.py:63",
          "launches": graph["launches"].get("attn_energy_fwd", 0), "path": gpath,
          "eager_launches": launches.get("attn_energy_fwd", 0), "eager_path": path,
          "graph_nodes": graph["graph_nodes"]["attn_energy_fwd"],
          "ms_in_graph": graph["ms_in_graph"]["attn_energy_fwd"],
          "max_abs_err": errs["e"][0],
          "ms": f_ms, "plain_ms": fp_ms, "bound_ms": fb[0], "bound_by": fb[1],
          "library_ms": None, "shape": shape, "call_ms": call_ms["fwd"],
          "plain_call_ms": call_ms["fwd_plain"],
          "ms_per_step": f_ms * per_step["attn_energy_fwd"],
          "ms_in_step": in_step["fwd"], "floor_ms": floor["fwd"]}
    k2 = {"name": "attn_energy_bwd" + sfx, "route": "cuda",
          "source": "tacotron_tpu_torch/csrc/attn_energy.cu",
          "replaces": "tacotron_tpu/ops/pallas/attn_energy.py:69",
          "launches": graph["launches"].get("attn_energy_bwd", 0), "path": gpath,
          "eager_launches": launches.get("attn_energy_bwd", 0), "eager_path": path,
          "graph_nodes": graph["graph_nodes"]["attn_energy_bwd"],
          "ms_in_graph": graph["ms_in_graph"]["attn_energy_bwd"],
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
            f"eager step, {k['ms_in_graph'] * 1e3:.2f} us in the profiled replay (plain "
            f"{k['plain_ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.2f} us by "
            f"{k['bound_by']}, floor {k['floor_ms'] * 1e3:.2f} us, library none); "
            f"{k['launches']} launches over {gpath}'s timed replays, {k['graph_nodes']} nodes "
            f"in its graph")
    return [k1, k2]


DP = {"steps": 3, "prompts": 8, "cli_steps": (4, 6), "per_chip_batch": 16, "timeout_s": 600}
# [dp] the 2-rank step against the one-process step on the same 32 rows, the
# same dropout masks (both at deterministic convolutions), each step from a
# common state: step 1 from the seeded weights, steps 2 and 3 from rank 0's
# state after the step before (weights, batch statistics, Adam moments,
# dropout generator), so that what differs is the step alone and no earlier
# step's rounding carried forward. Then: losses and gradient norm rel
# DP_LOSS_RTOL (summation order only); the gradients by [train-cli]'s rule
# (1e-4 of each one's peak + 1e-7 + CLI_GRAD_FLOOR of the largest entry;
# cancelling sums move by far more than their own peak's 1e-4 with a
# last-bit change) and each also within DP_GRAD_OF_PEAK of its own peak,
# so that no tensor of small gradients hides under the model's largest
# entry (the post-net's cancelling convolution sums were the worst, 4.9e-3
# of their peak at step 1 on an H100; a gradient left unreduced is off by
# half of its own); the
# updated parameters within DP_PARAM_ATOL plus 1.01 x the difference of the
# two Adam moves that the two steps' clipped gradients make from the
# common moments (Adam's first step moves an entry by lr g / (|g| + eps),
# so where |g| is near eps a rounding-sized difference of g moves it by up
# to 2 lr); the running batch statistics after the step (0.99 of the
# common ones + 0.01 of the global batch's: per-rank statistics would be
# 1e-3 off) within DP_STAT_TOL of each one's peak + 1e-7. The uninterrupted
# runs' statistics after step 3 are printed beside them: they differ by the
# parameters that Adam's first step moved apart
DP_LOSS_RTOL = 1e-5
DP_GRAD_OF_PEAK = 2e-2
DP_PARAM_ATOL = 2e-6
DP_STAT_TOL = 1e-5


def dp_train_config():
    """[train]'s recipe in f32 (hoisted, remat, the fused energy), prenet
    dropout 0.5 as full_1chip has it."""
    return train_config("float32")


def dp_tp_config():
    """The tensor-parallel check's config: tiny widths, vocab 32 and n_freq
    260 (both split in two), the fused energy, model 2."""
    from tacotron_tpu_torch.config import MeshConfig, get_config
    c = get_config("tiny_cpu")
    return dataclasses.replace(c, model=dataclasses.replace(
        c.model, vocab_size=32, n_freq=260, attention_energy="fused"),
        mesh=MeshConfig(model_parallel_size=2))


def dp_tp_batch(dev):
    g = torch.Generator().manual_seed(3)
    b, t_in, t_out = 8, 24, 40
    lengths = torch.tensor([24, 20, 17, 24, 9, 13, 22, 24])
    text = torch.randint(1, 30, (b, t_in), generator=g) * (torch.arange(t_in) < lengths[:, None])
    batch = [text, lengths, torch.rand(b, t_out, 80, generator=g),
             torch.rand(b, t_out, 260, generator=g), torch.full((b,), t_out)]
    return [x.to(dev) for x in batch]


def dp_deterministic():
    """Deterministic convolutions and index reductions, so that the
    one-process step repeats bit for bit; TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)


def host_copy(x):
    """``x`` (a tensor, or a dict or list of them) copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_copy(v) for v in x)
    return x


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()


def dp_run(state, step_fn, arrays, n_steps, keep=True):
    """n_steps of ``step_fn`` -> metrics and ms per step, and for each step
    the digests of its gradients, updated parameters and batch statistics,
    full (gathered over a model group); with ``keep`` also those tensors on
    the host, the dropout generator's state before the step and (but for
    the last step, and unsharded) the Adam state after it."""
    from tacotron_tpu_torch.parallel.sharding import full_tensor
    m = state.model
    out = {"metrics": [], "ms": [], "digests": [], "steps": [], "alignments": []}
    for i in range(n_steps):
        gen = state.generator.get_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, align = step_fn(state, *arrays)
        metrics = {k: float(v) for k, v in metrics.items()}
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append(metrics)
        out["alignments"].append(host_copy(align))
        rec = {"grads": {k: host_copy(full_tensor(m, k, p.grad)) for k, p in m.named_parameters()},
               "params": {k: host_copy(full_tensor(m, k, p.detach()))
                          for k, p in m.named_parameters()},
               "stats": {k: host_copy(b) for k, b in m.named_buffers()}}
        out["digests"].append({s: {k: digest(t) for k, t in rec[s].items()} for s in rec})
        if keep:
            rec["gen"] = gen
            if i < n_steps - 1 and not getattr(m, "tp_shards", None):
                rec["opt"] = host_copy(state.opt.state_dict())
            out["steps"].append(rec)
    return state, out


def dp_restart(cfg, batch, prev, gen):
    """One eager ``train_step`` on ``batch`` from the state after another
    run's step (``prev``: its ``dp_run`` record; None: the seeded start)
    and from its dropout generator state ``gen`` -> that step's
    ``dp_run``."""
    from tacotron_tpu_torch.train import create_train_state, train_step
    state = create_train_state(cfg, seed=0, device=batch[0].device)
    if prev is not None:
        state.model.load_state_dict({**prev["params"], **prev["stats"]})
        # a copy: Adam keeps the loaded step counts and advances them in place;
        # the groups keep their own LR tensors on the card (the copy's are the host's)
        saved = host_copy(prev["opt"])
        for group, live in zip(saved["param_groups"], state.opt.param_groups):
            group["lr"] = live["lr"]
        state.opt.load_state_dict(saved)
        state = state._replace(step=int(prev["opt"]["state"][0]["step"]))
    state.generator.set_state(gen)
    return dp_run(state, functools.partial(train_step, cfg=cfg), batch, 1)[1]


def adam_move(g, m0, v0, t, lr, tc):
    """The move of Adam's step ``t`` (from 1) on gradient ``g`` from the
    moments m0, v0 (None: zero), in f64: lr m_hat / (sqrt(v_hat) + eps)."""
    b1, b2, eps = tc.adam_b1, tc.adam_b2, tc.adam_eps
    g = g.double()
    m = (1 - b1) * g + (0 if m0 is None else b1 * m0.double())
    v = (1 - b2) * g * g + (0 if v0 is None else b2 * v0.double())
    return lr / (1 - b1 ** t) * m / (v.sqrt() / (1 - b2 ** t) ** 0.5 + eps)


def dp_hold(tag, got, want, prev, train_cfg):
    """One step's record ``got`` (a rank's) against ``want`` (one process's
    from the same state; ``prev``: that state's record, None for the
    seeded start) by the DP_* rules; ``got``/``want`` also carry the step's
    ``metrics``. -> the worst errors."""
    from tacotron_tpu_torch.train.schedule import learning_rate
    t = 1 if prev is None else int(prev["opt"]["state"][0]["step"]) + 1
    lr = learning_rate(train_cfg, t - 1)
    for k in ("mel_loss", "linear_loss", "total_loss", "grad_norm"):
        g, w = got["metrics"][k], want["metrics"][k]
        require(abs(g - w) <= DP_LOSS_RTOL * abs(w),
                f"{tag}: {k} {g:.7f} within rel {DP_LOSS_RTOL} of one process's {w:.7f}")
    top = max(float(g.abs().max()) for g in want["grads"].values())
    worst = {"grad_of_tol": 0.0, "grad_of_peak": {}, "param": 0.0, "param_amplified": 0,
             "stat_of_tol": 0.0}
    names = list(want["params"])
    moments = {} if prev is None else {names[i]: (s["exp_avg"], s["exp_avg_sq"])
                                       for i, s in prev["opt"]["state"].items()}
    bad, n_all = {}, 0
    for k, w in want["grads"].items():
        err = float((got["grads"][k] - w).abs().max())
        peak = float(w.abs().max())
        tol = 1e-4 * peak + 1e-7 + CLI_GRAD_FLOOR * top
        worst["grad_of_tol"] = max(worst["grad_of_tol"], err / tol)
        worst["grad_of_peak"][k] = err / peak if peak else (0.0 if err == 0 else float("inf"))
        m0, v0 = moments.get(k, (None, None))
        d = (got["params"][k] - want["params"][k]).abs().double()
        adam = 1.01 * (adam_move(got["grads"][k], m0, v0, t, lr, train_cfg)
                       - adam_move(w, m0, v0, t, lr, train_cfg)).abs()
        if not bool((d <= DP_PARAM_ATOL + adam).all()):
            bad[k] = float((d - adam).max())
        amplified = adam > DP_PARAM_ATOL
        worst["param"] = max(worst["param"], float(d[~amplified].max())
                             if (~amplified).any() else 0.0)
        worst["param_amplified"] += int(amplified.sum())
        n_all += w.numel()
    require(worst["grad_of_tol"] <= 1.0, f"{tag}: every gradient within 1e-4 of its peak + "
            f"1e-7 + {CLI_GRAD_FLOOR} x the largest entry (worst {worst['grad_of_tol']:.3f} of it)")
    ranked = sorted(worst["grad_of_peak"].items(), key=lambda kv: -kv[1])
    log(f"  {tag}: gradients' error over their own peak, the largest: "
        + ", ".join(f"{k} {v:.3e}" for k, v in ranked[:4]))
    worst["grad_of_peak_max"] = ranked[0][1]
    del worst["grad_of_peak"]
    require(worst["grad_of_peak_max"] <= DP_GRAD_OF_PEAK, f"{tag}: every gradient within "
            f"{DP_GRAD_OF_PEAK} of its own peak (worst {worst['grad_of_peak_max']:.3e})")
    require(not bad, f"{tag}: every updated parameter within {DP_PARAM_ATOL} + 1.01 x the "
            f"difference of the two Adam moves (past it: {bad})")
    for k, w in want["stats"].items():
        tol = DP_STAT_TOL * float(w.abs().max()) + 1e-7
        worst["stat_of_tol"] = max(worst["stat_of_tol"],
                                   float((got["stats"][k] - w).abs().max()) / tol)
    require(worst["stat_of_tol"] <= 1.0, f"{tag}: running batch statistics within "
            f"{DP_STAT_TOL} of each one's peak + 1e-7 (worst {worst['stat_of_tol']:.3f} of it)")
    log(f"  {tag}: worst gradient {worst['grad_of_tol']:.3e} of its tolerance; parameters "
        f"max diff {worst['param']:.3e} where the Adam moves' difference is under "
        f"{DP_PARAM_ATOL}, {worst['param_amplified']} of {n_all} entries where it is not")
    return worst


def dp_energy_check(seen):
    """K1 and K2 alone on the (keys, q, v) of a rank's first energy call
    (its own batch rows): against autograd through the plain formula
    (``energy_check``) and against ``energy_bwd_reference`` directly ->
    {name: (max abs error, peak)}, dv's repeat and K2's cluster size."""
    from tacotron_tpu_torch.ops.attn_energy import (attention_energy_reference, energy_bwd,
                                                    energy_bwd_reference, energy_fwd, plan_of)
    keys, q, v = seen[0]
    de = torch.randn(keys.shape[:2], generator=torch.Generator().manual_seed(5)).to(keys.device)
    errs, same_dv = energy_check(keys, q, v, de)
    got = (energy_fwd(keys, q, v), *energy_bwd(keys, q, v, de))
    want = (attention_energy_reference(keys, q, v), *energy_bwd_reference(keys, q, v, de))
    torch.cuda.synchronize()
    for n, g, w in zip(("e", "dkeys", "dq", "dv"), got, want):
        errs[f"direct_{n}"] = (max_err(g, w), float(w.abs().max()))
    return {"errs": errs, "dv_repeats": same_dv, "shape": tuple(keys.shape),
            "cluster": plan_of(keys).cluster}


def dp_ranks(rank, world):
    """What each of [dp]'s two ranks runs on the one card (a gloo group):
    the full-width data-parallel steps, the tensor-parallel step and the
    mesh synthesis; each with this rank's kernel launches, and K1/K2 held
    alone on this rank's own first energy call. Rank 0 returns the steps'
    tensors, rank 1 their digests."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.infer import Synthesizer
    from tacotron_tpu_torch.parallel import make_mesh
    from tacotron_tpu_torch.train import create_train_state, make_train_step
    from tacotron_tpu_torch.weights import split_state

    import torch.distributed as dist

    from tacotron_tpu_torch.train.step import GraphedTrainStep

    dp_deterministic()
    out = {"rank": rank, "backend": dist.get_backend()}
    for name, cfg in (("dp", dp_train_config()), ("tp", dp_tp_config())):
        mesh = make_mesh(cfg.mesh)
        if name == "dp":
            per = TRAIN_B // mesh.data_size
            rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
            arrays, n_steps = [x[rows] for x in train_batch(cfg, mesh.device)], DP["steps"]
        else:
            arrays, n_steps = dp_tp_batch(mesh.device), 1
        state = create_train_state(cfg, seed=0, mesh=mesh)
        step = make_train_step(cfg, mesh)
        runtime.LAUNCHES.clear()
        with first_energy_call() as seen:
            state, res = dp_run(state, step, arrays, n_steps, keep=rank == 0)
        res["graphed"] = isinstance(step, GraphedTrainStep)
        res["launches"] = dict(runtime.LAUNCHES)
        res["mesh"] = (mesh.data_size, mesh.model_size)
        res["shards"] = {k: tuple(p.shape) for k, p in state.model.named_parameters()
                         if k in state.model.tp_shards}
        del state
        res["energy"] = dp_energy_check(seen)
        out[name] = res

    cfg = get_config("synth_gl1000")
    vocab = Vocab.build(PROMPTS)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    mesh = make_mesh(cfg.mesh)
    synth = Synthesizer(cfg, *split_state(full_model(cfg, mesh.device)), vocab, mesh=mesh)
    runtime.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = synth(PROMPTS[:DP["prompts"]], seed=0, peak_normalize=False)
    out["synth"] = {"wall_ms": (time.perf_counter() - t0) * 1e3, "graphed": res["graphed"],
                    "launches": dict(runtime.LAUNCHES), "mesh": (mesh.data_size, mesh.model_size),
                    "rows": (mesh.data_index * DP["prompts"] // mesh.data_size,
                             (mesh.data_index + 1) * DP["prompts"] // mesh.data_size),
                    "digests": {k: digest(torch.from_numpy(np.ascontiguousarray(res[k])))
                                for k in ("mel", "linear", "wavs")}}
    if rank == 0:
        out["synth"].update({k: res[k] for k in ("mel", "linear", "wavs", "end_frames")})
    return out


def torch_launch():
    """``tests/torch_launch.py``: the ranks' launcher that the multi-process
    tests use (a ``file://`` rendezvous, a wall, every rank killed on a
    failure)."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_launch as module
    return module


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dp_cli(report, card):
    """[dp] 5: two ``cli.train`` processes on [train-cli]'s corpus
    (--coordinator 127.0.0.1:port, gloo on the one card), the per-chip batch
    x 2, --debug-sync and one checkpoint; their resume; and
    ``cli.synthesize --data-parallel`` on the run."""
    import shutil

    def run_procs(cmds, log_dir, timeout_s):
        return torch_launch().run_commands(cmds, log_dir, timeout_s, dict(os.environ, PYTHONPATH=ROOT))

    root = os.path.join(ROOT, "build", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(ROOT, "build", "chip_smoke_train", "data")
    run = os.path.join(root, "run")
    steps = DP["cli_steps"]

    def cli(module, n, *args):
        port = free_port()
        return [[sys.executable, "-m", f"tacotron_tpu_torch.cli.{module}", *args,
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                 "--process-id", str(i)] for i in range(n)]

    def lines_of(out):
        return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]

    train = ["--data-dir", data, "--run-dir", run, "--preset", "full_1chip", "--set", "model.r=5",
             "--set", "model.attention_energy=fused", "--set",
             f"train.per_chip_batch_size={DP['per_chip_batch']}", "--summary-every", "2",
             "--checkpoint-every", str(steps[0]), "--debug-sync"]
    rep = {}
    for name, n_steps in (("train", steps[0]), ("resume", steps[1])):
        t0 = time.perf_counter()
        outs, codes = run_procs(cli("train", 2, *train, "--steps", str(n_steps)),
                                os.path.join(root, name), DP["timeout_s"])
        secs = time.perf_counter() - t0
        for i, o in enumerate(outs):
            for ln in o.strip().splitlines():
                log(f"  cli.train {name} process {i}: {ln}")
        require(codes == [0, 0], f"cli.train {name}: both processes exit 0 ({codes})")
        summaries = [[ln for ln in lines_of(o) if "total_loss" in ln] for o in outs]
        require(all("torch.distributed backend gloo" in o for o in outs),
                f"cli.train {name}: both processes on gloo (two ranks on one card)")
        require(all("training step: eager (a gloo mesh" in o for o in outs),
                f"cli.train {name}: both processes say their step is eager (a gloo mesh)")
        require(all(lines_of(o)[-1] == {"done": True, "step": n_steps} for o in outs),
                f"cli.train {name}: both done at step {n_steps}")
        require(summaries[0] and [s["total_loss"] for s in summaries[0]] ==
                [s["total_loss"] for s in summaries[1]] and all(
                    np.isfinite(s["total_loss"]) for s in summaries[0]),
                f"cli.train {name}: both print the same finite global losses")
        rep[name] = {"seconds": secs, "summaries": summaries[0]}
        log(f"  cli.train {name}: {secs:.2f} s for both processes; frames_per_s "
            f"{[s['frames_per_s'] for s in summaries[0]]} (x 2 ranks) on {card}")
    with open(os.path.join(run, "config.json")) as f:
        batch = json.load(f)["train"]["batch_size"]
    require(batch == 2 * DP["per_chip_batch"], f"global batch {batch} = per-chip "
            f"{DP['per_chip_batch']} x 2 processes")
    ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
    require(ckpts == [f"step_{steps[0]}", f"step_{steps[1]}"], f"checkpoints {ckpts}")
    require("resumed from step" not in open(os.path.join(root, "train", "p1.log")).read() and
            all(f"resumed from step {steps[0]}" in open(os.path.join(root, "resume", f"p{i}.log"))
                .read() for i in range(2)), f"both processes resumed from step {steps[0]}")
    require(all("summary writer" in open(os.path.join(root, n, "p0.log")).read() and
                "summary writer" not in open(os.path.join(root, n, "p1.log")).read()
                for n in ("train", "resume")), "only process 0 writes summaries")

    out_dir = os.path.join(root, "wavs")
    # three of the corpus's own transcripts: its vocabulary has no others
    from tacotron_tpu_torch.data import ljspeech
    corpus = os.path.join(ROOT, "build", "chip_smoke_train", "corpus")
    texts = [a for _, _, t in ljspeech.read_metadata(corpus)[:3] for a in ("--text", t)]
    t0 = time.perf_counter()
    outs, codes = run_procs(cli("synthesize", 2, "--run-dir", run, "--data-dir", data,
                                "--out-dir", out_dir, *texts, "--steps", "60",
                                "--gl-iters", "30", "--data-parallel"),
                            os.path.join(root, "synth"), DP["timeout_s"])
    for i, o in enumerate(outs):
        for ln in o.strip().splitlines():
            log(f"  cli.synthesize process {i}: {ln}")
    require(codes == [0, 0], f"cli.synthesize --data-parallel: both processes exit 0 ({codes})")
    require(all("synthesis call: eager (a gloo mesh" in o for o in outs),
            "cli.synthesize --data-parallel: both processes say their call is eager (a gloo mesh)")
    res = lines_of(outs[0])[-1]
    require(res["n"] == 3 and not lines_of(outs[1]) and sorted(os.listdir(out_dir)) ==
            [f"utt_{i:03d}.wav" for i in range(3)],
            "cli.synthesize --data-parallel: process 0 wrote 3 wavs and the JSON line")
    rep["synthesize"] = {"seconds": time.perf_counter() - t0, "json": res}
    report["dp"]["cli"] = rep


# [dp] (1) and (1b): the mesh paths over a 1-rank NCCL group, graphed.
# "order": the batch shapes of the steps held bit for bit under deterministic
# algorithms (A T_out 400, B "t_out_2"): each shape's eager first step, its
# capture (and replay) and three replays in all; "turns": the timed calls
# under torch's default algorithms, G a replay of the mesh graph and E an
# eager call of the same mesh path, as [train-graph] and [synth-graph] time
# theirs; "synth_turns" adds P, a replay of the no-mesh Synthesizer's graph
DP_GRAPH = {"order": "AABBA", "t_out_2": 200, "turns": "GEGGE", "synth_turns": "GPEGPGE"}


def dp_nccl_train(rep, mesh, report):
    """(1): ``make_train_step(cfg, mesh)`` over the 1-rank NCCL group at
    [train]'s recipe (f32). (a) Under deterministic algorithms, over
    DP_GRAPH["order"] from one seeded state each: the mesh's graphed step,
    the one-process graphed step and the eager mesh step, every step's
    losses, grad norm and alignments and the states after the run bit-equal;
    K1/K2 alone on the mesh step's first energy call against their plain
    versions. (b) Under the default algorithms: a new mesh step's eager
    first step and capture, its graph's nodes (beside [train-graph]'s
    one-process graph of the same recipe and shape, when ``report`` has
    it), one replay held against an eager train_step by dp_hold, then
    replays and eager mesh steps in turns (DP_GRAPH["turns"]), the counts
    set to 0 just before and read after each replay, one replay profiled.
    -> K1/K2's launches over the timed replays and their graph nodes."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.train import create_train_state, make_train_step, train_step
    from tacotron_tpu_torch.train.step import GraphedTrainStep

    cfg = dp_train_config()
    dev = mesh.device
    n_dec = TRAIN_T_OUT // cfg.model.r
    batches = {"A": train_batch(cfg, dev), "B": train_batch(cfg, dev, t_out=DP_GRAPH["t_out_2"])}
    steps = {"mesh": make_train_step(cfg, mesh), "one": make_train_step(cfg),
             "eager": functools.partial(train_step, cfg=cfg, mesh=mesh)}
    require(isinstance(steps["mesh"], GraphedTrainStep) and mesh.capturable,
            "(1) make_train_step(cfg, mesh) over a 1-rank NCCL group is a GraphedTrainStep")
    states = {"mesh": create_train_state(cfg, seed=0, mesh=mesh),
              "one": create_train_state(cfg, seed=0),
              "eager": create_train_state(cfg, seed=0, mesh=mesh)}
    calls = []
    for i, k in enumerate(DP_GRAPH["order"]):
        fn = steps["mesh"]
        entry = fn.graphs.get(fn.shape_key(dev, *batches[k]), "new")
        kind = "eager" if isinstance(entry, str) else "capture" if entry is None else "replay"
        out = {}
        for run, step in steps.items():
            spy = first_energy_call() if i == 0 and run == "mesh" else contextlib.nullcontext()
            with spy as seen:
                states[run], m, a = step(states[run], *batches[k])
            if seen is not None:
                energy_inputs = seen
            out[run] = (m, a)
        equal = {run: all(torch.equal(out[run][0][n], v) for n, v in out["mesh"][0].items())
                 and torch.equal(out[run][1], out["mesh"][1]) for run in ("one", "eager")}
        calls.append({"shape": k, "kind": kind, "loss": float(out["mesh"][0]["total_loss"]),
                      "equal": equal})
    tensors = {run: step_tensors(st) for run, st in states.items()}
    differ = {run: [k for k, t in tensors["mesh"].items() if not torch.equal(t, tensors[run][k])]
              for run in ("one", "eager")}
    rep["compare"] = {"calls": calls, "tensors": len(tensors["mesh"]), "differ": differ}
    log(f"  (1) deterministic algorithms, {DP_GRAPH['order']}: {calls}; of "
        f"{len(tensors['mesh'])} tensors after the run, differ from the one-process graphed step "
        f"{differ['one'][:4]}, from the eager mesh step {differ['eager'][:4]}")
    require([c["kind"] for c in calls] == ["eager", "capture", "eager", "capture", "replay"],
            "(1) each shape's first step eager, its second captured, then a replay")
    require(all(all(c["equal"].values()) for c in calls) and not any(differ.values()),
            "(1) the mesh's graphed steps bit-equal to the one-process graphed step and to the "
            "eager mesh step: losses, grad norm, alignments every step; weights, gradients, "
            "Adam's state, batch statistics and the generator after the run")
    del states, tensors, steps
    rep["energy"] = e = dp_energy_check(energy_inputs)
    log(f"  (1) K1/K2 alone on the mesh step's first energy call, keys {e['shape']}, K2 cluster "
        f"{e['cluster']}: " + ", ".join(f"{k} {err:.3e} (peak {peak:.3f})"
                                        for k, (err, peak) in e["errs"].items()))
    for k, (err, peak) in e["errs"].items():
        require(err <= ENERGY_TOL * peak, f"(1) {k} on the mesh step's inputs within "
                f"{ENERGY_TOL} of its peak")
    require(e["dv_repeats"], "(1) dv bit-identical across two runs")

    # (b) torch's default algorithms: the graph that users run
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    try:
        batch = batches["A"]
        step = make_train_step(cfg, mesh)
        state = create_train_state(cfg, seed=0, mesh=mesh)
        first = []
        for _ in range(2):
            t0 = time.perf_counter()
            state, m, _ = step(state, *batch)
            float(m["total_loss"])
            first.append((time.perf_counter() - t0) * 1e3)
        entry = step.graphs[next(iter(step.graphs))]
        rep["graph"] = gr = graph_report(entry, n_dec)
        rep["first_steps_ms"] = first
        one = report.get("train_graph", {}).get("graph")
        log(f"  (1) timed: default algorithms: the eager first step {first[0]:.1f} ms, the second "
            f"(capture, instantiate, replay) {first[1]:.1f} ms; the mesh graph {gr['nodes']} nodes "
            f"({gr['kernel_nodes']} kernels, K1 {gr['k1_nodes']}, K2 {gr['k2_nodes']}, NCCL "
            f"kernels {gr['nccl_nodes']}, {gr['other_nodes']}); capture {gr['capture_s']:.3f} s, "
            f"instantiate {gr['instantiate_s']:.3f} s, pool {gr['pool_bytes'] / 2**30:.3f} GiB"
            + ("" if one is None else f"; [train-graph]'s one-process graph {one['nodes']} nodes "
               f"({one['kernel_nodes']} kernels, {one['other_nodes']})"))
        state, rep["replay_vs_eager"] = replay_vs_eager("(1) timed", step, state, cfg, batch)

        eager_fn = functools.partial(train_step, cfg=cfg, mesh=mesh)
        eager = create_train_state(cfg, seed=0, mesh=mesh)
        ms = {"G": [], "E": []}
        runtime.LAUNCHES.clear()
        launches = collections.Counter()
        for kind in DP_GRAPH["turns"]:
            counts = collections.Counter(runtime.LAUNCHES)
            t0 = time.perf_counter()
            if kind == "G":
                state, m, _ = step(state, *batch)
            else:
                eager, m, _ = eager_fn(eager, *batch)
            loss = float(m["total_loss"])
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            require(np.isfinite(loss), f"(1) timed: {kind} loss finite")
            if kind == "G":
                launches.update(runtime.LAUNCHES)
                launches.subtract(counts)
        launches = dict(+launches)
        n_g = len(ms["G"])
        require({k: v / n_g for k, v in launches.items()} == {"attn_energy_fwd": 2 * n_dec,
                                                              "attn_energy_bwd": n_dec},
                f"(1) timed: each of {n_g} replays counted {2 * n_dec} K1 and {n_dec} K2 launches")
        med, med_e = float(np.median(ms["G"])), float(np.median(ms["E"]))
        rep.update(replay_ms=ms["G"], eager_ms=ms["E"], replay_ms_median=med,
                   eager_ms_median=med_e, launches=launches,
                   train_frames_per_s=TRAIN_B * TRAIN_T_OUT / (med / 1e3))
        rep["profile"] = prof = profile_step(lambda: step(state, *batch), med)
        one_ms = report.get("train_graph", {}).get("replay_ms_median")
        log(f"  (1) timed: in turns {DP_GRAPH['turns']}: the mesh graph's replays "
            f"{[round(x, 3) for x in ms['G']]} ms (median {med:.3f}), eager mesh steps "
            f"{[round(x, 3) for x in ms['E']]} (median {med_e:.3f}); device busy "
            f"{100 * prof['busy_share_of_median_step']:.1f}% of a replay"
            + ("" if one_ms is None else f"; [train-graph]'s one-process replay median "
               f"{one_ms:.3f} ms in this run") + f"; {report['card']}")
        del state, eager, step
    finally:
        dp_deterministic()
    return launches, {"attn_energy_fwd": gr["k1_nodes"], "attn_energy_bwd": gr["k2_nodes"]}


def dp_nccl_synth(rep, mesh, card):
    """(1b): ``Synthesizer(mesh=...)`` over the 1-rank NCCL group at
    synth_gl1000 B 8 (GL 1000, the step-by-step decode: a mesh refuses the
    fused one), torch's default algorithms: the mesh Synthesizer's first
    call eager, its second capturing the model and Griffin-Lim graphs, held
    within GRAPH_SYNTH_ATOL of the no-mesh graphed call of the same seed;
    K4's nodes in each graph; the Griffin-Lim graph's waveforms bit-equal
    to K4 and the iSTFT run eagerly on the replay's own spectrogram, and K4
    held against its plain version there (check_k4_at); the mesh replays,
    the no-mesh replays and eager mesh calls in turns
    (DP_GRAPH["synth_turns"]), the counts set to 0 just before and read
    after each mesh replay; one mesh replay profiled. -> K4's launches over
    the timed mesh replays and its graph nodes."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.dsp.audio import gl_spectrum, spectrogram_magnitude, spectrum_to_wav
    from tacotron_tpu_torch.infer import Synthesizer
    from tacotron_tpu_torch.weights import split_state

    dev = mesh.device
    vocab = Vocab.build(PROMPTS)
    cfg = get_config("synth_gl1000")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    acfg, gl_iters = cfg.audio, cfg.audio.griffin_lim_iters
    texts = PROMPTS[:DP["prompts"]]
    p, bs = split_state(full_model(cfg, dev))
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    try:
        one = Synthesizer(cfg, p, bs, vocab)
        ref = [one(texts, seed=1, peak_normalize=False) for _ in range(2)][1]
        synth = Synthesizer(cfg, p, bs, vocab, mesh=mesh)
        first, outs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(synth(texts, seed=1, peak_normalize=False))
            first.append((time.perf_counter() - t0) * 1e3)
        got = outs[1]
        require([o["graphed"] for o in outs] == [False, True] and ref["graphed"],
                "(1b) the mesh Synthesizer's first call eager, its second graphed, as the "
                "no-mesh one's")
        err = {k: float(np.abs(got[k] - ref[k]).max())
               for k in ("mel", "linear", "alignments", "wavs")}
        rep["vs_one_process"] = {"max_abs_err": err, "atol": GRAPH_SYNTH_ATOL,
                                 "end_frames_equal": bool(np.array_equal(got["end_frames"],
                                                                         ref["end_frames"]))}
        log(f"  (1b) mesh synthesis, synth_gl1000, {len(texts)} prompts, replayed, against the "
            f"no-mesh graphed call of its seed: max abs err {err}; first calls "
            f"{[round(x, 1) for x in first]} ms (eager; capture, instantiate, replay)")
        require(max(err[k] for k in ("mel", "linear", "alignments")) <= GRAPH_SYNTH_ATOL
                and rep["vs_one_process"]["end_frames_equal"],
                f"(1b) mel, linear and alignments within {GRAPH_SYNTH_ATOL} of the no-mesh "
                f"graphed call, end frames equal")
        rep["graphs"] = graphs = synth_graph_report(synth)
        require(sorted(graphs) == ["gl", "model"] and graphs["gl"]["k4_nodes"] == 3 * gl_iters
                and graphs["model"]["k4_nodes"] == 0,
                f"(1b) a model graph and a Griffin-Lim graph, K4's {3 * gl_iters} nodes in the "
                f"latter ({ {k: v['k4_nodes'] for k, v in graphs.items()} })")
        lin = torch.from_numpy(got["linear"]).to(dev)
        with torch.no_grad():
            mag = spectrogram_magnitude(lin, acfg)
            wav = spectrum_to_wav(*gl_spectrum(mag, acfg, gl_iters), acfg).cpu().numpy()
        rep["gl_graph_vs_eager_k4"] = same = bool(np.array_equal(wav, got["wavs"]))
        require(same, "(1b) the Griffin-Lim graph's waveforms bit-equal to K4 and the iSTFT run "
                "eagerly on the replay's spectrogram")
        rep["griffin_lim_on_the_replay"] = check_k4_at(
            f"(1b) griffin_lim bf16 on the mesh replay's spectrogram (B {mag.shape[0]}, F "
            f"{mag.shape[1]})", mag, acfg, gl_iters)
        del lin, mag, ref

        ms = {"G": [], "P": [], "E": []}
        runtime.LAUNCHES.clear()
        launches = collections.Counter()
        for kind in DP_GRAPH["synth_turns"]:
            counts = collections.Counter(runtime.LAUNCHES)
            t0 = time.perf_counter()
            res = (one if kind == "P" else synth)(texts, seed=1, peak_normalize=False,
                                                  stage_ms=kind == "E")
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            require(res["graphed"] == (kind != "E"), f"(1b) {kind} call graphed {res['graphed']}")
            if kind == "G":
                launches.update(runtime.LAUNCHES)
                launches.subtract(counts)
        launches = dict(+launches)
        n_g = len(ms["G"])
        from tacotron_tpu_torch.ops.decode_chunk import CHUNK_MAX
        step_launches = -(-cfg.model.max_decode_steps // CHUNK_MAX)
        require({k: v / n_g for k, v in launches.items()}
                == {"griffin_lim": 3 * gl_iters, "decode_chunk": step_launches},
                f"(1b) each of {n_g} replays counted {3 * gl_iters} K4 launches and "
                f"{step_launches} of the step decode's kernel ({launches})")
        med, med_p, med_e = (float(np.median(ms[k])) for k in "GPE")
        rows = device_kernels(lambda: synth(texts, seed=1, peak_normalize=False))
        busy = sum(v[0] for v in rows.values())
        rep.update(replay_ms=ms["G"], eager_ms=ms["E"], replay_ms_median=med,
                   eager_ms_median=med_e, launches=launches, one_process_replay_ms=ms["P"],
                   one_process_replay_ms_median=med_p,
                   audio_seconds_per_s=res["audio_seconds"] / (med / 1e3),
                   eager_audio_seconds_per_s=res["audio_seconds"] / (med_e / 1e3),
                   device_busy_ms=busy, busy_share_of_median_replay=busy / med)
        log(f"  (1b) in turns {DP_GRAPH['synth_turns']}: mesh replays "
            f"{[round(x, 2) for x in ms['G']]} ms (median {med:.2f}), no-mesh replays "
            f"{[round(x, 2) for x in ms['P']]} (median {med_p:.2f}), eager mesh calls "
            f"{[round(x, 2) for x in ms['E']]} (median {med_e:.2f}); mesh audio-s/s "
            f"{rep['audio_seconds_per_s']:.2f} graphed, "
            f"{rep['eager_audio_seconds_per_s']:.2f} eager; device busy {100 * busy / med:.1f}% "
            f"of the median replay; {card}")
        del synth, one
    finally:
        dp_deterministic()
    return launches, {"griffin_lim": graphs["gl"]["k4_nodes"]}


def phase_dp_nccl(report):
    """[dp] (1) and (1b) on a 1-rank NCCL group in this process (NCCL
    refuses two ranks on one card, so one rank is the NCCL mesh one card
    holds; it runs every collective of both paths): ``dp_nccl_train`` and
    ``dp_nccl_synth``. The caller sets dp_deterministic(). -> the mesh
    graphs' launches and graph nodes of K1/K2 and K4."""
    import tempfile

    import torch.distributed as dist

    from tacotron_tpu_torch.parallel import make_mesh

    rep = report["dp"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(dp_train_config().mesh)
            require(dist.get_backend(mesh.data_group) == "nccl",
                    "the 1-rank mesh's data group is NCCL")
            train_launches, train_nodes = dp_nccl_train(rep.setdefault("world1", {}), mesh,
                                                        report)
            synth_launches, synth_nodes = dp_nccl_synth(rep.setdefault("world1_synth", {}), mesh,
                                                        rep["card"])
        finally:
            dist.destroy_process_group()
    rep["world1_s"] = time.perf_counter() - t0
    log(f"  (1), (1b) over NCCL: {rep['world1_s']:.1f} s")
    return ({**train_launches, "griffin_lim_bf16": synth_launches["griffin_lim"]},
            {**train_nodes, "griffin_lim_bf16": synth_nodes["griffin_lim"]})


def phase_dp(report):
    """[dp] the parallel layer on the one card: (1) the data-parallel step
    over a 1-rank NCCL group, graphed, against the one-process graphed step
    and the eager mesh step, bit for bit, then timed; (1b) mesh synthesis
    over that group through its two graphs against the no-mesh graphed
    call (``phase_dp_nccl``); on gloo, eager by the rule
    (``parallel.collectives.capturable``): (2) two gloo ranks of 16 rows
    each against one process on the 32, with dropout, 3 steps at full
    width; (3) the tensor-parallel step on (data 1, model 2) at tiny widths
    against one process; (4) mesh synthesis on the two ranks against one
    process; (5) the CLIs on two processes (``phase_dp_cli``). Rank 1's
    results are held bit-equal to rank 0's, and K1/K2 and K4 are held
    against their plain versions on each path's own inputs. Kernels are
    built already; the ranks only load them. -> ({kernel: launches per
    gloo rank}, {kernel: launches over the NCCL mesh graphs' timed
    replays}, {kernel: their graph nodes})."""
    from tacotron_tpu_torch.config import get_config
    from tacotron_tpu_torch.data.vocab import Vocab
    from tacotron_tpu_torch.dsp.audio import gl_spectrum, spectrogram_magnitude, spectrum_to_wav
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference, griffin_lim_spectrum
    from tacotron_tpu_torch.infer import Synthesizer
    from tacotron_tpu_torch.train import create_train_state, make_train_step
    from tacotron_tpu_torch.weights import split_state

    dev = torch.device("cuda")
    card = smi()
    rep = report["dp"] = {"card": card}
    log(f"[dp] the parallel layer on one card ({card}): 1-rank NCCL (graphed), 2 gloo ranks "
        f"(eager)")
    flags = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    dp_deterministic()
    try:
        cfg = dp_train_config()
        batch = train_batch(cfg, dev)
        nccl_launches, nccl_graph_nodes = phase_dp_nccl(report)

        # (2)-(4) on two ranks; the one-process references here
        t0 = time.perf_counter()
        ranks = torch_launch().run("chip_smoke:dp_ranks", 2, workdir=os.path.join(
            ROOT, "build", "chip_smoke_dp_ranks"), timeout_s=DP["timeout_s"], platform="cuda",
            pg_timeout_s=300, threads=4, extra_path=[ROOT])
        rep["ranks_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        require(all(not r[name]["graphed"] for r in ranks for name in ("dp", "tp", "synth"))
                and all(r["backend"] == "gloo" for r in ranks),
                "(2)-(4) two ranks on one card: gloo, so make_train_step(cfg, mesh) is the eager "
                "step and the mesh Synthesizer's calls are eager (parallel.collectives.capturable)")
        for name, what in (("dp", "(2) every step's gradients, updated parameters and batch "
                                  "statistics"),
                           ("tp", "(3) the step's gradients, updated parameters (full) and batch "
                                  "statistics"),
                           ("synth", "(4) the gathered mel, linear and waveforms")):
            require(ranks[1][name]["digests"] == r0[name]["digests"],
                    f"{what} of rank 1 bit-equal to rank 0's")
        for name, n in (("dp", 2), ("tp", 3)):
            for r in ranks:
                e = r[name]["energy"]
                log(f"  ({n}) rank {r['rank']}: K1/K2 alone on its first energy call, keys "
                    f"{e['shape']}, K2 cluster {e['cluster']}: " + ", ".join(
                        f"{k} {err:.3e} (peak {peak:.3f})" for k, (err, peak) in e["errs"].items()))
                for k, (err, peak) in e["errs"].items():
                    require(err <= ENERGY_TOL * peak, f"({n}) rank {r['rank']} {k} at its own "
                            f"shapes within {ENERGY_TOL} of its peak")
                require(e["dv_repeats"], f"({n}) rank {r['rank']} dv bit-identical across "
                        f"two runs")
                la = r[name]["launches"]
                require(la.get("attn_energy_fwd", 0) > 0 and la.get("attn_energy_bwd", 0) > 0,
                        f"({n}) rank {r['rank']} launched K1 and K2 ({la})")
        rep["energy"] = {f"{name}_rank{r['rank']}": r[name]["energy"] for name in ("dp", "tp")
                         for r in ranks}

        # (2) each step from a common state; the uninterrupted run beside it
        _, want = dp_run(create_train_state(cfg, seed=0), make_train_step(cfg), batch,
                         DP["steps"])
        require(all(r["dp"]["mesh"] == (2, 1) for r in ranks), "(2) a (data 2, model 1) mesh")
        got = r0["dp"]["steps"]
        rep["dp2"] = []
        for i in range(DP["steps"]):
            prev = None if i == 0 else got[i - 1]
            ref = want["steps"][0] if i == 0 else dp_restart(cfg, batch, prev, got[i]["gen"])
            ref_metrics = want["metrics"][0] if i == 0 else ref["metrics"][0]
            ref = ref if i == 0 else ref["steps"][0]
            rep["dp2"].append(dp_hold(
                f"(2) 2 ranks x 16 rows vs 1 process x 32, dropout 0.5, step {i + 1} from "
                + ("the seeded start" if i == 0 else f"rank 0's state after step {i}"),
                {**got[i], "metrics": r0["dp"]["metrics"][i]}, {**ref, "metrics": ref_metrics},
                prev, cfg.train))
        last = DP["steps"] - 1
        apart = max(float((got[last]["stats"][k] - w).abs().max())
                    for k, w in want["steps"][last]["stats"].items())
        log(f"  (2) uninterrupted: step {last + 1} losses {r0['dp']['metrics'][last]} vs one "
            f"process's {want['metrics'][last]}; batch statistics {apart:.3e} apart (from a "
            f"common state: {rep['dp2'][last]['stat_of_tol']:.3f} of DP_STAT_TOL's tolerance)")
        for r in ranks:
            log(f"  (2) rank {r['rank']}: step ms {[round(x, 1) for x in r['dp']['ms']]} "
                f"(one process: {[round(x, 1) for x in want['ms']]}); launches "
                f"{r['dp']['launches']}; {card}")
        rep["dp2_uninterrupted_stats_apart"] = apart
        rep["dp2_ms"] = {"ranks": [r["dp"]["ms"] for r in ranks], "one": want["ms"],
                         "launches": [r["dp"]["launches"] for r in ranks]}
        del want, got

        tcfg = dp_tp_config()
        _, twant = dp_run(create_train_state(tcfg, seed=0), make_train_step(tcfg),
                          dp_tp_batch(dev), 1)
        require(all(r["tp"]["mesh"] == (1, 2) for r in ranks), "(3) a (data 1, model 2) mesh")
        require(all(r["tp"]["shards"] == {"postnet.linear_proj.weight": (130, 64),
                                          "postnet.linear_proj.bias": (130,),
                                          "encoder.embed.embedding": (16, 64)} for r in ranks),
                "(3) linear_proj (260 units) and the embedding (32 rows) half on each rank")
        rep["tp"] = dp_hold("(3) tensor-parallel (data 1, model 2) vs 1 process",
                            {**r0["tp"]["steps"][0], "metrics": r0["tp"]["metrics"][0]},
                            {**twant["steps"][0], "metrics": twant["metrics"][0]}, None,
                            tcfg.train)

        # (4) mesh synthesis
        scfg = get_config("synth_gl1000")
        vocab = Vocab.build(PROMPTS)
        scfg = dataclasses.replace(scfg, model=dataclasses.replace(scfg.model,
                                                                   vocab_size=len(vocab)))
        one_synth = Synthesizer(scfg, *split_state(full_model(scfg, dev)), vocab)
        ref = one_synth(PROMPTS[:DP["prompts"]], seed=0, gl_iters=1, peak_normalize=False)
        got = r0["synth"]
        errs = {k: float(np.abs(got[k] - ref[k]).max()) for k in ("mel", "linear")}
        log(f"  (4) mesh synthesis, synth_gl1000, {DP['prompts']} prompts over 2 ranks: mel "
            f"{errs['mel']:.3e}, linear {errs['linear']:.3e} from one process; wall ms "
            f"{[round(r['synth']['wall_ms'], 1) for r in ranks]}; {card}")
        require(max(errs.values()) <= 1e-5, "(4) mel and linear within 1e-5 of one process's "
                "Synthesizer(fused=False)")
        require(np.array_equal(got["end_frames"], ref["end_frames"]), "(4) end frames equal")
        for r in ranks:
            require(r["synth"]["launches"].get("griffin_lim", 0) > 0,
                    f"(4) rank {r['rank']} launched K4 ({r['synth']['launches']})")
        # Griffin-Lim: each rank's waveforms against K4 on that rank's own
        # rows of the spectrogram, bit for bit, and K4 held on those
        # magnitudes by GL_PATH; K4 on all 8 rows at once beside them
        acfg = scfg.audio
        kw = dict(momentum=acfg.gl_momentum, **gl_kw(acfg))
        lin = torch.from_numpy(got["linear"]).to(dev)
        rep["synth"] = {"errs": errs, "launches": [r["synth"]["launches"] for r in ranks],
                        "wall_ms": [r["synth"]["wall_ms"] for r in ranks]}
        with torch.no_grad():
            mag_all = spectrogram_magnitude(lin, acfg)
            spec_all = gl_spectrum(mag_all, acfg, acfg.griffin_lim_iters)
            wav_all = spectrum_to_wav(*spec_all, acfg).cpu().numpy()
        for r in ranks:
            lo, hi = r["synth"]["rows"]
            with torch.no_grad():
                mag = spectrogram_magnitude(lin[lo:hi], acfg)
                spec = gl_spectrum(mag, acfg, acfg.griffin_lim_iters)
                wav = spectrum_to_wav(*spec, acfg).cpu().numpy()
                # the 4-row iSTFT of the 8-row launch's spectrum
                wav_mixed = spectrum_to_wav(spec_all[0][lo:hi], spec_all[1][lo:hi],
                                            acfg).cpu().numpy()
            same = {"wav_vs_own_rows": bool(np.array_equal(wav, got["wavs"][lo:hi])),
                    "k4_rows_vs_8row_launch": bool(torch.equal(spec[0], spec_all[0][lo:hi])
                                                   and torch.equal(spec[1], spec_all[1][lo:hi])),
                    "istft_rows_vs_8row_istft": bool(np.array_equal(wav_mixed,
                                                                    wav_all[lo:hi])),
                    "wav_vs_8row_launch": bool(np.array_equal(wav_all[lo:hi],
                                                              got["wavs"][lo:hi]))}
            log(f"  (4) rank {r['rank']} (rows {lo}-{hi - 1}): bit-equal: {same}")
            require(same["wav_vs_own_rows"], f"(4) rank {r['rank']}'s waveforms bit-equal to "
                    f"K4 and the iSTFT on its own rows {lo}-{hi - 1}, run here")
            rep["synth"][f"rank{r['rank']}"] = same
            rep["synth"][f"rank{r['rank']}"]["gl_path"] = check_gl_path(
                f"(4) rank {r['rank']} griffin_lim bf16 on its rows {lo}-{hi - 1}", mag, acfg,
                lambda n: griffin_lim_spectrum(mag, n_iter=n, **kw),
                lambda n: gl_spectrum_reference(mag, n_iter=n, **kw), acfg.griffin_lim_iters,
                at_depth=(spec, gl_spectrum_reference(mag, n_iter=acfg.griffin_lim_iters, **kw)))
        del one_synth, ref, got, lin, mag_all, spec_all
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])
    phase_dp_cli(report, card)
    return ({"attn_energy_fwd": [r["dp"]["launches"].get("attn_energy_fwd", 0) for r in ranks],
             "attn_energy_bwd": [r["dp"]["launches"].get("attn_energy_bwd", 0) for r in ranks],
             "griffin_lim_bf16": [r["synth"]["launches"].get("griffin_lim", 0) for r in ranks]},
            nccl_launches, nccl_graph_nodes)


# [tooling]: the live capture's run, the TF1-converted synthesis's Griffin-Lim
# iterations (GL 100 keeps the phase short; [main] runs 1000), and the
# capture's steps, asked for once the run has done ``capture_after`` steps
TOOLING = {"cli_steps": 8, "capture_after": 2, "capture_steps": 2, "gl_iters": 100}
# enable_compilation_cache in a child process: build every kernel and the
# native assembler in argv[2], or find them there, counting the compilers
# started; argv[1] is the checkout's root
CACHE_CHILD = """
import json, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.native import binding
from tacotron_tpu_torch.utils import profiling
profiling.enable_compilation_cache(sys.argv[2])
started, popen = [], subprocess.Popen
class Counted(popen):
    def __init__(self, args, *a, **k):
        started.append(str(args[0]))
        super().__init__(args, *a, **k)
subprocess.Popen = Counted
d = runtime.BUILD_DIR
before = sorted(p.name for p in d.glob("*.so"))
t0 = time.perf_counter()
runtime.build()
binding.build()
for name in runtime.KERNEL_SOURCES:
    runtime.load(name)
binding.load_batcher()
print(json.dumps({"dir": str(d), "before": before, "after": sorted(p.name for p in d.glob("*.so")),
                  "started": started, "seconds": time.perf_counter() - t0}))
"""


def tf1_names(params, batch_stats):
    """Flax-layout trees renamed to TF1 names as
    ``tests/unit/test_tf1_converter.py::_tf1_names`` renames them, but with
    the three-cell decoder convention: multi_rnn_cell/cell_0 is the
    attention GRU, cell_1 and cell_2 the residual GRUs."""
    def node(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return tree

    def g(tree, path):
        return np.asarray(node(tree, path))

    tf, P = {}, "model/inference"
    tf[f"{P}/embedding"] = g(params, "encoder/embed/embedding")
    for i in range(2):
        sfx = "" if i == 0 else f"_{i}"
        for leaf in ("kernel", "bias"):
            tf[f"{P}/prenet/dense{sfx}/{leaf}"] = g(params, f"encoder/prenet/fc{i}/{leaf}")
            tf[f"{P}/decoder/prenet/dense{sfx}/{leaf}"] = \
                g(params, f"decoder/cell/prenet/fc{i}/{leaf}")
    bn = {"gamma": (params, "scale"), "beta": (params, "bias"),
          "moving_mean": (batch_stats, "mean"), "moving_variance": (batch_stats, "var")}
    for scope, ours in (("encoder_cbhg", "encoder/cbhg"), ("post_cbhg", "postnet/cbhg")):
        for k in sorted(int(k[4:]) for k in node(params, f"{ours}/bank") if k.startswith("conv")):
            base = f"{P}/{scope}/conv1d_banks/num_{k}"
            tf[f"{base}/conv1d/kernel"] = g(params, f"{ours}/bank/conv{k}/kernel")
            for field, (tree, leaf) in bn.items():
                tf[f"{base}/batch_normalization/{field}"] = g(tree, f"{ours}/bank/bn{k}/bn/{leaf}")
        for i in range(sum(1 for k in node(params, f"{ours}/proj") if k.startswith("proj"))):
            tf[f"{P}/{scope}/conv1d_proj_{i}/conv1d/kernel"] = g(params, f"{ours}/proj/proj{i}/kernel")
            for field, (tree, leaf) in bn.items():
                tf[f"{P}/{scope}/conv1d_proj_{i}/batch_normalization/{field}"] = \
                    g(tree, f"{ours}/proj/bn{i}/bn/{leaf}")
        hw = node(params, f"{ours}/highway")
        for i in range(sum(1 for k in hw if k.startswith("H"))):
            for leaf in ("kernel", "bias"):
                tf[f"{P}/{scope}/highwaynet_{i}/dense/{leaf}"] = g(hw, f"H{i}/{leaf}")
                tf[f"{P}/{scope}/highwaynet_{i}/dense_1/{leaf}"] = g(hw, f"T{i}/{leaf}")
        if "resize" in hw:
            for leaf in ("kernel", "bias"):
                tf[f"{P}/{scope}/highway_resize/{leaf}"] = g(hw, f"resize/{leaf}")
        # biGRU: our hoisted split fused back into TF's [x, h] layout
        for d, tfd in (("fwd", "fw"), ("bwd", "bw")):
            base = f"{P}/{scope}/bidirectional_rnn/{tfd}/gru_cell"
            for part, ours_part in (("gates", "gates"), ("candidate", "cand")):
                tf[f"{base}/{part}/kernel"] = np.concatenate(
                    [g(params, f"{ours}/bigru/{d}/{ours_part}_x/kernel"),
                     g(params, f"{ours}/bigru/{d}/{ours_part}_h/kernel")], axis=0)
                tf[f"{base}/{part}/bias"] = g(params, f"{ours}/bigru/{d}/{ours_part}_x/bias")
    tf[f"{P}/memory_layer/kernel"] = g(params, "memory_proj/kernel")
    tf[f"{P}/decoder/bahdanau_attention/query_layer/kernel"] = \
        g(params, "decoder/cell/attention/query/kernel")
    tf[f"{P}/decoder/bahdanau_attention/attention_v"] = \
        g(params, "decoder/cell/attention/v").reshape(-1)
    for i, cell in enumerate(("attention_gru", "decoder_gru0", "decoder_gru1")):
        for part in ("gates", "candidate"):
            for leaf in ("kernel", "bias"):
                tf[f"{P}/decoder/multi_rnn_cell/cell_{i}/gru_cell/{part}/{leaf}"] = \
                    g(params, f"decoder/cell/{cell}/{part}/{leaf}")
    for leaf in ("kernel", "bias"):
        tf[f"{P}/decoder/output_projection_wrapper/{leaf}"] = \
            g(params, f"decoder/cell/decoder_input_proj/{leaf}")
        # generic denses, resolved by shape: the frame and the linear projection
        tf[f"{P}/decoder/dense/{leaf}"] = g(params, f"decoder/cell/frame_proj/{leaf}")
        tf[f"{P}/dense_2/{leaf}"] = g(params, f"postnet/linear_proj/{leaf}")
    return tf


def http_get(port, path, timeout=600):
    """-> (HTTP status, JSON reply) of GET 127.0.0.1:port/path."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def tooling_roofline(report):
    """(a) the whole-step shares that [train], [train-bf16] and [main]
    printed, gathered; K4/K5's bound count beside ``gl_iteration_flops``."""
    from tacotron_tpu_torch.dsp.dft import live_span
    from tacotron_tpu_torch.utils.roofline import gl_iteration_flops
    card = report["card"]
    for key, tag in (("train", "[train]"), ("train_bf16", "[train-bf16]")):
        r = report[key]["roofline"]
        log(f"  (a) {tag}: {r['train_step_flops'] / 1e9:.1f} GFLOP a step; median step "
            f"{r['tflops']:.4f} TFLOP/s, mfu {r['mfu']:.3e}; device-busy "
            f"{r['tflops_device_busy']:.3f} TFLOP/s, mfu_device_busy {r['mfu_device_busy']:.3e}; "
            f"against {r['peak']}; {card}")
    r = report["main"]["roofline"]
    log(f"  (a) [main]: {r['tflops']:.3f} TFLOP/s, mfu {r['mfu']:.3e} against {r['peak']}; {card}")
    b, f, n_fft, win = len(PROMPTS), 1000, 2048, 1102
    exact = 2 * 2 * b * f * win * 2 * (n_fft // 2 + 1)
    lo, hi = live_span(n_fft, win)
    aligned = gl_iteration_flops(b, f, n_fft, win)
    log(f"  (a) a Griffin-Lim iteration at B {b}, F {f}: {exact / 1e9:.2f} GFLOP over the exact "
        f"window ({win} samples; the K4/K5 bound) against gl_iteration_flops' "
        f"{aligned / 1e9:.2f} GFLOP over the 128-aligned live span [{lo}, {hi}) ({hi - lo})")
    require(aligned == exact * (hi - lo) / win, "gl_iteration_flops scales the exact count by "
            "the live span over the window")
    return {"gl_iteration_exact_flops": exact, "gl_iteration_flops": aligned}


def tooling_tf1(cfg, vocab):
    """(b) seeded weights at synth_gl1000 widths named as a TF1 checkpoint
    names them (``tf1_names``), converted onto another seed's trees and
    loaded through ``from_flax``; ``Synthesizer(fused=True)`` on [main]'s 8
    prompts at GL ``TOOLING["gl_iters"]`` from them, its launch counts set
    to 0 just before, against the same weights loaded directly; then K3 and
    K4 bf16 held against their plain versions on these inputs. -> (the
    results, the converted synthesizer, the call's launches)."""
    import re

    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    from tacotron_tpu_torch.utils.tf1_converter import NAME_TABLE, convert
    from tacotron_tpu_torch.weights import from_flax, split_state, to_flax

    dev = torch.device("cuda")
    n_it = TOOLING["gl_iters"]
    p0, bs0 = split_state(full_model(cfg, dev, seed=0))
    src = to_flax(p0, bs0)
    tf_vars = tf1_names(src["params"], src["batch_stats"])
    target = to_flax(*split_state(full_model(cfg, dev, seed=1)))
    t0 = time.perf_counter()
    out = convert(tf_vars, target["params"], target["batch_stats"])
    conv_s = time.perf_counter() - t0
    hit = {i for name in tf_vars for i, (pat, _) in enumerate(NAME_TABLE)
           if re.match(pat, name)}
    missed = [NAME_TABLE[i][0] for i in range(len(NAME_TABLE)) if i not in hit]
    log(f"  (b) {len(tf_vars)} TF1 names ({sum(a.size for a in tf_vars.values())} values) "
        f"converted in {conv_s:.3f} s: {len(out['matched'])} matched, unmatched "
        f"{len(out['unmatched_tf'])} TF1 / {len(out['unmatched_ours'])} ours, "
        f"{len(out['errors'])} errors; {len(hit)} of {len(NAME_TABLE)} NAME_TABLE patterns hit, "
        f"not hit: {missed}")
    require(not out["errors"] and not out["unmatched_tf"] and not out["unmatched_ours"],
            "every TF1 name placed and every leaf of ours covered, no error")
    require(len(missed) == 1 and "attention_wrapper" in missed[0],
            "every NAME_TABLE pattern hit but the two-cell convention's attention_wrapper "
            "(the three-cell names place the attention GRU as cell_0)")
    p, bs = from_flax({"params": out["params"], "batch_stats": out["batch_stats"]})
    require(sorted(p) == sorted(p0) and sorted(bs) == sorted(bs0) and all(
        torch.equal(v.to(dev), p0[k]) for k, v in p.items()) and all(
        torch.equal(v.to(dev), bs0[k]) for k, v in bs.items()),
        f"the {len(p)} parameters and {len(bs)} statistics loaded from the conversion equal the "
        f"source weights bit for bit")
    direct = Synthesizer(cfg, p0, bs0, vocab, fused=True)
    synth = Synthesizer(cfg, p, bs, vocab, fused=True)
    want = direct(PROMPTS, seed=0, gl_iters=n_it)
    runtime.LAUNCHES.clear()
    t0 = time.perf_counter()
    got = synth(PROMPTS, seed=0, gl_iters=n_it)
    wall = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    log(f"  (b) Synthesizer(fused=True) from the converted weights, B {len(PROMPTS)}, GL {n_it}: "
        f"{wall:.3f} s, launches {launches}")
    require(launches.get("decode_loop") == 1 and launches.get("griffin_lim") == 3 * n_it,
            f"K3 launched once and K4 3 x {n_it} times")
    require(np.array_equal(got["mel"], want["mel"]) and np.array_equal(got["linear"], want["linear"]),
            "mel and linear bit-equal to the same weights loaded directly")
    require(bool(np.isfinite(got["wavs"]).all()) and float(np.abs(got["wavs"]).max()) > 0,
            "wavs finite with a peak > 0")
    checks = check_synth_kernels("the TF1-converted weights'", "tooling", cfg, p, bs, vocab,
                                 PROMPTS, [("fused", cfg, True)], gl_iters=n_it)
    res = {"tf1_names": len(tf_vars), "convert_s": conv_s, "patterns_not_hit": missed,
           "launches": launches, "wall_s": wall, "kernels": checks}
    return res, synth, launches


def tooling_cache(root):
    """(c) ``enable_compilation_cache`` in two child processes on one fresh
    directory: the first builds every kernel and the native assembler
    there, the second finds them and starts no compiler."""
    import shutil

    from tacotron_tpu_torch import runtime
    cache = os.path.join(root, "kernels")
    shutil.rmtree(cache, ignore_errors=True)
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", CACHE_CHILD, ROOT, cache], capture_output=True,
                           text=True, timeout=600, cwd=ROOT)
        require(p.returncode == 0, f"cache child {i} exits 0\n{p.stdout}{p.stderr}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        runs[-1]["process_s"] = time.perf_counter() - t0
        log(f"  (c) enable_compilation_cache child {i}: {len(runs[-1]['started'])} compilers "
            f"started, {len(runs[-1]['after'])} libraries in {runs[-1]['dir']}; build "
            f"{runs[-1]['seconds']:.2f} s, the process {runs[-1]['process_s']:.2f} s")
    n_libs = len(runtime.KERNEL_SOURCES) + 1        # and the native assembler
    first, second = runs
    require(first["dir"] == cache and not first["before"] and len(first["after"]) == n_libs
            and len(first["started"]) == n_libs, f"the first child built the {n_libs} libraries "
            f"in the cache directory, one compiler each")
    require(second["before"] == second["after"] == first["after"] and not second["started"],
            "the second child found them and started no compiler")
    return runs


def tooling_time(report, synth):
    """(c) ``force`` and ``time_fn`` of a [main]-shaped call (B 8, 500
    steps, GL 1000), beside this script's own timing of one call."""
    from tacotron_tpu_torch.utils.profiling import force, time_fn
    call = lambda: synth(PROMPTS, seed=1)
    t0 = time.perf_counter()
    out = call()
    own = time.perf_counter() - t0
    forced = force(out)
    per_call = time_fn(call, iters=2, warmup=1)
    rows = len(PROMPTS) * synth.cfg.model.max_decode_steps
    log(f"  (c) time_fn: {per_call * 1e3:.1f} ms a call (1 warm, 2 timed); this script's "
        f"perf_counter around one call {own * 1e3:.1f} ms; [main]'s timed call "
        f"{report['main']['wall_s'] * 1e3:.1f} ms; force(out) {forced:.4f} (the alignments: "
        f"{rows} softmax rows); {report['card']}")
    require(abs(forced / rows - 1) <= 1e-4, f"force reads the first leaf (the alignments), "
            f"{rows} rows summing to 1")
    return {"time_fn_s": per_call, "own_s": own, "force": forced}


def tooling_capture(report, root):
    """(c) ``cli.train --profile-port`` on [train-cli]'s corpus at
    full_1chip, r 5, the fused energy, f32, B 32, ``TOOLING["cli_steps"]``
    steps, the launch counts set to 0 just before: a client thread asks for
    ``capture_steps`` steps once ``capture_after`` are done, then, while the
    window is open, for another capture, which is refused. The trace's
    device events of K1 and K2 equal the captured steps' decoder steps (the
    loader's schedule replayed); the run's launches its steps'. -> (the
    results, the run's launches)."""
    import shutil
    import socket
    import threading

    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.cli import train as train_cli
    from tacotron_tpu_torch.config import Config

    c = TOOLING
    data = os.path.join(ROOT, "build", "chip_smoke_train", "data")
    require(os.path.exists(os.path.join(data, "index.json")), f"[train-cli]'s data in {data}")
    run = os.path.join(root, "run")
    shutil.rmtree(run, ignore_errors=True)
    port = free_port()
    replies = {}

    def client():
        try:
            deadline = time.time() + 900
            while time.time() < deadline:
                try:
                    st = http_get(port, "/status", timeout=10)[1]
                except OSError:
                    st = {"step": None}
                if st["step"] is not None and st["step"] >= c["capture_after"]:
                    break
                time.sleep(0.01)
            first = threading.Thread(target=lambda: replies.update(
                capture=http_get(port, f"/capture?steps={c['capture_steps']}")), daemon=True)
            first.start()
            while first.is_alive() and http_get(port, "/status")[1]["state"] != "open":
                time.sleep(0.005)
            replies["while_open"] = http_get(port, "/capture?steps=1")
            first.join(900)
        except Exception as e:      # reported by the main thread's checks
            replies["client_error"] = repr(e)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    argv = ["--data-dir", data, "--run-dir", run, "--preset", "full_1chip", "--set", "model.r=5",
            "--set", "model.attention_energy=fused", "--batch-size", "32", "--summary-every", "1",
            "--checkpoint-every", "1000", "--steps", str(c["cli_steps"]),
            "--profile-port", str(port)]
    log(f"  (c) cli.train {' '.join(argv)}")
    runtime.LAUNCHES.clear()
    lines, secs = run_cli(train_cli.main, argv)
    launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
    t.join(60)
    for ln in lines:
        log(f"  (c) cli.train: {ln}")
    require(not t.is_alive() and "client_error" not in replies, f"the client finished "
            f"({replies.get('client_error')})")
    require(json.loads(lines[-1]) == {"done": True, "step": c["cli_steps"]},
            f"the run exits normally at step {c['cli_steps']} ({secs:.2f} s in the process)")
    with socket.socket() as s:
        require(s.connect_ex(("127.0.0.1", port)) != 0, f"nothing listens on {port} after the run")
    code, reply = replies["capture"]
    log(f"  (c) capture reply {code}: {reply}; the request while the window was open: "
        f"{replies['while_open']}")
    # the reply names the Chrome trace and, since the stage clock, its records beside it
    traces = [f for f in reply.get("files", []) if f.endswith(".pt.trace.json")]
    require(code == 200 and reply["trace_dir"] == os.path.join(run, "trace")
            and len(traces) == 1 and len(reply["files"]) == 2
            and sum(f.endswith(".tt_records.json") for f in reply["files"]) == 1,
            "the capture's reply names its trace and the stage clock's records")
    first, last = reply["steps"]
    require(last - first + 1 == c["capture_steps"] and first > c["capture_after"],
            f"the capture spans {c['capture_steps']} steps after step {c['capture_after']} "
            f"({first}-{last})")
    require(replies["while_open"][0] == 409, "a request while the window is open is refused")
    cfg = Config.from_json(open(os.path.join(run, "config.json")).read())
    require(cfg.model.tf_decoder == "scan" and not cfg.model.remat_decoder,
            "scan decoder, no remat: one K1 and one K2 per decoder step")
    n_dec = loader_schedule(data, cfg, c["cli_steps"])
    want = {"attn_energy_fwd": sum(n_dec), "attn_energy_bwd": sum(n_dec)}
    require(launches == want, f"the run's launches {launches} = its decoder steps {n_dec}")
    t0 = time.perf_counter()
    with open(os.path.join(reply["trace_dir"], traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    found = {k: [e for e in kern if k in e["name"]] for k in ("energy_fwd", "energy_bwd")}
    in_window = sum(n_dec[first - 1:last])
    log(f"  (c) the trace: {os.path.getsize(os.path.join(reply['trace_dir'], traces[0]))} "
        f"bytes, {len(events)} events ({time.perf_counter() - t0:.2f} s to read), {len(kern)} "
        f"device kernels; energy_fwd {len(found['energy_fwd'])}, energy_bwd "
        f"{len(found['energy_bwd'])}, {sum(e['dur'] for e in found['energy_fwd']):.1f} / "
        f"{sum(e['dur'] for e in found['energy_bwd']):.1f} us; the captured steps' decoder steps "
        f"{n_dec[first - 1:last]}")
    require(all(len(v) == in_window and all("<float, true>" in e["name"] for e in v)
                for v in found.values()), f"the trace holds {in_window} f32 K1 and {in_window} "
            f"K2 device events, one per decoder step of steps {first}-{last}")
    return ({"seconds_in_process": secs, "reply": reply, "while_open": replies["while_open"],
             "launches": launches, "decoder_steps": n_dec, "trace_events": len(events),
             "kernel_events": {k: len(v) for k, v in found.items()}}, launches)


def phase_tooling(report, cfg, vocab):
    """[tooling] the port's utils on the card: (a) the roofline's whole-step
    shares, (b) TF1-named weights converted into a synthesis through K3 and
    K4 bf16, (c) the compilation cache, ``force`` / ``time_fn``, and a live
    capture of ``cli.train`` through K1/K2. -> each kernel's launches."""
    log("[tooling] utils/roofline, utils/tf1_converter and utils/profiling on the card")
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_tooling")
    rep = report["tooling"] = {"card": report["card"]}
    rep["roofline"] = tooling_roofline(report)
    rep["tf1"], synth, synth_launches = tooling_tf1(cfg, vocab)
    rep["time_fn"] = tooling_time(report, synth)
    del synth
    rep["cache"] = tooling_cache(root)
    rep["capture"], train_launches = tooling_capture(report, root)
    rep["seconds"] = time.perf_counter() - t0
    log(f"  [tooling] {rep['seconds']:.1f} s")
    return {"decode_loop": synth_launches["decode_loop"],
            "griffin_lim_bf16": synth_launches["griffin_lim"],
            "attn_energy_fwd": train_launches["attn_energy_fwd"],
            "attn_energy_bwd": train_launches["attn_energy_bwd"]}


# [evidence]: both evidence runners at the flagship recipe's widths, short
EVIDENCE = {"n_utts": 64, "steps": (40, 20), "save_every": 30, "prompts": 2, "gl_iters": 100,
            "char_sec": 0.06, "jitter": 0.3, "text_len": 20, "batch": 32}


@contextlib.contextmanager
def gl_calls():
    """A list that receives (magnitude, keyword arguments) of every K4 call
    (``fused_gl._gl_cuda``) while the context is open; the calls run."""
    from tacotron_tpu_torch.dsp import fused_gl
    seen, inner = [], fused_gl._gl_cuda

    def spy(magnitude, **kw):
        seen.append((magnitude.detach().clone(), kw))
        return inner(magnitude, **kw)

    fused_gl._gl_cuda = spy
    try:
        yield seen
    finally:
        fused_gl._gl_cuda = inner


def phase_evidence(report):
    """[evidence] ``cli.alignment_run`` at the flagship recipe (full_1chip,
    r 5, char_sec 0.06 with jitter 0.3, text length 20, B 32) on 64
    utterances: 40 steps with a save at 30, then a resume from the run
    directory for 20 more, through the graphed step (each run: one eager
    step, one capturing, replays); then ``cli.audio_evidence`` on 2 held-out
    prompts at GL 100 from the run directory, its K4 launches (LAUNCHES)
    equal to the kernel nodes of its Griffin-Lim call captured again, and
    K4 on that call's magnitudes and arguments against its plain version
    (``check_k4_at``). -> each kernel's launches."""
    import shutil

    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.cli import alignment_run, audio_evidence
    from tacotron_tpu_torch.config import Config
    from tacotron_tpu_torch.dsp import fused_gl
    from tacotron_tpu_torch.dsp.fused_gl import gl_spectrum_reference
    from tacotron_tpu_torch.train import checkpoint
    from tacotron_tpu_torch.utils.metrics import alignment_scores

    c = EVIDENCE
    t_phase = time.perf_counter()
    log(f"[evidence] cli.alignment_run at full_1chip, r 5, {c['n_utts']} utterances, "
        f"{c['steps'][0]} + {c['steps'][1]} graphed steps (a resume), then "
        f"cli.audio_evidence on {c['prompts']} held-out prompts at GL {c['gl_iters']}")
    root = os.path.join(ROOT, "build", "chip_smoke_evidence")
    shutil.rmtree(root, ignore_errors=True)
    out, run = os.path.join(root, "align"), os.path.join(root, "align_work", "run")
    common = ["--preset", "full_1chip", "--set", "model.r=5", "--n-utts", str(c["n_utts"]),
              "--char-sec", str(c["char_sec"]), "--char-sec-jitter", str(c["jitter"]),
              "--text-len", str(c["text_len"]), "--batch-size", str(c["batch"]),
              "--save-every", str(c["save_every"]), "--log-every", "10", "--out", out,
              "--save-run", run]
    rep = report["evidence"] = {"card": report["card"]}
    train_s, replays, replay_s = 0.0, 0, 0.0
    for i, n in enumerate(c["steps"]):
        runtime.LAUNCHES.clear()
        with graphed_steps() as made:
            lines, secs = run_cli(alignment_run.main, [
                *common, "--steps", str(n), *(["--resume-from", run] if i else [])])
        require(len(made) == 1, f"run {i}: one graphed step")
        fn, calls = made[0]
        for c_ in calls:
            c_["events"][1].synchronize()
            c_["s"] = c_["events"][0].elapsed_time(c_.pop("events")[1]) / 1e3
        kinds = [c_["kind"] for c_ in calls]
        require(kinds == ["eager", "capture"] + ["replay"] * (n - 2),
                f"run {i}: {n} steps, the first eager, the second capturing, "
                f"{kinds.count('replay')} replays of one graph")
        require(not runtime.LAUNCHES, f"run {i}: no hand kernel on the path (attention_energy "
                f"xla): {dict(runtime.LAUNCHES)}")
        if i:
            start = c["steps"][0]
            require(any(ln == f"resumed from {run} at step {start}" for ln in lines),
                    f"run {i} resumed at step {start}")
        replays += kinds.count("replay")
        replay_s += sum(c_["s"] for c_ in calls if c_["kind"] == "replay")
        train_s += secs
        for ln in lines:
            if ln.startswith("step") or ln.startswith("{"):
                log(f"  run {i}: {ln}")
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    total = sum(c["steps"])
    require(summary["steps"] == total and checkpoint.all_steps(os.path.join(run, "ckpt"))
            == [c["save_every"], c["steps"][0], total],
            f"summary at step {total}; checkpoints at {c['save_every']}, {c['steps'][0]} and "
            f"{total}")
    require(summary["backend"] == torch.cuda.get_device_name(0) and "eval_fwd" in summary["scoring"],
            f"summary backend {summary['backend']}, scoring by eval_fwd")
    al = np.load(os.path.join(out, "final_alignments.npy"))
    diag = float(np.mean([alignment_scores(al[j], summary["text_lens"][j],
                                           summary["frame_steps"][j])["diag_corr"]
                          for j in range(len(al))]))
    require(abs(diag - summary["diag_corr_mean"]) <= 1e-6 and all(
        np.isfinite([r["total_loss"] for r in summary["curve"]])),
            f"the saved alignments re-score to the summary ({diag:.4f}); losses finite")

    runtime.LAUNCHES.clear()
    with gl_calls() as seen:
        lines, audio_s = run_cli(audio_evidence.main, [
            "--run-dir", run, "--data-dir", os.path.join(root, "align_work", "data"),
            "--out", os.path.join(root, "audio"), "--n-prompts", str(c["prompts"]),
            "--char-sec", str(c["char_sec"]), "--gl-iters", str(c["gl_iters"]),
            "--no-dropout"])
    launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
    for ln in lines:
        log(f"  audio: {ln}")
    with open(os.path.join(root, "audio", "summary.json")) as f:
        audio = json.load(f)
    require(len(seen) == 1 and len(audio["per_prompt"]) == c["prompts"]
            and audio["checkpoint_step"] == total, "one Griffin-Lim call, every prompt scored, "
            f"from the step-{total} checkpoint")
    mag, kw = seen[0]
    nodes = gl_graph_nodes(lambda: fused_gl._gl_cuda(mag, **kw))
    # the fixed decode (f32, "xla" energy) runs the step decode's kernel
    from tacotron_tpu_torch.ops.decode_chunk import CHUNK_MAX
    step_launches = -(-audio["n_decode_steps"] // CHUNK_MAX)
    require(launches == {"griffin_lim": 3 * c["gl_iters"], "decode_chunk": step_launches}
            and nodes["k4"] == 3 * c["gl_iters"] and nodes["pack"] == 0,
            f"K4 bf16: LAUNCHES {launches} = {nodes['k4']} kernel nodes of its call captured "
            f"again = 3 per iteration; the step decode's kernel {step_launches} launches of up "
            f"to {CHUNK_MAX} steps")
    # K4 at the evidence STFT (n_fft 512, 257 bins) on the call's own
    # magnitudes and arguments, against its plain version; a model trained
    # 60 steps gives magnitudes like [train-cli]'s eval, so its steps are
    # held by GL_EVAL_STEP_SHARE's rule
    with open(os.path.join(run, "config.json")) as f:
        acfg = Config.from_json(f.read()).audio
    require(kw["lowp"] and kw["n_iter"] == c["gl_iters"]
            and all(kw[k] == v for k, v in gl_kw(acfg).items()),
            f"K4 bf16 called at the run's STFT ({gl_kw(acfg)}) and GL {c['gl_iters']}: {kw}")
    k4_kw = {k: v for k, v in kw.items() if k != "n_iter"}
    rep["griffin_lim_bf16"] = check_k4_at(
        f"[evidence] griffin_lim bf16 (B {mag.shape[0]}, F {mag.shape[1]}, n_fft "
        f"{acfg.n_fft})", mag, acfg, c["gl_iters"],
        kernel=lambda m, n: fused_gl._gl_cuda(m, n_iter=n, **k4_kw),
        plain=lambda m, n: gl_spectrum_reference(m, n_iter=n, **k4_kw),
        over_share=GL_EVAL_STEP_SHARE)
    seconds = time.perf_counter() - t_phase
    steps_per_s = replays / replay_s
    rep.update(train_seconds_in_process=train_s, audio_seconds_in_process=audio_s,
               replays=replays, replay_steps_per_s=steps_per_s, seconds=seconds,
               launches=launches, k4_nodes=nodes["k4"], diag_corr_mean=diag,
               k4_max_abs_err=rep["griffin_lim_bf16"]["max_abs_err"],
               final=summary["final"], char_accuracy_mean=audio["char_accuracy_mean"],
               magnitude_shape=list(mag.shape))
    log(f"  [evidence]: {steps_per_s:.2f} steps/s over {replays} replays (CUDA events), "
        f"training {train_s:.2f} s in process, audio {audio_s:.2f} s, the phase {seconds:.2f} s; "
        f"{report['card']}")
    return {"griffin_lim_bf16": launches["griffin_lim"]}


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
        kernels.append(step_decode_timing(report, fast_cfg, fast_res, vocab))
        kernels.append(t2_decode_timing(report, vocab))
        phase_lowp_convergence(report, fast_cfg.audio, mag_main)
        del mag_main, mag_fast
        graphs = {"synth_graph": phase_synth_graph(report, cfg, vocab),
                  "fast_graph": phase_fast_graph(report, vocab, fast_cfg)}
        state, batch, train_launches = phase_train(report)
        graph = phase_train_graph(report)
        kernels = phase_train_timing(report, state, batch, train_launches, graph) + kernels
        del state
        phase_train_save_attn(report)
        state, batch, train_launches = phase_train(report, "bfloat16")
        graph = phase_train_graph(report, "bfloat16")
        kernels = (kernels[:2] + phase_train_timing(report, state, batch, train_launches, graph)
                   + kernels[2:])
        del state
        phase_main_bf16(report, cfg, vocab, mel_main)
        phase_cli(report, cfg, vocab)
        cli_launches = phase_train_cli(report)
        dp_launches, dp_graph_launches, dp_graph_nodes = phase_dp(report)
        tooling_launches = phase_tooling(report, cfg, vocab)
        evidence_launches = phase_evidence(report)
        for k in kernels:
            require(k["launches"] > 0, f"{k['name']} launched on its path ({k['launches']})")
            counted = {"decode_loop": "decode_loop", "griffin_lim_bf16": "griffin_lim",
                       "decode_chunk": "decode_chunk"}
            for tag, g in graphs.items():
                if g["launches"].get(counted.get(k["name"])):
                    k[f"{tag}_launches"] = g["launches"][counted[k["name"]]]
                    k[f"{tag}_nodes"] = g["graph_nodes"][counted[k["name"]]]
            if k["name"] in cli_launches:
                k["train_cli_launches"] = cli_launches[k["name"]]
                require(k["train_cli_launches"] > 0, f"{k['name']} launched on [train-cli]'s "
                        f"path ({k['train_cli_launches']})")
            if k["name"] in dp_launches:
                k["dp_launches"] = dp_launches[k["name"]]
                require(all(n > 0 for n in k["dp_launches"]), f"{k['name']} launched on every "
                        f"rank of [dp] ({k['dp_launches']})")
            if k["name"] in dp_graph_launches:
                k["dp_nccl_graph_launches"] = dp_graph_launches[k["name"]]
                k["dp_nccl_graph_nodes"] = dp_graph_nodes[k["name"]]
                require(k["dp_nccl_graph_launches"] > 0 and k["dp_nccl_graph_nodes"] > 0,
                        f"{k['name']} launched from the NCCL mesh graphs of [dp] "
                        f"({k['dp_nccl_graph_launches']}, {k['dp_nccl_graph_nodes']} nodes)")
            if k["name"] in tooling_launches:
                k["tooling_launches"] = tooling_launches[k["name"]]
                require(k["tooling_launches"] > 0, f"{k['name']} launched on [tooling]'s path "
                        f"({k['tooling_launches']})")
            if k["name"] in evidence_launches:
                k["evidence_launches"] = evidence_launches[k["name"]]
                k["evidence_max_abs_err"] = report["evidence"]["k4_max_abs_err"]
                require(k["evidence_launches"] > 0, f"{k['name']} launched on [evidence]'s path "
                        f"({k['evidence_launches']})")
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
