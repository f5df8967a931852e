"""How exact the f32 Griffin-Lim kernels' split TF32 products are, and what
exactness costs. Needs one NVIDIA H100 (sm_90a) and nvcc:

    python3 scripts/gl_tf32_precision.py [--out gl_tf32_precision.json]

Builds variants of ``tacotron_tpu_torch/csrc/griffin_lim.cu`` by changing
its two f32-mode constants, the TF32 pieces of each operand, and the pairs
of pieces (i, j) whose products it takes (each its own nvcc, started
together), named by pieces of the spectrum side and of the basis and by
products: ``committed`` (3 and 2, i + j <= 2: five products),
``a3_b2_four`` (3 and 2 without small.small (1, 1): four), ``a2_b2_four``
(2 and 2, i + j <= 2, small.small included: four), ``a2_b2_three`` (the
classic big/small split, big.big + big.small + small.big: three) and
``a3_b3_six`` (3 and 3, i + j <= 2: six) and ``a1_b1_one`` (one TF32 pass of
each operand, the control that is no f32 product). Each variant's pieces are passed
to the host side, which splits the bases (``fused_gl.TF32_PIECES``, set
here for each variant's calls). For each, on three magnitudes
(synth_gl1000's spectrogram from a
model with seeded random weights, B 8 x F 1000, as chip_smoke.py [main]
makes it; a speech-like one, B 8 x F 1000; a synthetic one at its floor,
B 8 x F 64): one K5 f32 step from the plain f32 loop's own state at depths
0, 1, 2, 4 and 9, its largest component error over the magnitude's peak
against the plain step (``gl_step_reference``, f32 sums) and against the
same step summed in f64, beside the plain step's own error. Then 1000 K4
f32 iterations on [main]'s magnitudes (momentum 0), the waveform error over
its peak against the plain f32 loop (chip_smoke.py's MAIN_TOL check) and
against the loop with f64 sums, beside the plain f32 loop's own; and each
variant's device time per iteration by launch (torch.profiler, 30
iterations on the speech-like magnitude).
"""
import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from tacotron_tpu_torch import runtime  # noqa: E402
from tacotron_tpu_torch.config import get_config  # noqa: E402
from tacotron_tpu_torch.data.vocab import Vocab  # noqa: E402
from tacotron_tpu_torch.dsp import fused_gl  # noqa: E402
from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude  # noqa: E402
from tacotron_tpu_torch.dsp.fused_gl import (f64_matmul, gl_spectrum_reference,  # noqa: E402
                                             gl_step_reference, griffin_lim_spectrum,
                                             griffin_lim_step, zero_phase)
from tacotron_tpu_torch.infer.synthesize import Synthesizer  # noqa: E402
from tacotron_tpu_torch.weights import split_state  # noqa: E402

PIECES_A = "constexpr int kPiecesA = 3;"
PIECES_B = "constexpr int kPiecesB = 2;"
PAIRS = "if (j < 0 || j >= PB) continue;"
NO_SMALL_SMALL = (PAIRS, "if (j < 0 || j >= PB || (i == 1 && j == 1)) continue;")
# name -> ((pieces of A, pieces of B), TF32 products per f32 product, edits)
VARIANTS = {
    "committed": ((3, 2), 5, []),
    "a3_b2_four": ((3, 2), 4, [NO_SMALL_SMALL]),
    "a2_b2_four": ((2, 2), 4, [(PIECES_A, "constexpr int kPiecesA = 2;")]),
    "a2_b2_three": ((2, 2), 3, [(PIECES_A, "constexpr int kPiecesA = 2;"), NO_SMALL_SMALL]),
    "a3_b3_six": ((3, 3), 6, [(PIECES_B, "constexpr int kPiecesB = 3;")]),
    "a1_b1_one": ((1, 1), 1, [(PIECES_A, "constexpr int kPiecesA = 1;"),
                              (PIECES_B, "constexpr int kPiecesB = 1;")]),
}
DEPTHS = (0, 1, 2, 4, 9)
ITERS = 1000


def build_variants():
    src = (runtime.CSRC_DIR / "griffin_lim.cu").read_text()
    out_dir = runtime.BUILD_DIR / "gl_tf32_precision"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, _, edits) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in griffin_lim.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, "-I", str(runtime.CSRC_DIR), "-o", str(so),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs, ptxas = {}, {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
        ptxas[name] = [k for k in cs.ptxas_report(log) if "float" in k["kernel"]]
        libs[name] = ctypes.CDLL(str(so))
    return libs, ptxas


PIECES = fused_gl.TF32_PIECES


def use(name, lib):
    """Route the f32 kernels' calls to variant ``name``'s library, with the
    bases split into its pieces."""
    runtime._LIBS["griffin_lim"] = lib
    fused_gl.TF32_PIECES = VARIANTS[name][0]


def magnitudes(dev):
    cfg = get_config("synth_gl1000")
    vocab = Vocab.build(cs.PROMPTS)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    p, bs = split_state(cs.full_model(cfg, dev))
    linear = Synthesizer(cfg, p, bs, vocab, fused=True)(cs.PROMPTS, seed=1, gl_iters=1)["linear"]
    floor = 0.11 * torch.rand(8, 64, 1025, generator=torch.Generator().manual_seed(3))
    return {"main_b8_f1000": spectrogram_magnitude(torch.from_numpy(linear).to(dev), cfg.audio),
            "speech_b8_f1000": cs.sample_magnitude(8, 1000, cfg.audio, dev, seed=6),
            "floor_b8_f64": spectrogram_magnitude(floor.to(dev), cfg.audio)}, cfg.audio


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {"card": cs.smi(), "variants": {n: {"pieces": v[0], "products": v[1]}
                                              for n, v in VARIANTS.items()},
              "steps": {}, "depth": {}, "timing": {}}
    print(report["card"], flush=True)
    libs, report["ptxas"] = build_variants()
    for name, rows in report["ptxas"].items():
        for k in rows:
            print(f"  {name}: {k}", flush=True)
    with torch.no_grad():
        mags, acfg = magnitudes(dev)
        kw = dict(lowp=False, **cs.gl_kw(acfg))
        for mname, mag in mags.items():
            peak, states = float(mag.max()), []
            re, im = zero_phase(mag, False)
            for d in range(max(DEPTHS) + 1):
                if d in DEPTHS:
                    states.append((re, im))
                re, im = gl_step_reference(re, im, mag, **kw)
            err = lambda a, b: max(cs.max_err(x, y) for x, y in zip(a, b)) / peak
            row = {"plain_vs_f64": 0.0, **{n: {"vs_plain": 0.0, "vs_f64": 0.0} for n in libs}}
            for re, im in states:
                plain = gl_step_reference(re, im, mag, **kw)
                exact = gl_step_reference(re, im, mag, product=f64_matmul, **kw)
                row["plain_vs_f64"] = max(row["plain_vs_f64"], err(plain, exact))
                for name, lib in libs.items():
                    use(name, lib)
                    got = griffin_lim_step(re, im, mag, **kw)
                    row[name]["vs_plain"] = max(row[name]["vs_plain"], err(got, plain))
                    row[name]["vs_f64"] = max(row[name]["vs_f64"], err(got, exact))
            report["steps"][mname] = row
            print(f"{mname}, largest over depths {DEPTHS}: plain vs f64 "
                  f"{row['plain_vs_f64']:.3e}; " + "; ".join(
                      f"{n} vs plain {row[n]['vs_plain']:.3e}, vs f64 {row[n]['vs_f64']:.3e}"
                      for n in libs), flush=True)

        mag = mags["main_b8_f1000"]
        dkw = dict(n_iter=ITERS, **kw)
        plain = gl_spectrum_reference(mag, **dkw)
        exact = gl_spectrum_reference(mag, product=f64_matmul, **dkw)
        depth = {"plain_vs_f64": cs.gl_errors(plain, exact, mag, acfg)}
        for name, lib in libs.items():
            use(name, lib)
            got = griffin_lim_spectrum(mag, **dkw)
            depth[name] = {"vs_plain": cs.gl_errors(got, plain, mag, acfg),
                           "vs_f64": cs.gl_errors(got, exact, mag, acfg)}
        report["depth"] = depth
        print(f"[main]'s magnitudes, {ITERS} iterations, waveform error over its peak "
              f"(magnitude error of the first, of the second): plain vs f64 "
              f"{depth['plain_vs_f64']}; " + "; ".join(
                  f"{n} vs plain {depth[n]['vs_plain']}, vs f64 {depth[n]['vs_f64']}"
                  for n in libs), flush=True)

        mag, n = mags["speech_b8_f1000"], 30
        for rnd in range(2):
            for name, lib in libs.items():
                use(name, lib)
                griffin_lim_spectrum(mag, n_iter=3, **kw)
                st = cs.gl_stages(lambda: griffin_lim_spectrum(mag, n_iter=n, **kw))
                row = {k: v[0] / n * 1e3 for k, v in st.items() if v[1]}
                report["timing"][f"round {rnd} {name}"] = row
                print(f"round {rnd} {name}: K4 f32 us per iteration {sum(row.values()):.1f} ("
                      + ", ".join(f"{s} {t:.1f}" for s, t in row.items()) + ")", flush=True)
    runtime._LIBS.pop("griffin_lim", None)
    fused_gl.TF32_PIECES = PIECES
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
