"""How exactly the bf16 Griffin-Lim kernel's tensor-core products sum, and
what the synthesis product's rounded per-k-tile add costs. Needs one NVIDIA
H100 (sm_90a) and nvcc:

    python3 scripts/gl_accumulation.py [--out gl_accumulation.json]

Builds three variants of ``tacotron_tpu_torch/csrc/griffin_lim.cu`` by
changing one constant of the source (each its own nvcc, started together):
``committed`` (synthesis adds each 64-deep k-tile's tensor-core sum into its
f32 accumulator with a rounded add, analysis accumulates on the tensor
cores), ``tensor_cores_only`` (both accumulate on the tensor cores; synthesis
on the 256-row tile that serves that loop best) and ``both_rounded`` (both
products add per k-tile). For each it takes one K5 step from the plain bf16
loop's own state at depths 0, 1, 2, 4 and 9 on three magnitudes (synth_fast's
spectrogram from a model with random weights, B 8 x F 1000; a synthetic
spectrogram at its floor, B 8 x F 64; a speech-like one, B 8 x F 1000) and
prints each step's largest component error over the magnitude's peak against
the plain version (``gl_step_reference``, f32 sums) and against the same
step summed in f64 with the same bf16 roundings. Then the device time per
iteration of each launch (torch.profiler) of K4 on the speech-like magnitude
with momentum 0 and 0.99, and of K5 per call.
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
from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude  # noqa: E402
from tacotron_tpu_torch.dsp.fused_gl import (f64_matmul, gl_step_reference,  # noqa: E402
                                             griffin_lim_spectrum, griffin_lim_step,
                                             zero_phase)
from tacotron_tpu_torch.infer.synthesize import Synthesizer  # noqa: E402
from tacotron_tpu_torch.weights import split_state  # noqa: E402

PROMOTE = "constexpr bool PROMOTE = MODE == 0;"
SYN_TILE = "using SynTile = Tile<1, 1, 4>;"
VARIANTS = {"committed": [],
            "tensor_cores_only": [(PROMOTE, "constexpr bool PROMOTE = false;"),
                                  (SYN_TILE, "using SynTile = Tile<2, 1, 4>;")],
            "both_rounded": [(PROMOTE, "constexpr bool PROMOTE = true;")]}
DEPTHS = (0, 1, 2, 4, 9)


def build_variants():
    src = (runtime.CSRC_DIR / "griffin_lim.cu").read_text()
    out_dir = runtime.BUILD_DIR / "gl_accumulation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
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
        ptxas[name] = [k for k in cs.ptxas_report(log) if "gl_wgmma" in k["kernel"]]
        libs[name] = ctypes.CDLL(str(so))
    return libs, ptxas


def step_f64(re, im, mag, kw):
    """``gl_iteration(lowp=True)``'s step with both products summed in f64."""
    return gl_step_reference(re, im, mag, product=f64_matmul, **kw)


def magnitudes(dev):
    cfg = get_config("synth_fast")
    vocab = Vocab.build(cs.PROMPTS)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, vocab_size=len(vocab)))
    p, bs = split_state(cs.full_model(cfg, dev))
    linear = Synthesizer(cfg, p, bs, vocab)(cs.PROMPTS, seed=1)["linear"]
    floor = 0.11 * torch.rand(8, 64, 1025, generator=torch.Generator().manual_seed(3))
    return {"model_b8_f1000": spectrogram_magnitude(torch.from_numpy(linear).to(dev), cfg.audio),
            "floor_b8_f64": spectrogram_magnitude(floor.to(dev), cfg.audio),
            "speech_b8_f1000": cs.sample_magnitude(8, 1000, cfg.audio, dev, seed=6)}, cfg.audio


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    report = {"card": cs.smi(), "errors": {}, "timing": {}}
    print(report["card"], flush=True)
    libs, report["ptxas"] = build_variants()
    for name, rows in report["ptxas"].items():
        for k in rows:
            print(f"  {name}: {k}", flush=True)
    runtime._LIBS["griffin_lim"] = libs["committed"]
    with torch.no_grad():
        mags, acfg = magnitudes(dev)
        kw = cs.gl_kw(acfg)
        for mname, mag in mags.items():
            peak, states = float(mag.max()), []
            re, im = zero_phase(mag, True)
            for d in range(max(DEPTHS) + 1):
                if d in DEPTHS:
                    states.append((d, re, im))
                re, im = gl_step_reference(re, im, mag, **kw)
            for d, re, im in states:
                plain, exact = gl_step_reference(re, im, mag, **kw), step_f64(re, im, mag, kw)
                err = lambda a, b: max(cs.max_err(x, y) for x, y in zip(a, b)) / peak
                row = {"plain_vs_f64": err(plain, exact)}
                for name, lib in libs.items():
                    runtime._LIBS["griffin_lim"] = lib
                    got = griffin_lim_step(re, im, mag, **kw)
                    row[name] = {"vs_plain": err(got, plain), "vs_f64": err(got, exact)}
                report["errors"][f"{mname} depth {d}"] = row
                print(f"{mname} depth {d}: plain vs f64 {row['plain_vs_f64']:.3e}; " + "; ".join(
                    f"{n} vs plain {row[n]['vs_plain']:.3e}, vs f64 {row[n]['vs_f64']:.3e}"
                    for n in libs), flush=True)
        mag, n = mags["speech_b8_f1000"], 30
        for rnd in range(2):
            for name, lib in libs.items():
                runtime._LIBS["griffin_lim"] = lib
                row = {}
                for mom in (0.0, 0.99):
                    griffin_lim_spectrum(mag, n_iter=3, momentum=mom, **kw)
                    st = cs.gl_stages(lambda: griffin_lim_spectrum(mag, n_iter=n, momentum=mom, **kw))
                    row[f"k4_momentum_{mom}_us_per_iteration"] = {
                        k: v[0] / n * 1e3 for k, v in st.items() if v[1]}
                st5 = cs.gl_stages(lambda: griffin_lim_spectrum(mag, n_iter=10, inner=1, **kw))
                row["k5_us_per_call"] = {k: v[0] / 10 * 1e3 for k, v in st5.items() if v[1]}
                report["timing"][f"round {rnd} {name}"] = row
                print(f"round {rnd} {name}: " + "; ".join(
                    f"{k} {sum(v.values()):.1f} (" + ", ".join(f"{s} {t:.1f}" for s, t in v.items())
                    + ")" for k, v in row.items()), flush=True)
    runtime._LIBS.pop("griffin_lim", None)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
