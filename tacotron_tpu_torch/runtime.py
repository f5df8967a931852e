"""Where the port runs: device resolution, and the build and loading of the
hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, from the package's sources only, into
``BUILD_DIR`` (by default ``build/tacotron_tpu_torch/`` beside the package;
``utils.profiling.enable_compilation_cache`` points it elsewhere); the
library name carries a hash of the sources, so an edited source is rebuilt.
``build()`` starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds to it
where it launches its kernel, and nowhere else. A call captured into a
CUDA graph launches nothing: the graphed training step
(``train.step.GraphedTrainStep``) takes its capture's counts back and adds
them again on every replay, which launches those kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR.parent / "build" / "tacotron_tpu_torch"
# read when a library is looked up or built, not when a module is imported
BUILD_DIR = DEFAULT_BUILD_DIR
KERNEL_SOURCES = ("attn_energy", "decode_loop", "griffin_lim", "probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions")
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, Path]:
    """Compile every missing library in ``names``, one ``nvcc`` per source,
    started together. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
