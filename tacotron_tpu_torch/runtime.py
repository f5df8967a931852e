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
CUDA graph launches nothing: ``capture_graph`` takes its capture's counts
back and ``replay_graph`` adds them again on every replay, which launches
those kernels. The graphed training step (``train.step.GraphedTrainStep``)
and the graphed synthesis (``infer.synthesize.Synthesizer``) capture and
replay through these two.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR.parent / "build" / "tacotron_tpu_torch"
# read when a library is looked up or built, not when a module is imported
BUILD_DIR = DEFAULT_BUILD_DIR
KERNEL_SOURCES = ("attn_energy", "decode_chunk", "decode_loop", "griffin_lim", "probe")
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


def fill_outside_capture(what: str) -> None:
    """Lazy caches of device state (a library's residency table, K2's
    counter, the DSP constants) are filled at first use, which must not fall
    inside a CUDA graph capture: what is made there lives in the graph's
    memory pool, and a copy from host memory cannot be captured at all. One
    eager call on the capture stream fills them (the graphed training step
    and the graphed synthesis run each shape's first call so)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} is made at first use, not inside a CUDA graph capture: "
                           f"run one call on the capture stream before capturing")


@dataclass
class CapturedGraph:
    """One captured CUDA graph, what its capture returned and its cost."""

    graph: torch.cuda.CUDAGraph
    outputs: object                   # what the captured function returned
    launches: collections.Counter     # LAUNCHES of one replay
    capture_s: float                  # host seconds to record the graph
    instantiate_s: float              # host seconds to instantiate it
    pool_bytes: int                   # the private memory pool's growth during capture
    marks: list                       # the stage clock's event nodes (utils.profiling.mark)


def capture_graph(fn, stream, generator=None) -> CapturedGraph:
    """``fn()`` captured on ``stream`` into a CUDA graph with a private
    memory pool (thread-local capture mode; ``keep_graph=True``, so that
    ``utils.profiling.graph_nodes`` can read its nodes), ``generator``
    registered with it so that each replay draws what an eager call at the
    generator's state would, and advances it alike. The capture's wrapper
    calls launch nothing: their counts are taken back out of ``LAUNCHES``
    and kept for ``replay_graph``. NCCL collectives that ``fn`` issues are
    captured too: their stream joins the capture through the events that
    order it with the capture stream. Each group's communicator must exist
    before (NCCL makes it at the group's first collective, which cannot be
    captured), so the callers run each shape's first call eagerly; the
    thread-local mode lets NCCL's watchdog thread query its events while
    the capture is open. The stage clock's marks made in ``fn``
    (``utils.profiling.mark``) become event-record nodes, kept in
    ``marks``. A failed capture raises."""
    from tacotron_tpu_torch.utils import profiling
    before = collections.Counter(LAUNCHES)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if generator is not None:
        graph.register_generator_state(generator)
    t0 = time.perf_counter()
    with profiling.capturing() as marks, torch.cuda.graph(
            graph, stream=stream, capture_error_mode="thread_local"):
        reserved = torch.cuda.memory_reserved(stream.device)
        outputs = fn()
    t1 = time.perf_counter()
    pool = torch.cuda.memory_reserved(stream.device) - reserved
    graph.instantiate()
    launches = collections.Counter(LAUNCHES)
    launches.subtract(before)
    launches = +launches
    LAUNCHES.subtract(launches)     # recorded, not launched
    return CapturedGraph(graph, outputs, launches, t1 - t0, time.perf_counter() - t1, pool,
                         marks)


def replay_graph(entry) -> None:
    """Replay ``entry.graph`` (a ``CapturedGraph``, or a record holding one's
    ``graph``, ``launches`` and ``marks``) on the current stream, and count
    the launches it makes. The replay rewrites the capture's outputs in
    place, and its marks: the stage clock's record that holds the last
    replay's reads them first, and the open record takes the new ones."""
    from tacotron_tpu_torch.utils import profiling
    profiling.before_replay(entry.marks)
    entry.graph.replay()
    LAUNCHES.update(entry.launches)
    profiling.replayed(entry.marks)
