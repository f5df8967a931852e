"""ctypes bindings and the g++ build of the native batch assembler.

The library is built at first use from ``native/batcher.cpp`` into
``BUILD_DIR`` (``runtime``'s: ``build/tacotron_tpu_torch/`` beside the
package, unless ``utils.profiling.enable_compilation_cache`` points both
elsewhere; read when the library is looked up), under a name that
carries a hash of the source, so an edited source is rebuilt and the
package's own directory is never written. The compiler
writes a temporary file that is then renamed into place, so processes that
build at the same time do not see a half-written library. A failed build
raises with the compiler's output: there is no fallback here (a caller
that wants the numpy assembler asks for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from tacotron_tpu_torch.runtime import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "batcher.cpp"
ABI_VERSION = 2
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return Path(BUILD_DIR) / f"batcher-{h}.so"


def build() -> Path:
    """The library's path, compiled with ``CXX`` if missing. Raises
    RuntimeError with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native batcher build failed: {' '.join(cmd)}: {e}") from e
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native batcher build failed: {' '.join(cmd)}: exit "
                           f"{p.returncode}\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


def load_batcher() -> ctypes.CDLL:
    """The loaded library, built if missing; raises if it cannot be built
    or loaded, or carries another ABI version."""
    with _lock:
        path = build()
        lib = _LIBS.get(path)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(path))
        lib.batcher_abi_version.argtypes = []
        lib.batcher_abi_version.restype = ctypes.c_int32
        if lib.batcher_abi_version() != ABI_VERSION:
            raise RuntimeError(f"{path}: ABI version {lib.batcher_abi_version()}, "
                               f"expected {ABI_VERSION}")
        # the f16 passthrough (the library's f32 variant, assemble_batch,
        # converts on the host; the port does not call it)
        lib.assemble_batch_f16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,   # mels, linears (u16)
            ctypes.c_void_p,                    # texts (i32)
            ctypes.c_void_p, ctypes.c_void_p,   # text_off, text_len (i64)
            ctypes.c_void_p, ctypes.c_void_p,   # frame_off, frame_len (i64)
            ctypes.c_void_p, ctypes.c_int32,    # items, n_items
            ctypes.c_int32, ctypes.c_int32,     # text_pad, frame_pad
            ctypes.c_int32, ctypes.c_int32,     # n_mels, n_freq
            ctypes.c_void_p, ctypes.c_void_p,   # out_mel, out_lin (u16)
            ctypes.c_void_p,                    # out_text (i32)
            ctypes.c_void_p, ctypes.c_void_p,   # out_text_len, out_frame_len
            ctypes.c_int32,                     # n_threads (0: one per core)
        ]
        lib.assemble_batch_f16.restype = None
        _LIBS[path] = lib
        return lib


class NativeBatcher:
    """Batch assembly over the packed dataset arrays in C++ threads."""

    def __init__(self, dataset):
        ds = dataset
        if ds.mels.dtype != np.float16 or ds.linears.dtype != np.float16:
            raise ValueError("the native batcher expects float16 packed features, got "
                             f"{ds.mels.dtype} / {ds.linears.dtype}")
        self.lib = load_batcher()
        # plain contiguous views of the packed arrays (mmap-backed is fine:
        # the library only reads them)
        self.mels = np.ascontiguousarray(ds.mels.view(np.uint16))
        self.linears = np.ascontiguousarray(ds.linears.view(np.uint16))
        self.texts = np.ascontiguousarray(ds.texts, dtype=np.int32)
        idx = ds.index
        self.text_off = np.array([e["text_offset"] for e in idx], np.int64)
        self.text_len = np.array([e["text_len"] for e in idx], np.int64)
        self.frame_off = np.array([e["frame_offset"] for e in idx], np.int64)
        self.frame_len = np.array([e["n_frames"] for e in idx], np.int64)
        self.n_mels = ds.mels.shape[1]
        self.n_freq = ds.linears.shape[1]

    def assemble(self, items, text_pad: int, frame_pad: int):
        """-> text, text_len, mel, linear, frame_len (numpy; features f16,
        the raw pad and gather), on as many threads as the host has."""
        items = np.ascontiguousarray(items, dtype=np.int32)
        if len(items) and (items.min() < 0 or items.max() >= len(self.frame_len)):
            raise IndexError(f"items outside [0, {len(self.frame_len)})")
        n = len(items)
        out_mel = np.empty((n, frame_pad, self.n_mels), np.float16)
        out_lin = np.empty((n, frame_pad, self.n_freq), np.float16)
        out_text = np.empty((n, text_pad), np.int32)
        out_tl = np.empty((n,), np.int32)
        out_fl = np.empty((n,), np.int32)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        self.lib.assemble_batch_f16(
            c(self.mels), c(self.linears), c(self.texts),
            c(self.text_off), c(self.text_len), c(self.frame_off),
            c(self.frame_len), c(items), n, text_pad, frame_pad,
            self.n_mels, self.n_freq,
            c(out_mel), c(out_lin), c(out_text), c(out_tl), c(out_fl),
            0,
        )
        return out_text, out_tl, out_mel, out_lin, out_fl
