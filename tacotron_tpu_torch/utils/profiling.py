"""Tracing and profiling hooks on ``torch.profiler``.

The port of the JAX package's ``utils/profiling.py``, function for function:

* ``trace`` around a block (the synthesis CLI's ``--trace-dir``), and
  ``start_trace`` / ``stop_trace`` around a window of training steps (the
  training CLI's ``--trace-steps``). Each writes a Chrome trace
  (``*.pt.trace.json``) viewable in TensorBoard's profiler or Perfetto.
* ``start_server(port)``: live capture. torch has no profiler server that
  TensorBoard connects to, so this serves plain HTTP on ``127.0.0.1``:
  ``GET /capture?steps=N`` asks the training loop to trace its next N steps
  with ``start_trace`` / ``stop_trace``, on the training thread, and the
  reply (JSON, sent once the trace is written) names the trace directory,
  the steps and the files. ``GET /status`` says whether a capture is
  pending or open and which step the loop reached.
* ``force`` and ``time_fn``: host wall time of a call, completion forced by
  a host read of its first output.
* ``enable_compilation_cache(path)``: the port's counterpart of JAX's
  persistent XLA cache is its cache of built kernels, the libraries that
  ``runtime.build`` and the native assembler compile; pointing it at a
  shared directory lets processes and checkouts reuse them. XLA's minimum
  compile time for an entry to be cached has no counterpart: every library
  is kept.
* ``graph_nodes(graph)``: what a captured CUDA graph holds, node by node
  (the port's own: JAX has no graphs). A capture records every launch, so
  this count cannot miss a kernel as the profiler can miss a ~1 us one.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


def enable_compilation_cache(path: str | os.PathLike | None = None) -> None:
    """Build and look up the kernels' libraries (``runtime.build``) and the
    native batch assembler (``native/binding.py``) in ``path``, which
    processes and checkouts can share (a library's name carries a hash of
    its sources, so a changed source is built anew). ``None``: the default,
    ``build/tacotron_tpu_torch/`` beside the package."""
    from tacotron_tpu_torch import runtime
    from tacotron_tpu_torch.native import binding
    runtime.BUILD_DIR = binding.BUILD_DIR = (runtime.DEFAULT_BUILD_DIR if path is None
                                             else Path(path))


def start_trace(log_dir: str) -> profile:
    """Start capturing the host and, where there is a card, the device; the
    trace is written into ``log_dir`` by ``stop_trace`` (a Chrome trace,
    ``*.pt.trace.json``, viewable in TensorBoard's profiler or Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def stop_trace(prof: profile) -> None:
    """Wait for the device's queued work, then stop and write the trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: str):
    """``start_trace`` / ``stop_trace`` around a block; yields the profiler."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace(prof)


class CaptureServer:
    """The live-capture endpoint of a training run (``start_server``).

    The HTTP threads only hand a request over and wait: the training loop
    calls ``poll`` at each step boundary, opens the trace window itself when
    ``poll`` returns a step count, and calls ``finish`` once the trace is
    written, which sends the reply. One capture at a time: a request while
    another is pending or open, or for fewer than 1 step, gets an error
    reply (HTTP 409 / 400) and the run goes on. ``close`` answers a request
    still waiting with 503 and stops the server."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._state = "idle"          # idle -> pending -> open -> idle
        self._steps = 0
        self._step = None
        self._done = None             # (event, reply holder) of the waiting request
        self._closed = False
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.capture = self
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"profile-server:{self.port}", daemon=True)
        self._thread.start()

    # -- the HTTP side ------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {"state": self._state, "step": self._step}

    def request(self, steps: int) -> tuple[int, dict]:
        """Arm a capture of the next ``steps`` steps and wait for its trace.
        -> (HTTP status, reply)."""
        if steps < 1:
            return 400, {"error": f"steps must be >= 1, got {steps}"}
        with self._lock:
            if self._closed:
                return 503, {"error": "the run has ended"}
            if self._state != "idle":
                return 409, {"error": f"a capture is already {self._state}",
                             "step": self._step}
            self._state, self._steps = "pending", steps
            done = self._done = (threading.Event(), [])
        done[0].wait()
        return done[1][0]

    # -- the training side --------------------------------------------------

    def poll(self, step: int, idle: bool = True) -> int:
        """At a step boundary, ``step`` steps done: the number of steps to
        capture from here (0: none). With ``idle`` False (another trace
        window is open) a pending request waits. A nonzero return opens the
        window: the caller starts the trace and later calls ``finish``."""
        with self._lock:
            self._step = step
            if idle and self._state == "pending":
                self._state = "open"
                return self._steps
            return 0

    def finish(self, reply: dict) -> None:
        """The window's trace is written: send ``reply`` (status 200)."""
        self._answer(200, reply)

    def _answer(self, code: int, reply: dict) -> None:
        with self._lock:
            done, self._done, self._state = self._done, None, "idle"
        if done is not None:
            done[1].append((code, reply))
            done[0].set()

    def close(self) -> None:
        """Answer a request still waiting (the run ended first), stop
        serving and release the port. Waits for the replies in flight."""
        with self._lock:
            self._closed = True
        self._answer(503, {"error": "the run ended before the capture completed"})
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()


class _HTTPServer(ThreadingHTTPServer):
    # join the request threads on server_close, so that a reply that was
    # being written when the run ended still reaches its client
    daemon_threads = False
    block_on_close = True


class _Handler(BaseHTTPRequestHandler):
    timeout = 30          # a client that stops reading cannot hold close()

    def do_GET(self):
        url = urlsplit(self.path)
        capture: CaptureServer = self.server.capture
        if url.path == "/status":
            code, reply = 200, capture.status()
        elif url.path == "/capture":
            raw = parse_qs(url.query).get("steps", ["1"])[0]
            try:
                steps = int(raw)
            except ValueError:
                code, reply = 400, {"error": f"steps must be an integer, got {raw!r}"}
            else:
                code, reply = capture.request(steps)
        else:
            code, reply = 404, {"error": f"no such path {url.path}; "
                                         f"GET /capture?steps=N or /status"}
        body = (json.dumps(reply) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):
        pass


def start_server(port: int = 9999) -> CaptureServer:
    """Live profiling endpoint on ``127.0.0.1:port``: ``GET
    /capture?steps=N`` traces the next N steps of the training loop that
    polls it (``cli/train.py`` with ``--profile-port``)."""
    return CaptureServer(port)


def _first_leaf(x):
    """The first leaf of ``x`` in JAX's leaf order: lists and tuples in
    order, dicts by sorted key, ``None`` an empty subtree."""
    if isinstance(x, dict):
        for k in sorted(x):
            leaf = _first_leaf(x[k])
            if leaf is not None:
                return leaf
        return None
    if isinstance(x, (list, tuple)):
        for v in x:
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        return None
    return x


def force(x) -> float:
    """Device->host read that waits for the first leaf of ``x`` (a tensor,
    an array or a number, or a list, tuple or dict of them) to complete."""
    leaf = _first_leaf(x)
    if leaf is None:
        raise ValueError("force: no leaf in the output")
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))
    return float(leaf.abs().sum())


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds per call, completion-forced."""
    for _ in range(warmup):
        out = fn(*args)
    force(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    force(out)
    return (time.time() - t0) / iters


# CUgraphNodeType values of the driver API other than 0 (a kernel)
_NODE_TYPES = {1: "<memcpy>", 2: "<memset>", 3: "<host>", 4: "<graph>", 5: "<empty>",
               6: "<event wait>", 7: "<event record>", 10: "<mem alloc>", 11: "<mem free>"}


class _KernelNodeParams(ctypes.Structure):
    """The driver's ``CUDA_KERNEL_NODE_PARAMS_v2`` (CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p), *((f, ctypes.c_uint) for f in (
        "gridDimX", "gridDimY", "gridDimZ", "blockDimX", "blockDimY", "blockDimZ",
        "sharedMemBytes")), ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_nodes(graph: torch.cuda.CUDAGraph) -> collections.Counter:
    """{name: count} of the nodes of a graph captured with
    ``torch.cuda.CUDAGraph(keep_graph=True)``: kernel nodes by their
    function's (mangled) name, through the driver API
    (``cuGraphKernelNodeGetParams``, ``cuFuncGetName``; CUDA 12.3), the
    others by type, e.g. ``<memset>``. Raises on a driver error."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA driver error {err}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out: collections.Counter = collections.Counter()
    kind, params, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
    for node in nodes:
        node = ctypes.c_void_p(node)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:
            out[_NODE_TYPES.get(kind.value, f"<type {kind.value}>")] += 1
            continue
        check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        out[name.value.decode()] += 1
    return out
