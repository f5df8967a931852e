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
* The stage clock (the port's own): ``clock`` opens one record per
  synthesis call or training step; ``mark``, ``span`` and ``count`` add to
  the open one; ``records()`` reads the kept ones; ``tracing()`` turns it on
  without a profiler. ``trace`` / ``stop_trace`` write a window's records
  beside its Chrome trace.

The stage clock. A ``mark(label)`` is a timing CUDA event on the current
stream (the host clock on the CPU); the device time between two
consecutive marks of a record belongs to the later mark's label (``None``:
to no stage), summed per label. Inside a CUDA graph capture a mark is an
external event (``torch.cuda.Event(external=True)``), which the capture
makes an event-record node that every replay records anew: such marks are
captured whether or not the clock is on (a handful per graph, the cost
always paid), kept with the graph (``runtime.capture_graph``) and added to
the open record after each replay (``runtime.replay_graph``). A record is
read once its last mark has completed, never by a synchronise of its own
during the call: a synthesis call's record after the call's own host
reads, a training step's before the next replay of its graph (which
re-records the graph's events) or at ``records()``. A ``span(name)`` is a
host interval (``time.perf_counter_ns``) with its parent; a record's spans
share its ``id``. While ``torch.profiler`` records, each span is also a
``tt.<name>`` range in the profile, on the clock of CUPTI's device records.
The range is an operator's range (``_RecordFunctionFast``), not a user
annotation: the profiler copies a user annotation onto the device timeline
as if it were device work, which would fill every idle gap of the range.

The clock is on while a profiler records or inside ``tracing()``; off, no
record is opened, no event is recorded outside a capture and no span is
kept. ``records()`` holds the last ``RECORDS_KEPT`` records, each a dict:
``id``, ``name`` (``synthesize``, ``train_step``), ``profiled`` (a profiler
was recording), ``device``, ``spans`` ([{name, start_ns, end_ns, parent}],
the root first), ``stage_ms`` (the stages the caller declared), the other
labels' ms as ``<label>_ms`` (``chunk_gap_ms``), ``device_ms`` (first mark
to last) and ``counters``.
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
    ``*.pt.trace.json``, viewable in TensorBoard's profiler or Perfetto),
    with the stage clock's records of the window beside it
    (``*.tt_records.json``)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    prof.tt_window = (log_dir, _IDS[0])
    return prof


def stop_trace(prof: profile) -> None:
    """Wait for the device's queued work, then stop and write the trace and
    the window's records: ``{"records": [...]}`` in
    ``<pid>.<ns>.tt_records.json``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    log_dir, first = prof.tt_window
    path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.tt_records.json")
    with open(path, "w") as f:
        json.dump({"records": [r for r in records() if r["id"] >= first]}, f)


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



# ------------------------------------------------------------ the stage clock
RECORDS_KEPT = 1024
_RECORDS: collections.deque = collections.deque(maxlen=RECORDS_KEPT)
_IDS = [0]                            # the id the next record gets
_LOCAL = threading.local()            # .clock: the open record; .capture: a capture's marks
_SWITCH = [0]                         # depth of tracing() blocks
_NULL = contextlib.nullcontext()
# timing events read and free to record again, by device index: a record's
# host marks take theirs from here, so that a call creates and destroys none
_FREE_EVENTS: dict = collections.defaultdict(list)
FREE_EVENTS_KEPT = 4096
# torch.cuda.Stream objects by raw stream: torch.cuda.current_stream() costs
# a host mark several microseconds, the raw lookup a fraction of one
_STREAMS: dict = {}


def enabled() -> bool:
    """The stage clock is on: a profiler records, or inside ``tracing()``."""
    return _SWITCH[0] > 0 or torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def tracing():
    """The stage clock on for the block, with no profiler (so no CUPTI
    cost on the launches): each call or step keeps a record."""
    _SWITCH[0] += 1
    try:
        yield
    finally:
        _SWITCH[0] -= 1


def records() -> list[dict]:
    """The kept records, oldest first; a record not read yet is read now
    (waiting for its last mark)."""
    return [r.record() for r in list(_RECORDS)]


class GraphMarks(list):
    """A captured graph's marks, [(label, external event)]; every replay
    records the events anew. ``reader``: the record holding the last
    replay's marks until it has read them."""

    reader = None


@contextlib.contextmanager
def capturing():
    """Marks made in the block go into the yielded ``GraphMarks`` as
    external events (``runtime.capture_graph`` wraps a capture in it)."""
    marks = GraphMarks()
    prev, _LOCAL.capture = getattr(_LOCAL, "capture", None), marks
    try:
        yield marks
    finally:
        _LOCAL.capture = prev


def before_replay(marks: GraphMarks) -> None:
    """A replay is about to re-record ``marks``: the record holding the last
    replay's reads them first."""
    if marks.reader is not None:
        marks.reader.record()


def replayed(marks: GraphMarks) -> None:
    """The graph that holds ``marks`` was replayed: the open record takes
    its marks."""
    clock = getattr(_LOCAL, "clock", None)
    if clock is not None and marks:
        clock._marks.extend(marks)
        clock._graphs.append(marks)
        marks.reader = clock


def mark(label: str | None) -> None:
    """A device mark on the current stream: the time since the previous
    mark belongs to ``label``. Inside a capture an event node of the graph,
    whether or not the clock is on; else a mark of the open record, if any."""
    marks = getattr(_LOCAL, "capture", None)
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        marks.append((label, ev))
        return
    clock = getattr(_LOCAL, "clock", None)
    if clock is not None:
        clock.mark(label)


def recording() -> bool:
    """A record is open on this thread (the host marks would be kept)."""
    return getattr(_LOCAL, "clock", None) is not None


def span(name: str):
    """A host span of the open record, ``tt.<name>`` in a profile; nothing
    when no record is open."""
    clock = getattr(_LOCAL, "clock", None)
    return _NULL if clock is None else _Span(clock, name)


def count(name: str, n) -> None:
    """Add ``n`` to the open record's counter ``name``."""
    clock = getattr(_LOCAL, "clock", None)
    if clock is not None:
        clock.counters[name] = clock.counters.get(name, 0) + n


def clock(name: str, device, stages: tuple, force: bool = False):
    """The record of one call or step, as a context manager that yields it
    (None when the clock is off and ``force`` is not set): its root span is
    ``name``; ``stages`` are the labels it reports as ``stage_ms``. It is
    kept for ``records()`` when the clock is on; ``force`` (a caller's
    ``stage_ms=True``) times it all the same and keeps it only then."""
    keep = enabled()
    if not (keep or force):
        return _NULL
    return StageClock(name, device, stages, keep)


class StageClock:
    """One record (``clock``)."""

    def __init__(self, name, device, stages, keep):
        self.id = _IDS[0]
        _IDS[0] += 1
        self.name, self.stages, self.keep = name, tuple(stages), keep
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._index = self._free = None
        if self.cuda:
            self._index = (torch.cuda.current_device() if self.device.index is None
                           else self.device.index)
            self._free = _FREE_EVENTS[self._index]
        self.profiled = torch._C._autograd._profiler_enabled()
        self.counters: dict = {}
        self._marks: list = []           # (label, event or host ns)
        self._own: list = []             # the host marks' events, free again once read
        self._graphs: list = []          # GraphMarks this record holds
        self._spans: list = []           # [name, start_ns, end_ns, parent]
        self._open: list = []            # indices of the open spans
        self._record = None

    def __enter__(self):
        self._prev, _LOCAL.clock = getattr(_LOCAL, "clock", None), self
        self._root = _Span(self, self.name)
        self._root.__enter__()
        return self

    def __exit__(self, *exc):
        self._root.__exit__(*exc)
        _LOCAL.clock = self._prev
        if self.keep:
            _RECORDS.append(self)
        return False

    def mark(self, label):
        if self.cuda:
            free = self._free
            ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
            raw = torch._C._cuda_getCurrentRawStream(self._index)
            stream = _STREAMS.get(raw)
            if stream is None:
                stream = _STREAMS[raw] = torch.cuda.current_stream(self._index)
            ev.record(stream)
            self._marks.append((label, ev))
            self._own.append(ev)
        else:
            self._marks.append((label, time.perf_counter_ns()))

    def _elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e-6

    def record(self) -> dict:
        """The record as a dict; read at the first call, which waits for
        the last mark (the graphs' events are then free to be re-recorded)."""
        if self._record is None:
            marks = self._marks
            if self.cuda and marks:
                marks[-1][1].synchronize()
            ms: dict = {}
            for (_, a), (label, b) in zip(marks, marks[1:]):
                if label is not None:
                    ms[label] = ms.get(label, 0.0) + self._elapsed_ms(a, b)
            rec = {"id": self.id, "name": self.name, "profiled": self.profiled,
                   "device": str(self.device),
                   "spans": [{"name": n, "start_ns": a, "end_ns": b, "parent": p}
                             for n, a, b, p in self._spans],
                   "stage_ms": {s: ms.pop(s) for s in self.stages if s in ms},
                   **{f"{k}_ms": v for k, v in ms.items()},
                   "device_ms": self._elapsed_ms(marks[0][1], marks[-1][1]) if marks else 0.0,
                   "counters": dict(self.counters)}
            for g in self._graphs:
                if g.reader is self:
                    g.reader = None
            if self.cuda:
                self._free.extend(self._own[:FREE_EVENTS_KEPT - len(self._free)])
            self._marks = self._graphs = self._own = None
            self._record = rec
        return self._record


class _Span:
    __slots__ = ("clock", "name", "index", "range")

    def __init__(self, clock: StageClock, name: str):
        self.clock, self.name, self.range = clock, name, None

    def __enter__(self):
        c = self.clock
        self.index = len(c._spans)
        c._spans.append([self.name, time.perf_counter_ns(), None, c._open[-1] if c._open else None])
        c._open.append(self.index)
        if c.profiled:
            self.range = torch._C._profiler._RecordFunctionFast("tt." + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        c = self.clock
        c._spans[self.index][2] = time.perf_counter_ns()
        c._open.pop()
        return False
