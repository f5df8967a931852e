"""The traced window: device and host events out of ``torch.profiler``, kept
in memory, and the arithmetic every per-layer reader shares.

``events(prof)`` flattens a profile into ``Event`` records: device work
(``kernel``, ``memcpy``, ``memset``), the CUDA runtime calls that launched
it (``runtime``, e.g. ``cudaGraphLaunch``; a device event carries its
launch's correlation id) and host operations (``cpu``), each with start and
end in microseconds on one clock. The benchmark marks each profiled call
or step with a host span (``SPAN``); readers see those spans and the
events, and nothing of the program but kernel names.
"""

from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass, field

SPAN = "bench.timed"


@dataclass(frozen=True)
class Event:
    name: str
    kind: str            # kernel | memcpy | memset | runtime | cpu
    start: float         # microseconds
    end: float
    corr: int = 0


@dataclass
class Trace:
    """What a reader gets: the events, the benchmark's spans (start, end)
    of the profiled calls or steps, and ``info``: per span what the driver
    knows of it (shapes, operation counts, graph nodes)."""

    events: list
    spans: list
    info: list = field(default_factory=list)

    @property
    def device(self) -> list:
        return [e for e in self.events if e.kind in ("kernel", "memcpy", "memset")]

    def span_seconds(self) -> float:
        return sum(b - a for a, b in self.spans) * 1e-6

    def in_spans(self, evs) -> list:
        return [e for e in evs if any(a <= e.start < b for a, b in self.spans)]


def events(prof) -> list[Event]:
    """A ``torch.profiler.profile``'s events as ``Event`` records."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        name = e.name
        if e.device_type == DeviceType.CUDA:
            if name == SPAN:
                continue                     # the annotation's device-side copy
            kind = ("memcpy" if name.startswith("Memcpy") else
                    "memset" if name.startswith("Memset") else "kernel")
        elif name.startswith("cuda") or name.startswith("cu"):
            kind = "runtime"
        else:
            kind = "cpu"
        out.append(Event(name, kind, start, end, int(e.id)))
    return out


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) microsecond intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total * 1e-6


def busy_seconds(tr: Trace) -> float:
    """Seconds of the spans in which some kernel, copy or set ran."""
    clipped = []
    for a, b in tr.spans:
        clipped += [(max(e.start, a), min(e.end, b)) for e in tr.device if e.end > a and e.start < b]
    return union_seconds(clipped)


def kernel_seconds(tr: Trace, *parts: str) -> tuple[float, int]:
    """(summed device seconds, launches) of the kernels in the spans whose
    name holds any of ``parts``."""
    ks = [e for e in tr.in_spans(tr.device) if e.kind == "kernel" and any(p in e.name for p in parts)]
    return sum(e.end - e.start for e in ks) * 1e-6, len(ks)


def per_launch_seconds(tr: Trace, expected: int, *parts: str) -> float | None:
    """Device seconds of ``expected`` launches of the named kernels: the
    sum when the profiler recorded every launch, else the mean per recorded
    launch times ``expected`` (a profiler can drop a short launch); None
    when it recorded none."""
    s, n = kernel_seconds(tr, *parts)
    if n == 0 or expected <= 0:
        return None
    return s if n == expected else s / n * expected


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps between device work inside the spans, summed by the innermost host
    operation under way at each gap's middle."""
    dev = tr.in_spans(tr.device)
    by_op = collections.Counter()
    for e in dev:
        by_op[e.name] += (e.end - e.start) * 1e-6
    gaps_at = []                                   # (middle, seconds)
    for a, b in sorted(tr.spans):
        cur = a
        for s, t in sorted((max(e.start, a), min(e.end, b)) for e in dev if e.end > a and e.start < b):
            if s > cur:
                gaps_at.append(((cur + s) / 2, (s - cur) * 1e-6))
            cur = max(cur, t)
        if b > cur:
            gaps_at.append(((cur + b) / 2, (b - cur) * 1e-6))
    host = sorted((e for e in tr.events if e.kind in ("cpu", "runtime")), key=lambda e: e.start)
    gaps = collections.Counter()
    i, active = 0, []
    for t, sec in sorted(gaps_at):
        while i < len(host) and host[i].start <= t:
            active.append(host[i])
            i += 1
        active = [e for e in active if e.end >= t]
        gaps[max(active, key=lambda e: e.start).name if active else "host"] += sec
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


# ---------------------------------------------------------------- graph nodes
_NODE_TYPES = {1: "<memcpy>", 2: "<memset>", 3: "<host>", 4: "<graph>", 5: "<empty>",
               6: "<event wait>", 7: "<event record>", 10: "<mem alloc>", 11: "<mem free>"}


class _KernelNodeParams(ctypes.Structure):
    """The driver's ``CUDA_KERNEL_NODE_PARAMS_v2`` (CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p), *((f, ctypes.c_uint) for f in (
        "gridDimX", "gridDimY", "gridDimZ", "blockDimX", "blockDimY", "blockDimZ",
        "sharedMemBytes")), ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_nodes(graph) -> collections.Counter:
    """{name: count} of a captured ``torch.cuda.CUDAGraph``'s nodes (kept
    with ``keep_graph=True``): kernels by their function's name, through the
    driver API, the others by type. A capture records every launch, so this
    count misses none."""
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
