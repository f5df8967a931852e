"""Capability probes for the Griffin-Lim kernel design, on the card.

Port of the JAX package's ``scripts/probe_pallas.py`` (TPU probes P1
``probe_vmem`` and P2 ``probe_ops``) to ``csrc/probe.cu``:

    python -m tacotron_tpu_torch.probe smem 227   # KiB of dynamic shared memory
    python -m tacotron_tpu_torch.probe ops

``smem`` asks whether one block can have that much dynamic shared memory
and use it (an H100 allows 227 KiB; one more is refused, and the refusal
is raised with the CUDA error, never turned into a pass). ``ops`` runs the
op shapes the Griffin-Lim kernels rely on in one launch: an NT product from
shared-memory tiles, two overlapping row-offset accumulations, an unaligned
row reversed by a permutation product, a loop inside the kernel. The launch
is one thread-block cluster that splits the output's columns over its
ranks (``ops_plan``; the design is in ``csrc/probe.cu`` at
``probe_ops_kernel``).

Each probe has a plain PyTorch version, which CPU tensors take.
``probe_cluster_barrier`` asks what the fused decode's design needs
(``csrc/decode_loop.cu`` ends each phase of a step with a cluster barrier):
it launches clusters that run n cluster barriers and nothing else, for the
barrier's cost. ``probe_empty`` launches a kernel that does nothing on a
given grid (the attention-energy kernels' grids, the ops probe's cluster):
the floor of a small kernel's device time. Neither computes anything, so
they have no plain version and run on the card only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys

import numpy as np
import torch

from tacotron_tpu_torch import runtime

SMEM_SHAPE = (8, 512)
OPS_F, OPS_S, OPS_H = 64, 256, 275
# the ops kernel's geometry (csrc/probe.cu: kOpsCluster, kOpsRowGroups,
# kOpsSplit, kOpsLd): one cluster of OPS_CLUSTER blocks; each thread 4 x 4
# outputs, rows rg + 16 i; the 256-deep contraction split over 4 thread
# groups; operand rows padded to 260 floats
OPS_CLUSTER = 16
OPS_ROW_GROUPS, OPS_SPLIT, OPS_LD = 16, 4, OPS_S + 4


@dataclasses.dataclass(frozen=True)
class OpsPlan:
    """The ops kernel's launch: ``cluster`` blocks of ``threads`` threads
    with ``smem_bytes`` of dynamic shared memory; rank r owns the output
    columns ``cols[r]`` (a half-open range) of all F + 8 rows, and reads
    p's rows of the same range for its share of the permutation product.
    Splitting columns needs no halo rows: output row i takes product rows
    i - 3 and i - 5 of its own column."""
    cluster: int
    cols: tuple
    col_groups: int
    threads: int
    smem_bytes: int


def ops_col0(r: int, cluster: int) -> int:
    """First column of rank r: floor(r H / C)."""
    return r * OPS_H // cluster


def ops_owner(j: int, cluster: int) -> int:
    """The rank owning column j, as the kernel finds it."""
    t = j * cluster // OPS_H
    return t + 1 if j >= ops_col0(t + 1, cluster) else t


def ops_plan(cluster: int = OPS_CLUSTER) -> OpsPlan:
    """The launch at the built cluster size, ``OPS_CLUSTER``, the only one
    ``probe_ops`` launches. Another size that the kernel's geometry allows
    (a thread per column of p, at most 1024 a block, at most 16 blocks a
    cluster) serves the CPU emulation in tests/test_torch_probe.py and
    scripts/probe_study.py's ``cluster_8`` variant, which rebuilds the
    kernel with kOpsCluster 8."""
    most = -(-OPS_H // cluster) if cluster > 0 else 0
    groups = -(-most // 4)
    threads = OPS_ROW_GROUPS * groups * OPS_SPLIT
    if not (0 < cluster <= 16 and OPS_H <= threads <= 1024):
        raise ValueError(f"the ops kernel cannot run on a cluster of {cluster}")
    pad = 4 * groups
    floats = (OPS_F * OPS_LD + pad * OPS_LD + OPS_SPLIT * OPS_F * pad + cluster * pad
              + cluster + 32)
    return OpsPlan(cluster=cluster,
                   cols=tuple((ops_col0(r, cluster), ops_col0(r + 1, cluster))
                              for r in range(cluster)),
                   col_groups=groups, threads=threads, smem_bytes=4 * floats)


def probe_smem_reference(x):
    """What the shared-memory probe returns: ``x * 2``."""
    return x * 2.0


def probe_ops_reference(spec, d, p):
    """Plain PyTorch version of the ops probe -> (F + 8, H) f32."""
    f = spec.shape[0]
    out = spec @ d.T
    y = torch.zeros(f + 8, d.shape[0], dtype=torch.float32, device=spec.device)
    y[3:3 + f] += out
    y[5:5 + f] += out * 0.5
    y[7:8] = y[5:6] @ p
    s = torch.zeros((), dtype=torch.float32, device=spec.device)
    for _ in range(4):
        s = s + y[0:8].sum() * 1e-9
    return y + s


def ops_inputs(device, seed: int | None = None):
    """(spec, d, p): all-ones operands as the TPU probe used, or seeded
    normal ones; p is the reversal permutation."""
    if seed is None:
        spec, d = np.ones((OPS_F, OPS_S), np.float32), np.ones((OPS_H, OPS_S), np.float32)
    else:
        rng = np.random.default_rng(seed)
        spec = rng.standard_normal((OPS_F, OPS_S)).astype(np.float32)
        d = rng.standard_normal((OPS_H, OPS_S)).astype(np.float32)
    p = np.eye(OPS_H, dtype=np.float32)[::-1].copy()
    return tuple(torch.from_numpy(a).to(device) for a in (spec, d, p))


class ProbeError(RuntimeError):
    """A probe's launch was refused; carries the CUDA error."""


def _lib():
    lib = runtime.load("probe")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tt_probe_smem.argtypes = [vp, vp, ci, ctypes.POINTER(ci), vp]
    lib.tt_probe_smem.restype = ci
    lib.tt_probe_ops.argtypes = [vp, vp, vp, vp, vp]
    lib.tt_probe_ops.restype = ci
    lib.tt_probe_cluster_barrier.argtypes = [ci, ci, ci, vp]
    lib.tt_probe_cluster_barrier.restype = ci
    lib.tt_probe_empty.argtypes = [ci, ci, ci, ci, vp]
    lib.tt_probe_empty.restype = ci
    for fn in (lib.tt_probe_error_name, lib.tt_probe_error_string):
        fn.argtypes = [ci]
        fn.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str):
    if err != 0:
        raise ProbeError(f"{what}: CUDA error {err} "
                         f"{lib.tt_probe_error_name(err).decode()}: "
                         f"{lib.tt_probe_error_string(err).decode()}")


def _f32_on(x, shape, dev, what):
    if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != dev:
        raise ValueError(f"{what} must be f32 {shape} on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    return x.contiguous()


def probe_smem(x, kib: int):
    """(8, 512) f32 ``x`` -> (``x * 2`` through ``kib`` KiB of one block's
    dynamic shared memory, the device's opt-in limit in bytes). CPU tensors
    take the plain version and report no limit."""
    if kib * 1024 < x.numel() * 4:
        raise ValueError(f"{kib} KiB cannot hold the probe's {x.numel() * 4} bytes")
    if x.device.type == "cpu":
        return probe_smem_reference(x), None
    x = _f32_on(x, SMEM_SHAPE, x.device, "probe_smem: x")
    if x.data_ptr() % 16:                       # the kernel moves 16-byte vectors
        x = x.clone()
    out = torch.empty_like(x)
    limit = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.tt_probe_smem(x.data_ptr(), out.data_ptr(), kib, ctypes.byref(limit),
                                runtime.stream_ptr(x.device))
    _check(lib, err, f"probe_smem({kib} KiB; the device allows {limit.value} bytes)")
    runtime.LAUNCHES["probe_smem"] += 1
    return out, limit.value


def probe_ops(spec, d, p):
    """The ops probe -> (72, 275) f32; CPU tensors take the plain version."""
    if spec.device.type == "cpu":
        return probe_ops_reference(spec, d, p)
    dev = spec.device
    spec = _f32_on(spec, (OPS_F, OPS_S), dev, "probe_ops: spec")
    d = _f32_on(d, (OPS_H, OPS_S), dev, "probe_ops: d")
    p = _f32_on(p, (OPS_H, OPS_H), dev, "probe_ops: p")
    spec, d = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (spec, d))   # 16-byte copies
    out = torch.empty(OPS_F + 8, OPS_H, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tt_probe_ops(spec.data_ptr(), d.data_ptr(), p.data_ptr(), out.data_ptr(),
                               runtime.stream_ptr(dev))
    _check(lib, err, "probe_ops")
    runtime.LAUNCHES["probe_ops"] += 1
    return out


def probe_cluster_barrier(clusters: int, cluster: int, n: int, device=None) -> None:
    """Launch ``clusters`` clusters of ``cluster`` blocks (512 threads, one
    per SM) that each run ``n`` cluster barriers; asynchronous on the
    current stream. Time it at two ``n`` for one barrier's cost."""
    dev = runtime.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"probe_cluster_barrier runs on a CUDA device, not {dev}")
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tt_probe_cluster_barrier(clusters, cluster, n, runtime.stream_ptr(dev))
    _check(lib, err, f"probe_cluster_barrier({clusters} clusters of {cluster})")
    runtime.LAUNCHES["probe_cluster_barrier"] += 1


def probe_empty(blocks: int, threads: int, cluster: int = 1, device=None,
                smem_bytes: int = 0) -> None:
    """Launch an empty kernel on ``blocks`` blocks of ``threads`` threads in
    clusters of ``cluster`` (1..16) with ``smem_bytes`` of dynamic shared
    memory; asynchronous on the current stream. Its device time is the
    floor of any kernel launched on that grid."""
    dev = runtime.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"probe_empty runs on a CUDA device, not {dev}")
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tt_probe_empty(blocks, threads, cluster, smem_bytes, runtime.stream_ptr(dev))
    _check(lib, err, f"probe_empty({blocks} blocks of {threads} in clusters of {cluster})")
    runtime.LAUNCHES["probe_empty"] += 1


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("smem", "ops") or len(argv) != (2 if argv[0] == "smem" else 1):
        print("usage: python -m tacotron_tpu_torch.probe smem <KiB> | ops", file=sys.stderr)
        return 2
    dev = runtime.resolve_device(device)
    if argv[0] == "ops":
        inputs = ops_inputs(dev)
        got, want = probe_ops(*inputs), probe_ops_reference(*inputs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-4 * float(want.abs().max())))
        print("ops:", ok)
        return 0 if ok else 1
    kib = int(argv[1])
    x = torch.ones(SMEM_SHAPE, device=dev)
    out, limit = probe_smem(x, kib)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ok = bool(torch.equal(out, probe_smem_reference(x)))
    print(f"smem {kib}KiB:", ok, f"(max opt-in per block: {limit} bytes)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
