"""Multi-process control plane, the port of the JAX package's
``parallel/multihost.py``.

The port runs one process per device under ``torch.distributed``.
``initialize`` is the rendezvous; ``is_primary``-gated I/O, barriers around
checkpoints, and the debug checks that the processes agree (on the step,
on the batch shapes, and on feeding distinct data) are JAX's, over
``all_gather``. The checks raise ``RuntimeError`` with the JAX package's
messages on every process, since each one sees every other's values.

Backend: NCCL when every process has a card of its own, gloo otherwise (on
the CPU, and for several processes on one card, which NCCL refuses; gloo
takes CUDA tensors through host copies, ``parallel/collectives.py``). Each
host decides from the processes it runs itself: all of them when the
rendezvous is local (a ``file://`` URL or a loopback address), else
``LOCAL_WORLD_SIZE``, which a world spread over several hosts must set.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from urllib.parse import urlsplit

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
LOOPBACK = ("localhost", "::1")           # and 127.0.0.0/8


def local_process_count(url: str, num_processes: int) -> int:
    """The processes of the world that run on this host: ``LOCAL_WORLD_SIZE``
    when set, else all of them for a local rendezvous. A coordinator on
    another host without it is refused: the backend could not be chosen."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    parts = urlsplit(url)
    host = parts.hostname or ""
    if parts.scheme == "file" or host in LOOPBACK or host.startswith("127."):
        return num_processes
    raise ValueError(f"coordinator {url} is not on this host: set LOCAL_WORLD_SIZE to the "
                     f"number of processes on each host (NCCL needs a card per process)")


def local_rank(rank: int, num_local: int) -> int:
    """Process ``rank``'s index among the ``num_local`` processes of its
    host: ``LOCAL_RANK`` when set, else the ranks taken in host order."""
    return int(os.environ.get("LOCAL_RANK", rank % num_local))


def pick_backend(num_local: int, platform: str = "cuda") -> str:
    """"nccl" when ``platform`` is the card and this host has one for each
    of its ``num_local`` processes, else "gloo"."""
    if platform == "cuda" and torch.cuda.is_available() \
            and torch.cuda.device_count() >= num_local:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, platform: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str | None:
    """Join the process group (a no-op for at most one process; idempotent).

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or a URL
    (``tcp://``, ``file://``). A collective that waits longer than
    ``timeout_s`` raises. Prints and returns the backend taken."""
    if num_processes is None or num_processes <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address is None or process_id is None:
        raise ValueError("more than one process needs a coordinator address and a process id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend, where = "gloo", "on the CPU"
    if platform == "cuda":
        num_local = local_process_count(url, num_processes)
        backend = pick_backend(num_local, platform)
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        where = f"{num_local} processes on {cards} cards of this host"
        if backend == "nccl":
            torch.cuda.set_device(local_rank(process_id, num_local))
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    print(f"process {process_id} of {num_processes}: torch.distributed backend {backend} "
          f"({where})", flush=True)
    return backend


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def rank_device(platform: str = "cuda") -> torch.device:
    """This process's device: the CPU, or its host's card ``local rank %
    cards`` (every rank on card 0 of a one-card machine)."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass platform='cpu' to run the "
                           "plain PyTorch versions")
    num_local = int(os.environ.get("LOCAL_WORLD_SIZE") or process_count())
    return torch.device("cuda", local_rank(process_index(), num_local) % torch.cuda.device_count())


def _comm_device(group=None) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather(a: np.ndarray, group=None) -> np.ndarray:
    """(P, ...) numpy: every process's ``a`` (same shape and dtype), in
    rank order."""
    t = torch.from_numpy(np.array(a)).to(_comm_device(group))   # a writable copy
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).cpu().numpy()


def barrier(name: str = "barrier") -> None:
    """Wait for every process (one tiny all-reduce; ``name`` labels it, as
    in JAX)."""
    if process_count() > 1:
        dist.all_reduce(torch.zeros(1, device=_comm_device()))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif tree is not None:
        yield tree


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def batch_hash(batch_arrays) -> str:
    """Content hash of a process-local batch: 16 hex digits, the same as
    the JAX package's for the same arrays."""
    h = hashlib.sha256()
    for a in _leaves(batch_arrays):
        h.update(np.ascontiguousarray(_host(a)).tobytes())
    return h.hexdigest()[:16]


def _dtype_name(a) -> str:
    return str(a.dtype).removeprefix("torch.") if isinstance(a, torch.Tensor) \
        else str(np.asarray(a).dtype)


def _shape_fingerprint(batch_arrays) -> bytes:
    spec = [(tuple(int(n) for n in a.shape), _dtype_name(a)) for a in _leaves(batch_arrays)]
    return hashlib.sha256(repr(spec).encode()).digest()[:8]


def assert_same_step(step: int, group=None) -> None:
    """Every process at the same step (a cheap divergence guard)."""
    if process_count() <= 1:
        return
    steps = _gather(np.asarray([step], np.int64), group)[:, 0]
    if int(steps.min()) != int(steps.max()):
        raise RuntimeError(f"step divergence across hosts: {steps}")


def assert_same_shapes(batch_arrays, group=None) -> None:
    """Every process's batch has the same shapes and dtypes (one 8-byte
    all-gather: cheap enough for every step)."""
    if process_count() <= 1:
        return
    fp = np.frombuffer(_shape_fingerprint(batch_arrays), np.uint8)
    if len({bytes(r) for r in _gather(fp, group)}) != 1:
        raise RuntimeError("hosts disagree on batch shapes (bucket divergence)")


def assert_shard_consistency(batch_arrays, group=None) -> None:
    """Shapes agree and contents differ across the processes of ``group``:
    the two host-side hazards of data parallelism (different buckets at one
    step; every process feeding the same data)."""
    if process_count() <= 1:
        return
    packed = np.frombuffer(_shape_fingerprint(batch_arrays)
                           + bytes.fromhex(batch_hash(batch_arrays)), np.uint8)
    allg = _gather(packed, group)
    if len({bytes(r[:8]) for r in allg}) != 1:
        raise RuntimeError("hosts disagree on batch shapes (bucket divergence)")
    contents = [bytes(r[8:]) for r in allg]
    if len(set(contents)) != len(contents):
        raise RuntimeError("duplicate batch content across hosts (per-host data sharding "
                           "broken)")
