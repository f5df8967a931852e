"""Bahdanau attention energy and its backward (TPU kernels K1 and K2).

Port of the JAX package's ``ops/pallas/attn_energy.py``:

    e[b, t] = sum_a v[a] * tanh(keys[b, t, a] + q[b, a])

``attention_energy`` is a ``torch.autograd.Function`` for CUDA tensors: its
forward launches K1 and its backward K2 (``csrc/attn_energy.cu``), so the
(B, T_in, A) tanh is never stored; the backward recomputes it. CPU tensors
run the plain formula, ``attention_energy_reference``, under ordinary
autograd, as JAX's ``"auto"`` backend does off the TPU.

``keys`` and ``q`` are both f32 or both bf16 (bf16 compute): the tanh is
then rounded to bf16, ``dkeys`` and ``dq`` come out in bf16, while ``v``,
the energies, ``de`` and ``dv`` are f32, as in the TPU kernels.
``energy_bwd_reference`` is K2's plain version with K2's rounding points.

Launch geometry (``csrc/attn_energy.cu``): blocks of ``WARPS`` warps, a
warp spanning ``CHUNK`` columns of A. K1 takes ``WARPS`` x
``FWD_ROWS[dtype]`` rows of one batch row per block (``fwd_grid``). K2 is
one launch of one thread-block cluster per batch row, its blocks taking
consecutive chunks of the rows (``bwd_plan``); dv is summed by the last
cluster to finish, behind a counter (one per device and stream,
``_ticket``), so calls in flight on two streams never share one.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tacotron_tpu_torch import runtime

WARPS = 8                    # warps per block, both kernels
CHUNK = 256                  # columns a warp spans: 8 a lane
FWD_ROWS = {torch.float32: 1, torch.bfloat16: 2}   # K1 rows per warp
BWD_CLUSTERS = (8, 4, 2)     # K2 cluster sizes, largest first (portable)


def fwd_grid(b: int, t: int, dtype=torch.float32) -> tuple[int, int]:
    """K1's (blocks, threads per block) for keys of ``dtype``: ceil(T /
    (WARPS FWD_ROWS[dtype])) blocks per batch row, none spanning two."""
    return b * -(-t // (WARPS * FWD_ROWS[dtype])), WARPS * 32


class BwdPlan(NamedTuple):
    cluster: int             # blocks per batch row (one cluster)
    rows: int                # rows of the batch row per block, the last may take fewer


def bwd_plan(b: int, t: int, resident: dict[int, int]) -> BwdPlan:
    """K2's launch geometry for keys (b, t, A) on a card that holds
    ``resident[C]`` clusters of C K2 blocks at once: the largest cluster of
    ``BWD_CLUSTERS`` with all b clusters resident at once (2 when none is:
    any b runs, in waves, since no cluster waits on another), no larger than
    the largest power of 2 that is at most t (1 for t 1); each block takes
    ceil(t / C) consecutive rows. A does not enter: every block walks all
    of it."""
    c = next((c for c in BWD_CLUSTERS if resident.get(c, 0) >= b), BWD_CLUSTERS[-1])
    c = min(c, 1 << (t.bit_length() - 1))
    return BwdPlan(c, -(-t // c))


def energy_tanh(keys, q):
    """The plain formula's (B, T_in, A) tanh, in the dtype of ``keys``/``q``."""
    return torch.tanh(keys + q[:, None, :])


def energy_contract(t, v):
    """The tanh contracted with ``v`` in f32 -> (B, T_in) f32."""
    return (t.float() @ v.float()).squeeze(-1)


def attention_energy_reference(keys, q, v):
    """The plain formula, as the JAX package's XLA path: tanh in the dtype of
    ``keys``/``q``, contracted with ``v`` in f32 -> (B, T_in) f32."""
    return energy_contract(energy_tanh(keys, q), v)


def energy_bwd_reference(keys, q, v, de):
    """K2's function in plain PyTorch: the tanh in the dtype of ``keys``/``q``,
    widened; ``w = (de v) (1 - t^2)`` in f32, one rounding per operation;
    ``dkeys = w`` and ``dq = sum_t w`` rounded to the dtype of keys/q, ``dv =
    sum_{b,t} t de`` in f32, in ``v``'s shape and dtype."""
    t = torch.tanh(keys + q[:, None, :]).float()
    de3 = de.float()[..., None]
    w = de3 * v.float().reshape(-1) * (1.0 - t * t)
    dv = (t * de3).sum((0, 1)).reshape(v.shape).to(v.dtype)
    return w.to(keys.dtype), w.sum(1).to(q.dtype), dv


def attention_energy(keys, q, v):
    """keys (B, T_in, A), q (B, A), v (A, 1) -> energies (B, T_in) f32,
    differentiable in all three."""
    if keys.device.type == "cpu":
        return attention_energy_reference(keys, q, v)
    return _FusedEnergy.apply(keys, q, v)


class _FusedEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, keys, q, v):
        ctx.save_for_backward(keys, q, v)
        return energy_fwd(keys, q, v)

    @staticmethod
    def backward(ctx, de):
        return energy_bwd(*ctx.saved_tensors, de)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = runtime.load("attn_energy")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tt_attn_energy_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.tt_attn_energy_bwd.argtypes = [vp] * 9 + [ci] * 7 + [vp]
        lib.tt_attn_energy_bwd_resident.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.tt_attn_energy_fwd.restype = ci
        lib.tt_attn_energy_bwd.restype = ci
        lib.tt_attn_energy_bwd_resident.restype = ci
        _LIB = lib
    return _LIB


_STORAGE = (torch.float32, torch.bfloat16)


def _inputs(keys, q, v, *extra):
    """Checked contiguous CUDA views of the kernel's inputs (keys and q in
    their common storage dtype; v, and de when given, widened to f32) and
    the geometry (B, T_in, A)."""
    if keys.device.type != "cuda":
        raise ValueError(f"attention energy kernels need CUDA tensors, got {keys.device}")
    if keys.ndim != 3 or 0 in keys.shape:
        raise ValueError(f"keys must be (B, T_in, A) and non-empty, got {tuple(keys.shape)}")
    if keys.dtype not in _STORAGE or q.dtype != keys.dtype:
        raise TypeError(f"attention energy kernels take keys and q both f32 or both bf16; "
                        f"got keys {keys.dtype}, q {q.dtype}")
    if not (v.is_floating_point() and all(x.is_floating_point() for x in extra)):
        raise TypeError("attention energy kernels take floating-point v and de")
    b, t, a = keys.shape
    want = {"keys": (keys, (b, t, a)), "q": (q, (b, a)), "v": (v.float(), (a, 1))}
    if extra:
        want["de"] = (extra[0].float(), (b, t))
    out = []
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != keys.device:
            raise ValueError(f"{name} is on {x.device}, keys on {keys.device}")
        out.append(x.contiguous())
    return out, (b, t, a)


def _vec(a, *tensors):
    """1 when the kernels may move 16-byte vectors: A a multiple of one
    vector of the storage dtype and every tensor 16-byte aligned."""
    per_16_bytes = 16 // tensors[0].element_size()
    return int(a % per_16_bytes == 0 and all(x.data_ptr() % 16 == 0 for x in tensors))


_RESIDENT: dict = {}
_TICKETS: dict = {}


def _index(dev) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def _resident(dev, bf16: bool) -> dict[int, int]:
    """{C: clusters of C K2 blocks the card holds at once}, by the CUDA
    occupancy calculator; cached."""
    key = (_index(dev), bf16)
    if key not in _RESIDENT:
        counts = {}
        with torch.cuda.device(dev):
            for c in BWD_CLUSTERS:
                n = ctypes.c_int(0)
                runtime.check(_lib().tt_attn_energy_bwd_resident(int(bf16), c, ctypes.byref(n)),
                              f"attn_energy_bwd residency query, cluster {c}")
                counts[c] = n.value
        _RESIDENT[key] = counts
    return _RESIDENT[key]


def plan_of(keys) -> BwdPlan:
    """``bwd_plan`` for K2 on these CUDA keys."""
    b, t, _ = keys.shape
    return bwd_plan(b, t, _resident(keys.device, keys.dtype == torch.bfloat16))


def _ticket(dev, stream=None) -> torch.Tensor:
    """K2's counter of finished clusters for calls on ``stream`` (None: the
    current one) of ``dev``: one int, zeroed once here, on that stream, and
    left at 0 by every call. Calls on one stream run in order, so they
    never hold it at once; calls on two streams hold two counters."""
    i = _index(dev)
    s = runtime.stream_ptr(dev) if stream is None else stream.cuda_stream
    if (i, s) not in _TICKETS:
        with torch.cuda.device(i), torch.cuda.stream(
                stream or torch.cuda.current_stream(i)):
            _TICKETS[(i, s)] = torch.zeros(1, dtype=torch.int32, device=f"cuda:{i}")
    return _TICKETS[(i, s)]


def energy_fwd(keys, q, v):
    """K1: launch the forward kernel -> e (B, T_in) f32."""
    (keys, q, v), (b, t, a) = _inputs(keys, q, v)
    vec = _vec(a, keys, q, v)
    e = torch.empty(b, t, device=keys.device)
    with torch.cuda.device(keys.device):
        err = _lib().tt_attn_energy_fwd(keys.data_ptr(), q.data_ptr(), v.data_ptr(),
                                        e.data_ptr(), b, t, a, vec,
                                        int(keys.dtype == torch.bfloat16),
                                        runtime.stream_ptr(keys.device))
    runtime.check(err, "attn_energy_fwd kernel launch")
    runtime.LAUNCHES["attn_energy_fwd"] += 1
    return e


def energy_bwd(keys, q, v, de, *, _cluster=None):
    """K2: launch the backward kernel (one launch) -> (dkeys, dq, dv) shaped
    like (keys, q, v): dkeys and dq in the dtype of keys/q, dv in v's.
    ``_cluster`` pins the cluster size (tests, timing); None takes
    ``bwd_plan``'s."""
    v_dtype = v.dtype
    (keys, q, v, de), (b, t, a) = _inputs(keys, q, v, de)
    dev = keys.device
    plan = plan_of(keys)
    if _cluster is not None:
        plan = plan._replace(cluster=_cluster, rows=-(-t // _cluster))
    dkeys, dq = torch.empty_like(keys), torch.empty_like(q)
    dv = torch.empty_like(v)
    dv_part = torch.empty(b, a, device=dev)
    with torch.cuda.device(dev):
        err = _lib().tt_attn_energy_bwd(
            keys.data_ptr(), q.data_ptr(), v.data_ptr(), de.data_ptr(),
            dkeys.data_ptr(), dq.data_ptr(), dv.data_ptr(), dv_part.data_ptr(),
            _ticket(dev).data_ptr(), b, t, a, plan.cluster, plan.rows,
            _vec(a, keys, q, v, dkeys), int(keys.dtype == torch.bfloat16),
            runtime.stream_ptr(dev))
    runtime.check(err, "attn_energy_bwd kernel launch")
    runtime.LAUNCHES["attn_energy_bwd"] += 1
    return dkeys, dq, dv.to(v_dtype)
