"""Fused autoregressive decode: the whole feed-previous decode in one kernel.

Port of the JAX package's ``ops/pallas/decode_loop.py`` (TPU kernel K3).
``decode_loop`` launches the hand-written CUDA kernel
(``csrc/decode_loop.cu``) for CUDA tensors and runs the plain PyTorch
version, ``decode_loop_reference``, for CPU tensors. Both run every step —
prenet (with dropout), attention GRU, Bahdanau energy / masked softmax /
context, input projection, two residual GRUs, r-frame projection — and keep
the TPU kernel's rounding points in the storage dtype (bf16 when
``lowp``, else f32): every product input is rounded to it with f32
accumulation, the energy is ``tanh(keys + q)`` in it, the v-contraction is
f32, and the context product is formed in it and summed in f32.

The kernel runs each batch row on a thread-block cluster of C blocks, one
per SM, each phase of a step split over the cluster (``cluster_slice``);
``cluster_size`` picks C from the card's count of resident clusters.

Dropout cannot reproduce the TPU's hardware PRNG. The kernel uses a
counter-based hash keyed by (seed, row, step, layer, unit) and keeps a unit
iff its 32 bits are below ``keep * 2^32``; the plain version draws from a
``torch.Generator``. ``dropout_rate=0`` is a true no-op in both. The
kernel reads its seed from device memory, so a seed drawn on the device
(``torch.randint(..., device=...)``, as JAX draws it inside its jit)
reaches it without a host read, inside a CUDA graph too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.ops import modules
from tacotron_tpu_torch.ops.attention import NEG_INF

# the kernel's cluster sizes (blocks per batch row); 16 is non-portable
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def cluster_slice(n: int, c: int, r: int) -> tuple[int, int]:
    """The items [lo, hi) of ``n`` that rank ``r`` of a cluster of ``c``
    computes: ``csrc/decode_loop.cu``'s ``Slice``."""
    return r * n // c, (r + 1) * n // c


def cluster_size(b: int, resident: dict[int, int]) -> int:
    """The kernel's cluster size for a batch of ``b`` rows: the largest C of
    ``CLUSTER_SIZES`` with every one of the ``b`` clusters resident at once
    (``resident[C] >= b``, the card's count of clusters of C blocks it holds
    at once; a block takes an SM, so the clusters also fit on the SMs); 1
    when none is."""
    return max((c for c in CLUSTER_SIZES if resident.get(c, 0) >= b), default=1)


class DecoderWeights(NamedTuple):
    """Decoder weights in PyTorch's (out, in) layout; GRU weights keep the
    fused [x, h] input layout of ``GRUCell``; ``at_v`` is (attention_dim,)."""

    p_w0: torch.Tensor; p_b0: torch.Tensor; p_w1: torch.Tensor; p_b1: torch.Tensor
    ag_wg: torch.Tensor; ag_bg: torch.Tensor; ag_wc: torch.Tensor; ag_bc: torch.Tensor
    at_wq: torch.Tensor; at_v: torch.Tensor
    ip_w: torch.Tensor; ip_b: torch.Tensor
    d0_wg: torch.Tensor; d0_bg: torch.Tensor; d0_wc: torch.Tensor; d0_bc: torch.Tensor
    d1_wg: torch.Tensor; d1_bg: torch.Tensor; d1_wc: torch.Tensor; d1_bc: torch.Tensor
    f_w: torch.Tensor; f_b: torch.Tensor


def pack_decoder_weights(cell) -> DecoderWeights:
    """``DecoderCell`` -> DecoderWeights. The kernel
    runs exactly two residual decoder GRUs, as the TPU kernel does."""
    sd = dict(cell.named_parameters())
    if "decoder_gru2.gates.weight" in sd or "decoder_gru1.gates.weight" not in sd:
        raise ValueError("the fused decode runs exactly 2 decoder GRUs")

    def gru(name):
        return (sd[f"{name}.gates.weight"], sd[f"{name}.gates.bias"],
                sd[f"{name}.candidate.weight"], sd[f"{name}.candidate.bias"])

    return DecoderWeights(
        sd["prenet.fc0.weight"], sd["prenet.fc0.bias"],
        sd["prenet.fc1.weight"], sd["prenet.fc1.bias"],
        *gru("attention_gru"),
        sd["attention.query.weight"], sd["attention.v"].reshape(-1),
        sd["decoder_input_proj.weight"], sd["decoder_input_proj.bias"],
        *gru("decoder_gru0"), *gru("decoder_gru1"),
        sd["frame_proj.weight"], sd["frame_proj.bias"],
    )


def _geometry(memory, keys, weights: DecoderWeights):
    b, t_in, m = memory.shape
    n_mels = weights.p_w0.shape[1]
    r_nm = weights.f_w.shape[0]
    if r_nm % n_mels:
        raise ValueError(f"frame projection width {r_nm} is not r * n_mels ({n_mels})")
    return b, t_in, m, n_mels, r_nm // n_mels


def _maskbias(mask, b, t_in, device):
    if mask is None:
        return torch.zeros(b, t_in, device=device)
    return torch.where(mask.to(device), 0.0, NEG_INF).float().contiguous()


def packed_decoder_step(memory, keys, mask, weights: DecoderWeights, *,
                        dropout_rate: float, lowp: bool,
                        generator: torch.Generator | None):
    """(initial state, ``step``) of the decoder over the packed weights.
    ``state, frames, alpha = step(state)`` runs one feed-previous step:
    prenet (dropout masks from ``generator``), attention GRU, Bahdanau
    attention, input projection, two residual GRUs, r-frame projection,
    with every product input rounded to the storage dtype (bf16 when
    ``lowp``; f32 storage rounds nothing), and the attention's reductions
    in the kernel's forms (the scores summed over the attention width, the
    context over the memory's time). The fused decode's plain version loops
    over it; the early-exit decode has a step of its own, in the
    step-by-step cell's forms (``infer/early_exit.py::while_decoder_step``)."""
    sd = torch.bfloat16 if lowp else torch.float32
    b, t_in, m_dim, n_mels, r = _geometry(memory, keys, weights)
    w = DecoderWeights(*[x.to(sd).float() for x in weights])  # rounded storage
    mem = memory.to(sd)
    keys_s = keys.to(sd)
    maskbias = _maskbias(mask, b, t_in, memory.device)
    dev = memory.device

    def dot(x, wt, bias=None):
        return F.linear(x.to(sd).float(), wt, bias)

    def drop(x):
        return modules.dropout(x, dropout_rate, generator)

    def gru(h, x, wg, bg, wc, bc):
        ru = torch.sigmoid(dot(torch.cat([x, h], -1), wg, bg))
        rr, u = ru.chunk(2, dim=-1)
        c = torch.tanh(dot(torch.cat([x, rr * h], -1), wc, bc))
        return u * h + (1.0 - u) * c

    def step(state):
        h_att, h0, h1, ctx, prev = state
        x = drop(torch.relu(dot(prev, w.p_w0, w.p_b0)))
        x = drop(torch.relu(dot(x, w.p_w1, w.p_b1)))
        h_att = gru(h_att, torch.cat([x, ctx], -1), w.ag_wg, w.ag_bg, w.ag_wc, w.ag_bc)
        q = dot(h_att, w.at_wq)
        e = torch.tanh(keys_s + q.to(sd)[:, None, :])
        scores = (e.float() * w.at_v).sum(-1) + maskbias
        alpha = torch.softmax(scores, dim=-1)
        ctx = (alpha.to(sd)[..., None] * mem).float().sum(1)
        h = dot(torch.cat([h_att, ctx], -1), w.ip_w, w.ip_b)
        h0 = gru(h0, h, w.d0_wg, w.d0_bg, w.d0_wc, w.d0_bc)
        h = h + h0
        h1 = gru(h1, h, w.d1_wg, w.d1_bg, w.d1_wc, w.d1_bc)
        h = h + h1
        frames = dot(h, w.f_w, w.f_b)
        prev = frames[:, (r - 1) * n_mels:r * n_mels]
        return (h_att, h0, h1, ctx, prev), frames, alpha

    h0 = torch.zeros(b, w.d0_wc.shape[0], device=dev)
    state = (torch.zeros(b, w.ag_wc.shape[0], device=dev), h0, torch.zeros_like(h0),
             torch.zeros(b, m_dim, device=dev), torch.zeros(b, n_mels, device=dev))
    return state, step


def decode_loop_reference(memory, keys, mask, weights: DecoderWeights, *,
                          n_steps: int, dropout: bool = True,
                          dropout_rate: float = 0.5,
                          lowp: bool = True, generator: torch.Generator | None = None):
    """Plain PyTorch version of the fused decode (same semantics and
    rounding points as the kernel; dropout masks from ``generator``)."""
    state, step = packed_decoder_step(
        memory, keys, mask, weights, dropout_rate=dropout_rate if dropout else 0.0,
        lowp=lowp, generator=generator)
    frames_out, aligns_out = [], []
    for _ in range(n_steps):
        state, frames, alpha = step(state)
        frames_out.append(frames)
        aligns_out.append(alpha)
    return torch.stack(frames_out, 1), torch.stack(aligns_out, 1)


def decode_loop(memory, keys, mask, weights: DecoderWeights, *, n_steps: int,
                seed=0, dropout: bool = True, dropout_rate: float = 0.5,
                lowp: bool = True, generator: torch.Generator | None = None,
                return_keep_counts: bool = False):
    """Run the fused decode. memory (B, T_in, D_mem), keys (B, T_in, A),
    mask (B, T_in) bool or None.

    Returns (frames (B, n_steps, r*n_mels) f32, alignments (B, n_steps,
    T_in) f32). ``seed``: an int, or a one-element int64 tensor on the
    inputs' device. CUDA tensors launch the kernel (dropout keyed by the
    seed's low 32 bits, which the kernel reads from device memory;
    ``return_keep_counts`` adds a third output, (B, n_steps) int32 counts of
    prenet units kept); CPU tensors run ``decode_loop_reference`` (dropout
    from ``generator``, default seeded with ``seed``).
    """
    if memory.device.type == "cpu":
        if return_keep_counts:
            raise ValueError("keep counts come from the CUDA kernel only")
        if generator is None:
            generator = torch.Generator().manual_seed(int(seed))
        return decode_loop_reference(
            memory, keys, mask, weights, n_steps=n_steps, dropout=dropout,
            dropout_rate=dropout_rate, lowp=lowp, generator=generator)
    return _decode_loop_cuda(memory, keys, mask, weights, n_steps=n_steps,
                             seed=seed, dropout=dropout,
                             dropout_rate=dropout_rate,
                             lowp=lowp, return_keep_counts=return_keep_counts)


def _check_geometry(memory, keys, mask, weights: DecoderWeights):
    """The kernel's shape checks -> (b, t_in, m_dim, att, n_mels, r, p0, p1,
    ag, dd)."""
    b, t_in, m_dim, n_mels, r = _geometry(memory, keys, weights)
    att = weights.at_wq.shape[0]
    ag = weights.ag_wc.shape[0]
    dd = weights.d0_wc.shape[0]
    p0, p1 = weights.p_w0.shape[0], weights.p_w1.shape[0]
    expect = {
        "keys": (keys.shape, (b, t_in, att)),
        "p_w1": (weights.p_w1.shape, (p1, p0)),
        "ag_wg": (weights.ag_wg.shape, (2 * ag, p1 + m_dim + ag)),
        "ag_wc": (weights.ag_wc.shape, (ag, p1 + m_dim + ag)),
        "at_wq": (weights.at_wq.shape, (att, ag)),
        "at_v": (weights.at_v.shape, (att,)),
        "ip_w": (weights.ip_w.shape, (dd, ag + m_dim)),
        "d0_wg": (weights.d0_wg.shape, (2 * dd, 2 * dd)),
        "d1_wg": (weights.d1_wg.shape, (2 * dd, 2 * dd)),
        "f_w": (weights.f_w.shape, (r * n_mels, dd)),
    }
    for name, (got, want) in expect.items():
        if tuple(got) != want:
            raise ValueError(f"decode_loop: {name} has shape {tuple(got)}, expected {want}")
    if mask is not None and tuple(mask.shape) != (b, t_in):
        raise ValueError(f"decode_loop: mask shape {tuple(mask.shape)} != {(b, t_in)}")
    return b, t_in, m_dim, att, n_mels, r, p0, p1, ag, dd


def _library():
    lib = runtime.load("decode_loop")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tt_decode_loop_smem.argtypes = [vp]
    lib.tt_decode_loop_smem.restype = ctypes.c_longlong
    lib.tt_decode_loop_resident.argtypes = [vp, ci, ci, vp]
    lib.tt_decode_loop_resident.restype = ci
    lib.tt_decode_loop.argtypes = [vp, vp, vp, vp, vp, ci, ci,
                                   vp, ctypes.c_uint32, ctypes.c_float,
                                   ci, vp, vp, vp, vp]
    lib.tt_decode_loop.restype = ci
    return lib


_RESIDENT: dict = {}


def _resident(lib, dims, lowp: bool, dev: torch.device) -> dict[int, int]:
    """{C: clusters of C blocks the card holds at once} for this launch's
    shared memory, by the CUDA occupancy calculator; cached."""
    key = (dev.index, lowp, lib.tt_decode_loop_smem(ctypes.cast(dims, ctypes.c_void_p)))
    if key not in _RESIDENT:
        runtime.fill_outside_capture("K3's residency table")
        counts = {}
        with torch.cuda.device(dev):
            for c in CLUSTER_SIZES:
                n = ctypes.c_int(0)
                runtime.check(lib.tt_decode_loop_resident(ctypes.cast(dims, ctypes.c_void_p),
                                                          int(lowp), c, ctypes.byref(n)),
                              f"decode_loop residency query, cluster {c}")
                counts[c] = n.value
        _RESIDENT[key] = counts
    return _RESIDENT[key]


def _plan(lib, dims, lowp: bool, dev: torch.device):
    resident = _resident(lib, dims, lowp, dev)
    return cluster_size(dims[0], resident), resident


def cluster_plan(memory, keys, weights: DecoderWeights, *, lowp: bool = True):
    """(C, {C: resident clusters}) of the kernel's launch on these CUDA
    inputs: the cluster size ``decode_loop`` takes and the counts it took it
    from."""
    dims = (ctypes.c_int * 11)(*_check_geometry(memory, keys, None, weights)[:10], 1)
    return _plan(_library(), dims, bool(lowp), memory.device)


def _decode_loop_cuda(memory, keys, mask, weights, *, n_steps, seed, dropout,
                      dropout_rate, lowp, return_keep_counts, _cluster=None):
    """The kernel's launch. ``_cluster`` pins the cluster size (tests and
    the timing sweep); None takes ``cluster_size``'s. An int ``seed`` is
    written to the device by a fill (no copy from the host), so a capture
    may take one; it is then a constant of the graph."""
    dev = memory.device
    if dev.type != "cuda":
        raise ValueError(f"decode_loop: unsupported device {dev}")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    sd = torch.bfloat16 if lowp else torch.float32
    geometry = _check_geometry(memory, keys, mask, weights)
    b, t_in, m_dim, _, n_mels, r = geometry[:6]
    tensors = [memory, keys, *weights] + ([mask] if mask is not None else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("decode_loop: all inputs must be on one CUDA device")

    def storage(t):
        t = t.to(sd).contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    if isinstance(seed, torch.Tensor):
        if seed.device != dev or seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"decode_loop: the seed tensor must be one int64 on {dev}, got "
                             f"{seed.numel()} x {seed.dtype} on {seed.device}")
        seed_t = seed.contiguous()
    else:
        seed_t = torch.full((1,), int(seed) & 0xFFFFFFFF, dtype=torch.int64, device=dev)
    mem_s, keys_s = storage(memory), storage(keys)
    w_s = [storage(t) for t in weights]
    maskbias = _maskbias(mask, b, t_in, dev)
    dims = (ctypes.c_int * 11)(*geometry, n_steps)
    vp = ctypes.c_void_p
    lib = _library()
    smem = lib.tt_decode_loop_smem(ctypes.cast(dims, vp))
    limit = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise ValueError(f"decode_loop: needs {smem} B of shared memory per "
                         f"block (T_in {t_in}); the device allows {limit}")
    if _cluster is None:
        cluster = _plan(lib, dims, bool(lowp), dev)[0]
    elif 1 <= int(_cluster) <= CLUSTER_SIZES[-1]:
        cluster = int(_cluster)
    else:
        raise ValueError(f"decode_loop: cluster size {_cluster} not in 1..{CLUSTER_SIZES[-1]}")

    frames = torch.empty(b, n_steps, r * n_mels, device=dev)
    aligns = torch.empty(b, n_steps, t_in, device=dev)
    counts = (torch.empty(b, n_steps, device=dev, dtype=torch.int32)
              if return_keep_counts else None)
    use_dropout = dropout and dropout_rate > 0.0
    keep = 1.0 - dropout_rate
    threshold = min(int(keep * 2.0 ** 32), 2 ** 32 - 1) if use_dropout else 0
    keep_scale = 1.0 / keep if keep > 0 else 0.0
    ptrs = (ctypes.c_void_p * 22)(*[t.data_ptr() for t in w_s])

    with torch.cuda.device(dev):
        err = lib.tt_decode_loop(
            mem_s.data_ptr(), keys_s.data_ptr(), maskbias.data_ptr(),
            ctypes.cast(ptrs, vp), ctypes.cast(dims, vp), int(lowp), cluster,
            seed_t.data_ptr(), threshold, keep_scale, int(use_dropout),
            frames.data_ptr(), aligns.data_ptr(),
            counts.data_ptr() if counts is not None else None,
            runtime.stream_ptr(dev))
    runtime.check(err, f"decode_loop kernel launch (cluster {cluster})")
    runtime.LAUNCHES["decode_loop"] += 1
    if return_keep_counts:
        return frames, aligns, counts
    return frames, aligns
