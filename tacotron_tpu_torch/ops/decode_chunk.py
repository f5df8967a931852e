"""The step decode's kernel: a chunk of feed-previous decoder steps in f32 in
one launch (``csrc/decode_chunk.cu``).

Two decodes run through it on a CUDA device, and neither has a TPU kernel
of its own (JAX runs them as XLA loops):

* the early-exit decode's chunk (``infer/early_exit.py`` ``WhileDecode``):
  one launch runs the chunk's steps and applies the exit rule, writing the
  carry (``t``, ``silent_run``, ``slot``, the done flag) back in place;
* the fixed-length decode (``models/decoder.py`` ``Decoder`` in f32 with the
  ``"xla"`` energy, ``decode_steps`` here), in launches of up to
  ``CHUNK_MAX`` steps with no exit rule.

Both compute ``while_decoder_step``'s step, which is the step-by-step
cell's, in f32 without TF32; the sums are taken in the kernel's order, so
they match the plain steps to rounding, not bit for bit. The kernel reads
the step state at the start of a launch and writes it back at the end, so
how a decode is cut into launches changes no bit, and an early exit at a
threshold that never trips gives the fixed decode's output bit for bit.

Dropout: the caller draws the pre-net's masks as the plain step draws them
(``draw_masks``: per step a (B, P0) and a (B, P1) uniform draw, in that
order, from the call's generator) and hands them to the launch, which keeps
a unit where its draw is below 1 - rate. The cluster size follows
``ops/decode_loop.py::cluster_size``, from this kernel's resident clusters.
"""

from __future__ import annotations

import ctypes

import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.ops.attention import NEG_INF
from tacotron_tpu_torch.ops.decode_loop import CLUSTER_SIZES, DecoderWeights, cluster_size
from tacotron_tpu_torch.ops.modules import dropout_uniform

# steps one launch runs at most (csrc/decode_chunk.cu's kMaxChunk); the
# fixed-length decode's launches take this many
CHUNK_MAX = 64


def decode_inputs(memory, keys, mask):
    """-> (memory f32, keys f32, the mask as a 0 / ``NEG_INF`` bias (B, T_in)
    f32): the step's inputs, bf16 keys widened."""
    b, t_in, _ = memory.shape
    bias = (torch.zeros(b, t_in, device=memory.device) if mask is None
            else torch.where(mask, 0.0, NEG_INF))
    return memory.float(), keys.float(), bias


def zero_state(b: int, m_dim: int, w: DecoderWeights, device):
    """The decoder state at step 0: (h_att, h0, h1, context, previous frame)."""
    h0 = torch.zeros(b, w.d0_wc.shape[0], device=device)
    return (torch.zeros(b, w.ag_wc.shape[0], device=device), h0, torch.zeros_like(h0),
            torch.zeros(b, m_dim, device=device), torch.zeros(b, w.p_w0.shape[1], device=device))


def draw_masks(b: int, w: DecoderWeights, steps: int, rate: float, generator, device):
    """The pre-net's uniform draws of ``steps`` decoder steps, in the plain
    step's order: per step (B, P0) then (B, P1), each what ``dropout`` draws
    for that layer (``modules.dropout_uniform``); none at rate 0."""
    if rate <= 0.0:
        return []
    dims = (w.p_w0.shape[0], w.p_w1.shape[0])
    return [dropout_uniform((b, d), generator, device) for _ in range(steps) for d in dims]


def _library():
    lib = runtime.load("decode_chunk")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tt_decode_chunk.argtypes = [vp, vp, vp, vp, vp, ci, vp, ci, cf, cf, vp, vp, vp, ci, ci,
                                    vp, cf, ci, ci, ci, vp]
    lib.tt_decode_chunk.restype = ci
    lib.tt_decode_chunk_smem.argtypes = [vp, ci]
    lib.tt_decode_chunk_smem.restype = ctypes.c_longlong
    lib.tt_decode_chunk_resident.argtypes = [vp, ci, ci, vp]
    lib.tt_decode_chunk_resident.restype = ci
    return lib


_RESIDENT: dict = {}


def resident(dims, n: int, dev: torch.device) -> dict[int, int]:
    """{C: clusters of C blocks the card holds at once} for a launch of ``n``
    steps at ``dims``, by the CUDA occupancy calculator; cached."""
    lib = _library()
    arr = (ctypes.c_int * 10)(*dims)
    key = (dev.index, lib.tt_decode_chunk_smem(ctypes.cast(arr, ctypes.c_void_p), n))
    if key not in _RESIDENT:
        runtime.fill_outside_capture("the step decode's residency table")
        counts = {}
        with torch.cuda.device(dev):
            for c in CLUSTER_SIZES:
                k = ctypes.c_int(0)
                runtime.check(lib.tt_decode_chunk_resident(ctypes.cast(arr, ctypes.c_void_p), n,
                                                           c, ctypes.byref(k)),
                              f"decode_chunk residency query, cluster {c}")
                counts[c] = k.value
        _RESIDENT[key] = counts
    return _RESIDENT[key]


class ExitCarry:
    """The early-exit rule's device state beside the outputs: ``t`` (0-d
    int64), ``run`` (B,) int64, ``slot`` (1,) int64, ``done`` (0-d bool),
    and the kernel's scratch (a (B, ``CHUNK_MAX``) int32 of silent flags
    and its ticket counter), with the rule's constants."""

    def __init__(self, t, run, slot, done, *, threshold: float, min_steps: int, n_steps: int):
        dev = run.device
        self.t, self.run, self.slot, self.done = t, run, slot, done
        self.silent = torch.zeros(run.shape[0], CHUNK_MAX, dtype=torch.int32, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.threshold, self.min_steps, self.n_steps = threshold, min_steps, n_steps


class DecodeChunk:
    """One decode's launches: the inputs, weights, state and output buffers,
    checked and laid out once. ``launch(masks, n, slot0)`` runs ``n``
    steps from the state (written back in place) into slots ``slot0 ..
    slot0 + n`` of ``frames`` (B, S, r n_mels) and ``aligns`` (B, S, T_in);
    with an ``ExitCarry`` the slots start at its ``slot`` and the launch
    applies the exit rule. ``_cluster`` pins the cluster size (tests);
    None takes ``cluster_size``'s for the batch."""

    def __init__(self, memory, keys, bias, w: DecoderWeights, state, frames, aligns, *,
                 dropout_rate: float, exit: ExitCarry | None = None, _cluster=None):
        dev = memory.device
        if dev.type != "cuda":
            raise ValueError(f"decode_chunk: unsupported device {dev}")
        b, t_in, m_dim = memory.shape
        n_mels, p0, p1 = w.p_w0.shape[1], w.p_w0.shape[0], w.p_w1.shape[0]
        ag, att, dd = w.ag_wc.shape[0], w.at_wq.shape[0], w.d0_wc.shape[0]
        r = w.f_w.shape[0] // n_mels
        if (tuple(keys.shape) != (b, t_in, att) or frames.shape[2] != r * n_mels
                or tuple(aligns.shape) != (*frames.shape[:2], t_in)):
            raise ValueError(f"decode_chunk: keys {tuple(keys.shape)}, frames "
                             f"{tuple(frames.shape)} and alignments {tuple(aligns.shape)} do "
                             f"not match the memory {tuple(memory.shape)} and the weights")

        def f32(t):
            t = t.float().contiguous()
            return t if t.data_ptr() % 16 == 0 else t.clone()

        self._keep = [f32(memory), f32(keys), f32(bias), *(f32(x) for x in w)]
        for x in (*state, frames, aligns):
            if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev:
                raise ValueError("decode_chunk: the state and the outputs are contiguous f32 "
                                 f"tensors on {dev}")
        self.dims = (b, t_in, m_dim, att, n_mels, r, p0, p1, ag, dd)
        self.dev, self.b = dev, b
        self.rate = dropout_rate
        self.state = tuple(state)
        self.frames, self.aligns, self.exit = frames, aligns, exit
        self._dims = (ctypes.c_int * 10)(*self.dims)
        self._weights = (ctypes.c_void_p * 22)(*[x.data_ptr() for x in self._keep[3:]])
        self._state = (ctypes.c_void_p * 5)(*[x.data_ptr() for x in state])
        self._exit = None
        if exit is not None:
            self._exit = (ctypes.c_void_p * 6)(*[x.data_ptr() for x in (
                exit.t, exit.run, exit.slot, exit.done, exit.silent, exit.ticket)])
        self._cluster = _cluster

    def cluster(self, n: int) -> int:
        """The cluster size of a launch of ``n`` steps."""
        if self._cluster is not None:
            return int(self._cluster)
        return cluster_size(self.b, resident(self.dims, n, self.dev))

    def launch(self, masks, n: int, slot0: int = 0) -> None:
        if not 1 <= n <= CHUNK_MAX:
            raise ValueError(f"decode_chunk: {n} steps a launch, not in 1..{CHUNK_MAX}")
        dropout = self.rate > 0.0
        if dropout and len(masks) != 2 * n:
            raise ValueError(f"decode_chunk: {len(masks)} masks for {n} steps")
        lib = _library()
        vp = ctypes.c_void_p
        limit = getattr(torch.cuda.get_device_properties(self.dev),
                        "shared_memory_per_block_optin", 232448)
        smem = lib.tt_decode_chunk_smem(ctypes.cast(self._dims, vp), n)
        if smem > limit:
            raise ValueError(f"decode_chunk: needs {smem} B of shared memory per block "
                             f"(T_in {self.dims[1]}); the device allows {limit}")
        mk = (vp * (2 * n))(*[u.data_ptr() for u in masks]) if dropout else None
        keep = 1.0 - self.rate
        ex = self.exit
        mem, keys, bias = self._keep[:3]
        with torch.cuda.device(self.dev):
            err = lib.tt_decode_chunk(
                mem.data_ptr(), keys.data_ptr(), bias.data_ptr(), ctypes.cast(self._weights, vp),
                ctypes.cast(self._dims, vp), n, ctypes.cast(mk, vp) if mk is not None else None,
                int(dropout), keep, 1.0 / keep if keep > 0 else 0.0,
                ctypes.cast(self._state, vp), self.frames.data_ptr(), self.aligns.data_ptr(),
                self.frames.shape[1], int(slot0),
                ctypes.cast(self._exit, vp) if ex is not None else None,
                ex.threshold if ex is not None else 0.0, ex.min_steps if ex is not None else 0,
                ex.n_steps if ex is not None else 0, self.cluster(n),
                runtime.stream_ptr(self.dev))
        runtime.check(err, f"decode_chunk kernel launch ({n} steps)")
        runtime.LAUNCHES["decode_chunk"] += 1


def decode_steps(memory, keys, mask, w: DecoderWeights, generator=None, *, n_steps: int,
                 dropout_rate: float = 0.0):
    """The fixed-length feed-previous decode on a CUDA device through the
    kernel, in launches of up to ``CHUNK_MAX`` steps, each after its steps'
    mask draws -> (frames (B, n_steps, r n_mels), alignments (B, n_steps,
    T_in)). The generator advances as the plain decode advances it."""
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    b, t_in, _ = memory.shape
    dev = memory.device
    mem, keys, bias = decode_inputs(memory, keys, mask)
    frames = torch.empty(b, n_steps, w.f_w.shape[0], device=dev)
    aligns = torch.empty(b, n_steps, t_in, device=dev)
    run = DecodeChunk(mem, keys, bias, w, zero_state(b, mem.shape[2], w, dev), frames, aligns,
                      dropout_rate=dropout_rate)
    for s0 in range(0, n_steps, CHUNK_MAX):
        n = min(CHUNK_MAX, n_steps - s0)
        run.launch(draw_masks(b, w, n, dropout_rate, generator, dev), n, s0)
    return frames, aligns
