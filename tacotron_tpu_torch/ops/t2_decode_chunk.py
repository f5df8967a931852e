"""Tacotron 2's step decode kernel: a chunk of ``tacotron2.decoder_step``s
and the stop gate's exit rule in f32 in one launch (``csrc/t2_decode_chunk.cu``),
the early-exit decode's chunk on a CUDA device (``infer/early_exit.py``
``WhileDecode`` given ``models/tacotron2.py`` ``StepWeights``). The JAX
package has no Tacotron 2, so no TPU kernel stands behind it;
``WhileDecode.run_chunk_plain`` is its plain counterpart.

The launch runs the chunk's steps over every batch row at once on
``BLOCKS`` persistent blocks, one a streaming multiprocessor, each owning
``MAX_UNITS`` units of both LSTMs, with grid-wide barriers between a step's
dependent phases; the weights are read in place from the model's parameter
tensors, every step streaming them from device memory (the kernel's header
says how). Every product and sum is f32 without TF32, taken in the kernel's
order, so it matches the plain step to rounding, not bit for bit. The state
is read at the start of a launch and written back by its end, so how a
decode is cut into launches changes no bit.

Dropout: the caller draws the pre-net's masks as the plain step draws them
(``decode_chunk.draw_masks``: per step a (B, P0) and a (B, P1) uniform
draw) and hands them to the launch, which keeps a unit where its draw is
below 1 - rate.

The kernel's limits are shapes (``refusal``): the LSTM widths a multiple of
``BLOCKS`` with at most ``MAX_UNITS`` units a block, widths that its stages
and warps tile, at most ``MAX_B`` rows, and shared memory for a ring of two
stages at least (on an H100 ``T_in`` up to 2,240 at B 8 and 384 at B 16).
Outside them this wrapper raises ``ValueError`` with the reason, and so
``WhileDecode`` does on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tacotron_tpu_torch import runtime

# csrc/t2_decode_chunk.cu's geometry
BLOCKS = 128          # persistent blocks, all resident at once
MAX_UNITS = 8         # units of each LSTM a block owns at most
STAGE_COLS = 128      # a ring stage's columns
STAGE_BYTES = 4 * MAX_UNITS * STAGE_COLS * 4
MAX_STAGES = 8
MAX_PLAN = 64         # ring stages a step
CHUNK_MAX = 64        # steps a launch
MAX_B = 16
MAX_FILTERS = 32      # location filters: one a lane
WARPS = 8             # chain warps and consumer warps at most
ACC = 64              # a consumer lane's accumulators
# the shared memory a block may use on an H100 (cudaDevAttrMaxSharedMemoryPerBlockOptin),
# and what the kernel declares statically (its mbarriers, the plan, flags and
# the exit rule's table: 2,800 B) at most
SMEM_LIMIT = 232448
SMEM_STATIC = 3072


class GateCarry(NamedTuple):
    """The stop gate's device carry beside the outputs (``WhileDecode``'s):
    ``t`` (0-d int64), ``ended`` (B,) bool, ``lengths`` (B,) int64, ``slot``
    (1,) int64, ``done`` (0-d bool); a row ends at its first step whose gate
    logit is over ``logit``; the loop runs at most ``n_steps``."""

    t: torch.Tensor
    ended: torch.Tensor
    lengths: torch.Tensor
    slot: torch.Tensor
    done: torch.Tensor
    logit: float
    n_steps: int


def step_dims(memory, keys, w) -> tuple:
    """(B, T_in, memory width, attention width, n_mels, r, pre-net widths,
    attention and decoder LSTM widths, location filters, location kernel
    width) of a step over ``w`` (``StepWeights``)."""
    b, t_in, m_dim = memory.shape
    n_mels = w.p_w0.shape[1]
    return (b, t_in, m_dim, keys.shape[-1], n_mels, w.f_w.shape[0] // n_mels,
            w.p_w0.shape[0], w.p_w1.shape[0], w.a_lstm[1].shape[1], w.d_lstm[1].shape[1],
            w.l_conv.shape[0], w.l_conv.shape[2])


def _up4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(dims, stages: int) -> int:
    """The dynamic shared memory of one block with a ring of ``stages``:
    ``csrc/t2_decode_chunk.cu``'s ``Layout`` (``library_smem``) mirrored, so
    that the limits need no card; a card test holds the two equal."""
    b, t, m, a, nm, _, p0, p1, ha, hd, f, kl = dims
    bt = 8 if b <= 8 else 16
    rp0, rp1, rq = -(-p0 // BLOCKS), -(-p1 // BLOCKS), -(-a // BLOCKS)
    items = -(-b * t // BLOCKS)
    heads = _up4(hd + m) + _up4(rp0 * nm) + _up4(rp1 * p0)
    lw = f if f // 4 % 2 else f + 4
    loc = _up4(f * 2 * kl) + a * lw + 4 * _up4(t + kl - 1)
    small = 16 * MAX_UNITS + _up4(rp0 + rp1) + 4 + _up4(a) + _up4(items) + _up4((rp0 + rp1) * MAX_B)
    floats = (stages * STAGE_BYTES // 4 + bt * ha + max(bt * m, rq * ha) + max(bt * hd, bt * p1, loc)
              + heads + 2 * WARPS * ACC + 3 * MAX_UNITS * MAX_B + items * a + small + 2 * _up4(t)
              + WARPS * 32)
    return 4 * floats


def stages_for(dims, limit: int = SMEM_LIMIT) -> int:
    """The ring's depth: as many stages as fit beside the rest, at most
    ``MAX_STAGES``."""
    free = limit - SMEM_STATIC - smem_bytes(dims, 0)
    return max(0, min(MAX_STAGES, free // STAGE_BYTES))


def refusal(dims, limit: int = SMEM_LIMIT) -> str | None:
    """Why the kernel cannot run a step of ``dims`` (``step_dims``) within
    ``limit`` bytes of shared memory a block, or None."""
    b, t, m, a, nm, r, p0, p1, ha, hd, f, kl = dims
    if not 1 <= b <= MAX_B:
        return f"batch {b} is not in 1..{MAX_B}"
    for name, h in (("attention", ha), ("decoder", hd)):
        if h % BLOCKS or h // BLOCKS > MAX_UNITS or h % STAGE_COLS:
            return (f"{name} LSTM width {h} is not a multiple of {BLOCKS} and "
                    f"{STAGE_COLS} with at most {MAX_UNITS} units a block")
    if m % STAGE_COLS or p1 % STAGE_COLS:
        return f"memory width {m} or pre-net width {p1} is not a multiple of {STAGE_COLS}"
    if a % 32 or a > 256 or f % 4 or not 1 <= f <= MAX_FILTERS or kl % 2 == 0:
        return (f"attention width {a} (a multiple of 32 up to 256), {f} location filters (a "
                f"multiple of 4 up to {MAX_FILTERS}) or location kernel {kl} (odd) out of range")
    if nm % 4 or p0 % 4 or nm > 512 or p0 > 512:
        return f"n_mels {nm} or pre-net width {p0} is not a multiple of 4 up to 512"
    if r * nm + 1 > BLOCKS or p0 < 1 or t < 1:
        return f"{r} x {nm} frame rows and the gate exceed {BLOCKS} blocks, or an empty width"
    if (2 * m + 2 * ha + p1 + hd) // STAGE_COLS > MAX_PLAN:
        return f"a step's {(2 * m + 2 * ha + p1 + hd) // STAGE_COLS} ring stages exceed {MAX_PLAN}"
    if stages_for(dims, limit) < 2:
        return (f"needs {smem_bytes(dims, 2) + SMEM_STATIC} B of shared memory a block for "
                f"a ring of 2 stages (B {b}, T_in {t}); the device allows {limit}")
    return None


def _library():
    lib = runtime.load("t2_decode_chunk")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tt_t2_decode_chunk.argtypes = [vp, vp, vp, vp, vp, ci, vp, ci, cf, cf, cf, ci, vp, vp,
                                       vp, ci, vp, cf, ci, vp, vp, vp]
    lib.tt_t2_decode_chunk.restype = ci
    lib.tt_t2_decode_smem.argtypes = [vp, ci]
    lib.tt_t2_decode_smem.restype = ctypes.c_longlong
    lib.tt_t2_decode_resident.argtypes = [vp, ci, vp]
    lib.tt_t2_decode_resident.restype = ci
    return lib


def _smem_limit(dev: torch.device) -> int:
    return getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                   SMEM_LIMIT)


def library_smem(dims, stages: int) -> int:
    """``smem_bytes`` as the built kernel's ``Layout`` gives it."""
    arr = (ctypes.c_int * 12)(*dims)
    return _library().tt_t2_decode_smem(ctypes.cast(arr, ctypes.c_void_p), stages)


_RESIDENT: dict = {}


def resident(dims, stages: int, dev: torch.device) -> int:
    """The kernel's blocks the card holds at once with a ring of ``stages``
    (the CUDA occupancy calculator: blocks an SM x SMs); cached."""
    lib = _library()
    arr = (ctypes.c_int * 12)(*dims)
    key = (dev.index, library_smem(dims, stages))
    if key not in _RESIDENT:
        runtime.fill_outside_capture("the Tacotron 2 step decode's residency")
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            runtime.check(lib.tt_t2_decode_resident(ctypes.cast(arr, ctypes.c_void_p), stages,
                                                    ctypes.byref(n)),
                          "t2_decode_chunk residency query")
        _RESIDENT[key] = n.value
    return _RESIDENT[key]


def device_refusal(dims, dev: torch.device) -> str | None:
    """``refusal`` on ``dev``'s shared memory, and whether the card holds
    every block at once."""
    if dev.type != "cuda":
        return f"{dev} is not a CUDA device"
    why = refusal(dims, _smem_limit(dev))
    if why is None:
        n = resident(dims, stages_for(dims, _smem_limit(dev)), dev)
        if n < BLOCKS:
            why = f"the card holds {n} of the kernel's {BLOCKS} blocks at once"
    return why


class T2DecodeChunk:
    """One decode's launches: the inputs, weights (in place), state, output
    buffers and carry, checked and laid out once. ``launch(masks, n)`` runs
    ``n`` steps from the state (written back in place) into the slots from
    the carry's ``slot`` of ``frames`` (B, S, r n_mels) and ``aligns`` (B,
    S, T_in), and applies the stop gate's exit rule. Raises ``ValueError``
    on shapes outside the kernel's limits (``refusal``) before it looks for
    a card."""

    def __init__(self, memory, keys, bias, w, state, frames, aligns, carry: GateCarry, *,
                 dropout_rate: float):
        dims = step_dims(memory, keys, w)
        why = refusal(dims)
        if why is None:
            why = device_refusal(dims, memory.device)
        if why is not None:
            raise ValueError(f"t2_decode_chunk: {why}")
        dev = memory.device
        b, t_in, m_dim, att, n_mels, r, p0, p1, ha, hd, f, kl = dims
        if (tuple(keys.shape) != (b, t_in, att) or tuple(bias.shape) != (b, t_in)
                or frames.shape[2] != r * n_mels
                or tuple(aligns.shape) != (*frames.shape[:2], t_in)):
            raise ValueError(f"t2_decode_chunk: keys {tuple(keys.shape)}, frames "
                             f"{tuple(frames.shape)} and alignments {tuple(aligns.shape)} do "
                             f"not match the memory {tuple(memory.shape)} and the weights")
        weights = [w.p_w0, w.p_b0, w.p_w1, w.p_b1, *w.a_lstm, w.q_w, w.v, w.l_conv, w.l_dense,
                   *w.d_lstm, w.f_w, w.f_b, w.g_w, w.g_b]
        widths = [(ha, p1 + m_dim), (ha, ha), (hd, ha + m_dim), (hd, hd)]
        for x, (h, k) in zip((w.a_lstm[0], w.a_lstm[1], w.d_lstm[0], w.d_lstm[1]), widths):
            if tuple(x.shape) != (4 * h, k):
                raise ValueError(f"t2_decode_chunk: an LSTM weight {tuple(x.shape)} is not "
                                 f"({4 * h}, {k})")
        for x in (*weights, *state, frames, aligns):
            if (x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev
                    or x.data_ptr() % 16):
                raise ValueError("t2_decode_chunk: the weights (read in place), the state and "
                                 f"the outputs are contiguous, 16-byte aligned f32 on {dev}")
        self._inputs = [x.float().contiguous() for x in (memory, keys, bias)]
        self.dims, self.dev, self.rate = dims, dev, dropout_rate
        self.stages = stages_for(dims, _smem_limit(dev))
        self.frames, self.aligns, self.carry = frames, aligns, carry
        # scratch: x0, x1, q, energies, each step's gate logits; the barrier's
        # counter and the rule's ticket
        sizes = [b * p0, b * p1, b * att, b * t_in, b * CHUNK_MAX]
        self._scratch = torch.zeros(sum(_up4(n) for n in sizes), device=dev)
        offs, o = [], 0
        for n in sizes:
            offs.append(self._scratch.data_ptr() + 4 * o)
            o += _up4(n)
        self._sync = torch.zeros(4, dtype=torch.int32, device=dev)
        vp = ctypes.c_void_p
        self._dims = (ctypes.c_int * 12)(*dims)
        self._weights = (vp * 20)(*[x.data_ptr() for x in weights])
        self._state = (vp * 9)(*[x.data_ptr() for x in state])
        self._exit = (vp * 5)(*[x.data_ptr() for x in (carry.t, carry.ended, carry.lengths,
                                                       carry.slot, carry.done)])
        self._scratch_ptrs = (vp * 5)(*offs)
        self._keep_alive = (weights, tuple(state))
        self.zw = 1.0 - w.zoneout

    def launch(self, masks, n: int) -> None:
        if not 1 <= n <= CHUNK_MAX:
            raise ValueError(f"t2_decode_chunk: {n} steps a launch, not in 1..{CHUNK_MAX}")
        dropout = self.rate > 0.0
        if dropout and len(masks) != 2 * n:
            raise ValueError(f"t2_decode_chunk: {len(masks)} masks for {n} steps")
        lib = _library()
        vp = ctypes.c_void_p
        mk = (vp * (2 * n))(*[u.data_ptr() for u in masks]) if dropout else None
        keep = 1.0 - self.rate
        c = self.carry
        mem, keys, bias = self._inputs
        with torch.cuda.device(self.dev):
            err = lib.tt_t2_decode_chunk(
                mem.data_ptr(), keys.data_ptr(), bias.data_ptr(), ctypes.cast(self._weights, vp),
                ctypes.cast(self._dims, vp), n, ctypes.cast(mk, vp) if mk is not None else None,
                int(dropout), keep, 1.0 / keep if keep > 0 else 0.0, self.zw, self.stages,
                ctypes.cast(self._state, vp), self.frames.data_ptr(), self.aligns.data_ptr(),
                self.frames.shape[1], ctypes.cast(self._exit, vp), c.logit, c.n_steps,
                ctypes.cast(self._scratch_ptrs, vp), self._sync.data_ptr(),
                runtime.stream_ptr(self.dev))
        runtime.check(err, f"t2_decode_chunk kernel launch ({n} steps)")
        runtime.LAUNCHES["t2_decode_chunk"] += 1
