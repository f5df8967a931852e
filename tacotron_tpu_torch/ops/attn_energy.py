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
"""

from __future__ import annotations

import ctypes

import torch

from tacotron_tpu_torch import runtime

# rows of one batch row per K2 block; the partial sums are (B, ceil(T/16), A)
_BWD_ROWS = 16


def attention_energy_reference(keys, q, v):
    """The plain formula, as the JAX package's XLA path: tanh in the dtype of
    ``keys``/``q``, contracted with ``v`` in f32 -> (B, T_in) f32."""
    return (torch.tanh(keys + q[:, None, :]).float() @ v.float()).squeeze(-1)


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
        lib.tt_attn_energy_bwd.argtypes = [vp] * 8 + [ci, ci, ci, ci, ci, vp]
        lib.tt_attn_energy_fwd.restype = ci
        lib.tt_attn_energy_bwd.restype = ci
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


def energy_fwd(keys, q, v):
    """K1: launch the forward kernel -> e (B, T_in) f32."""
    (keys, q, v), (b, t, a) = _inputs(keys, q, v)
    per_16_bytes = 16 // keys.element_size()
    vec = int(a % per_16_bytes == 0 and all(x.data_ptr() % 16 == 0 for x in (keys, q, v)))
    e = torch.empty(b, t, device=keys.device)
    with torch.cuda.device(keys.device):
        err = _lib().tt_attn_energy_fwd(keys.data_ptr(), q.data_ptr(), v.data_ptr(),
                                        e.data_ptr(), b, t, a, vec,
                                        int(keys.dtype == torch.bfloat16),
                                        runtime.stream_ptr(keys.device))
    runtime.check(err, "attn_energy_fwd kernel launch")
    runtime.LAUNCHES["attn_energy_fwd"] += 1
    return e


def energy_bwd(keys, q, v, de):
    """K2: launch the backward kernel (partial sums, then their fixed-order
    reduction: two CUDA launches, counted as one) -> (dkeys, dq, dv) shaped
    like (keys, q, v): dkeys and dq in the dtype of keys/q, dv in v's."""
    v_dtype = v.dtype
    (keys, q, v, de), (b, t, a) = _inputs(keys, q, v, de)
    dev = keys.device
    dkeys, dq = torch.empty_like(keys), torch.empty_like(q)
    dv = torch.empty_like(v)
    chunks = -(-t // _BWD_ROWS)
    scratch = torch.empty(2 * b * chunks * a, device=dev)
    with torch.cuda.device(dev):
        err = _lib().tt_attn_energy_bwd(
            keys.data_ptr(), q.data_ptr(), v.data_ptr(), de.data_ptr(),
            dkeys.data_ptr(), dq.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            b, t, a, _BWD_ROWS, int(keys.dtype == torch.bfloat16), runtime.stream_ptr(dev))
    runtime.check(err, "attn_energy_bwd kernel launch")
    runtime.LAUNCHES["attn_energy_bwd"] += 1
    return dkeys, dq, dv.to(v_dtype)
