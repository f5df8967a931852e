"""The port's attention energy (``ops/attn_energy.py``, kernels K1/K2) vs the
JAX package's ``attention_energy`` on the CPU.

JAX runs its Pallas kernel in interpret mode and its custom VJP, as
``tests/unit/test_attn_energy.py`` does; the port runs the plain formula
under autograd, which is what ``attention_energy`` does for CPU tensors.
Inputs are made with numpy from a seed and handed to both.

Tolerances (f32; max abs error measured on this setup in brackets): the
energies and the three gradients at 1e-5 (rtol and atol), as the JAX test
holds its kernel to its reference [energies 2.4e-6; dkeys 5.3e-7, dq
2.4e-6, dv 3.1e-5 on entries up to ~5, i.e. at most 0.66 of
1e-5 + 1e-5 |want|]; through a checkpointed five-step loop 2e-5 (rtol and
atol), as the JAX scan test [dkeys 2.9e-6 of a peak 25, dq0 2.4e-6 of 22,
dv 3.1e-5 of 191].

bf16 (keys and q in bf16, as under bf16 compute): the port's plain forward
and autograd against JAX's interpret-mode kernel and its VJP at JAX's own
bf16 tolerances for its kernel against its formula, 2e-2 and 4e-2 (rtol
and atol; the autograd formula rounds its backward at other points than
the kernel) [forward 2.4e-7, gradients 6.9e-3 of the peak];
``energy_bwd_reference``, which keeps K2's rounding points, against the
interpreted ``_bwd_kernel`` tighter: dkeys and dq each entry within one
bf16 ulp (2^-7 of its magnitude) plus 1e-5 of the peak, dv (f32) 1e-5 of
the peak [dkeys bit-identical; one dq entry of 1024 off, by 7.1e-7 of the
peak; dv 4.2e-7].

The kernels' geometry and summation order, emulated on the CPU
(``emulate_energy_fwd``, ``emulate_energy_bwd``: the same per-element values
as the plain version, summed in the kernels' order in numpy f32, an fma as
one f64 multiply-add rounded to f32): K1's per-lane partials over a lane's
columns and its warp butterfly, K2's dq and dv per warp over its rows,
then over the 8 warps, then over the cluster's blocks in rank order, and dv
over the batch rows in order. Held against the plain version and against
JAX's interpreted kernels, f32 at 1e-5 of each one's peak; bf16 e and dv
at 1e-5 of the peak, dkeys and dq each entry within one bf16 ulp (2^-7 of
its magnitude) plus 1e-5 of the peak (``chip_smoke.py``'s ENERGY_BF16).
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

from tacotron_tpu.ops.pallas.attn_energy import attention_energy as jax_energy
from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.ops.attention import BahdanauAttention, energy_scores
from tacotron_tpu_torch.ops.attn_energy import (BWD_CLUSTERS, CHUNK, FWD_ROWS, WARPS, BwdPlan,
                                                attention_energy, attention_energy_reference,
                                                bwd_plan, energy_bwd_reference, fwd_grid)


def _inputs(b, t, a, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((b, t, a)).astype(np.float32)
    q = rng.standard_normal((b, a)).astype(np.float32)
    v = (rng.standard_normal((a, 1)) * 0.3).astype(np.float32)
    return keys, q, v


def _jax_pallas(k, qq, vv):
    return jax_energy(k, qq, vv, backend="pallas", interpret=True)


def _leaves(*arrays):
    return [torch.tensor(x, requires_grad=True) for x in arrays]


SHAPES = [(4, 16, 256), (6, 37, 256), (8, 128, 128)]


@pytest.mark.parametrize("b,t,a", SHAPES)
def test_forward_matches_pallas_interpret(b, t, a):
    keys, q, v = _inputs(b, t, a)
    want = np.asarray(_jax_pallas(keys, q, v))
    before = dict(runtime.LAUNCHES)
    got = attention_energy(*map(torch.from_numpy, (keys, q, v)))
    assert dict(runtime.LAUNCHES) == before            # CPU tensors: no kernel
    assert got.dtype == torch.float32 and got.shape == (b, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = attention_energy_reference(*map(torch.from_numpy, (keys, q, v)))
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,t,a", SHAPES)
def test_grads_match_pallas_vjp(b, t, a):
    keys, q, v = _inputs(b, t, a, seed=1)
    co = np.random.default_rng(5).standard_normal((b, t)).astype(np.float32)
    want = jax.grad(lambda k, qq, vv: jnp.sum(_jax_pallas(k, qq, vv) * co),
                    argnums=(0, 1, 2))(keys, q, v)
    leaves = _leaves(keys, q, v)
    (attention_energy(*leaves) * torch.from_numpy(co)).sum().backward()
    for leaf, w, name in zip(leaves, want, ("dkeys", "dq", "dv")):
        assert leaf.grad.shape == w.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def _bf16(*arrays):
    """The same values rounded to bf16 on both sides (round to nearest even
    in both)."""
    return ([jnp.asarray(x, jnp.bfloat16) for x in arrays],
            [torch.from_numpy(x).bfloat16() for x in arrays])


@pytest.mark.parametrize("b,t,a", SHAPES)
def test_bf16_matches_pallas_interpret(b, t, a):
    keys, q, v = _inputs(b, t, a, seed=4)
    co = np.random.default_rng(6).standard_normal((b, t)).astype(np.float32)
    (jk, jq), (tk, tq) = _bf16(keys, q)

    def fwd_bwd(k, qq, vv, c):
        e, vjp = jax.vjp(_jax_pallas, k, qq, vv)
        return e, vjp(c)

    # every bf16 rounding the kernel writes: by default XLA:CPU keeps the
    # fused tanh(keys + q) in f32 (xla_allow_excess_precision)
    args = (jk, jq, v, jnp.asarray(co))
    want, wgrads = jax.jit(fwd_bwd).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    leaves = [tk.clone().requires_grad_(True), tq.clone().requires_grad_(True),
              torch.tensor(v, requires_grad=True)]
    got = attention_energy(*leaves)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    got.backward(torch.from_numpy(co))
    for leaf, w, name in zip(leaves, wgrads, ("dkeys", "dq", "dv")):
        assert str(leaf.grad.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(w, np.float32),
                                   rtol=4e-2, atol=4e-2, err_msg=name)
    # K2's plain version against the interpreted K2: the same rounding points
    ref = energy_bwd_reference(tk, tq, torch.from_numpy(v), torch.from_numpy(co))
    for g, w, name in zip(ref, wgrads, ("dkeys", "dq", "dv")):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        tol = 1e-5 * np.abs(w).max() + (2.0 ** -7 * np.abs(w) if name != "dv" else 0.0)
        assert (np.abs(g - w) <= tol).all(), (name, float(np.abs(g - w).max()))


def test_under_loop_and_checkpoint():
    """As the hoisted decoder uses it: each step recomputed in backward
    (``torch.utils.checkpoint``), keys a constant of every step, so dkeys
    accumulates across steps; JAX runs ``lax.scan`` over a
    ``jax.checkpoint`` body."""
    b, t, a, steps = 4, 24, 128, 5
    keys, q0, v = _inputs(b, t, a, seed=2)
    w = (np.random.default_rng(7).standard_normal((t, a)) * 0.1).astype(np.float32)

    def jax_loss(k, q, vv):
        def step(qc, _):
            e = _jax_pallas(k, qc, vv)
            return jnp.tanh(e @ w), jnp.sum(e)
        _, es = jax.lax.scan(jax.checkpoint(step, prevent_cse=False), q, None,
                             length=steps)
        return jnp.sum(es)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(keys, q0, v)
    leaves = _leaves(keys, q0, v)
    wt = torch.from_numpy(w)

    def step(k, q, vv):
        e = attention_energy(k, q, vv)
        return torch.tanh(e @ wt), e.sum()

    q, total = leaves[1], 0.0
    for _ in range(steps):
        q, s = checkpoint(step, leaves[0], q, leaves[2], use_reentrant=False)
        total = total + s
    total.backward()
    for leaf, g, name in zip(leaves, want, ("dkeys", "dq0", "dv")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_energy_switch():
    """``"xla"`` and ``"fused"`` are the same formula on CPU tensors, bit for
    bit; an unknown form is refused."""
    keys, q, v = map(torch.from_numpy, _inputs(3, 11, 64, seed=3))
    np.testing.assert_array_equal(energy_scores(keys, q, v, "xla").numpy(),
                                  energy_scores(keys, q, v, "fused").numpy())
    with pytest.raises(ValueError, match="attention_energy"):
        energy_scores(keys, q, v, "pallas")
    with pytest.raises(ValueError, match="attention_energy"):
        BahdanauAttention(8, 16, energy="pallas")


# clusters of C K2 blocks an H100 80GB HBM3 holds at once, f32 and bf16 alike
# (cudaOccupancyMaxActiveClusters; scripts/energy_study.py prints them)
H100_RESIDENT = {8: 45, 4: 92, 2: 198}


@pytest.mark.parametrize("b,t,resident,want", [
    (32, 128, H100_RESIDENT, BwdPlan(8, 16)),     # the training path: 256 blocks
    (45, 128, H100_RESIDENT, BwdPlan(8, 16)),     # every cluster of 8 that fits
    (46, 128, H100_RESIDENT, BwdPlan(4, 32)),
    (93, 128, H100_RESIDENT, BwdPlan(2, 64)),
    (32, 128, {8: 30, 4: 62, 2: 132}, BwdPlan(4, 32)),   # 32 clusters of 8 do not fit
    (32, 1, H100_RESIDENT, BwdPlan(1, 1)),        # no more blocks than rows
    (32, 37, H100_RESIDENT, BwdPlan(8, 5)),       # ragged: the last block takes 2
    (6, 37, H100_RESIDENT, BwdPlan(8, 5)),
    (1, 128, H100_RESIDENT, BwdPlan(8, 16)),
    (3, 11, H100_RESIDENT, BwdPlan(8, 2)),        # ranks 6 and 7 take no row
    (256, 128, H100_RESIDENT, BwdPlan(2, 64)),    # more clusters than fit at once
    (4096, 128, H100_RESIDENT, BwdPlan(2, 64)),
])
def test_bwd_plan(b, t, resident, want):
    """A does not enter the plan (every block walks all of A): A 100 and
    A 600 are held in the emulation below and on the card."""
    plan = bwd_plan(b, t, resident)
    assert plan == want
    assert plan.cluster in (1, *BWD_CLUSTERS) and plan.cluster <= t
    assert plan.cluster * plan.rows >= t


@pytest.mark.parametrize("b,t,dtype,want", [
    (32, 128, torch.float32, (512, 256)), (32, 128, torch.bfloat16, (256, 256)),
    (6, 37, torch.float32, (30, 256)), (6, 37, torch.bfloat16, (18, 256)),
    (3, 11, torch.bfloat16, (3, 256)), (1, 1, torch.float32, (1, 256))])
def test_fwd_grid(b, t, dtype, want):
    """8 warps a block, each taking FWD_ROWS[dtype] rows of one batch row."""
    assert fwd_grid(b, t, dtype) == want and WARPS * FWD_ROWS[dtype] in (8, 16)


def _fma(a, b, c):
    """fmaf in numpy: the product of two f32 values is exact in f64."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _lane_columns(a, elem_size):
    """(chunks, 8, 32): the column of lane l's j-th value in each chunk, -1
    past A. Groups of V = 16 bytes of the storage dtype, group g at g * 32 V
    + l V, as ``col_of`` in csrc/attn_energy.cu."""
    v = 16 // elem_size
    lane, j = np.arange(32)[None, :], np.arange(8)[:, None]
    cols = (j // v) * 32 * v + lane * v + j % v
    out = np.stack([c0 + cols for c0 in range(0, a, CHUNK)])
    return np.where(out < a, out, -1)


def emulate_energy_fwd(keys, q, v):
    """K1's sums in its order: each lane's partial over its columns, chunk by
    chunk, by fma; then the warp's xor tree at offsets 16, 8, 4, 2, 1 (what
    the multi-row butterfly computes for every row) -> e (B, T) f32."""
    t = torch.tanh(keys + q[:, None, :]).float().numpy()
    vv = v.float().reshape(-1).numpy()
    p = np.zeros(t.shape[:2] + (32,), np.float32)
    for chunk in _lane_columns(t.shape[2], keys.element_size()):
        for cols in chunk:
            ok = cols >= 0
            p = _fma(np.where(ok, vv[cols], 0.0).astype(np.float32),
                     np.where(ok, t[..., cols], 0.0).astype(np.float32), p)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ o]
    return torch.from_numpy(p[..., 0].copy())


def emulate_energy_bwd(keys, q, v, de, cluster, rows):
    """K2's sums in its order: block ``rank`` takes rows [rank rows, (rank +
    1) rows), its warp w the rows rank rows + w + 8 i in order (dq by f32
    adds, dv by fma); then the 8 warps in order, the blocks in rank order,
    and dv over the batch rows in order -> (dkeys, dq, dv) as
    ``energy_bwd_reference``."""
    b, t_len, a = keys.shape
    th = torch.tanh(keys + q[:, None, :]).float()
    d = de.float()
    w = (d[..., None] * v.float().reshape(-1) * (1.0 - th * th)).numpy()
    th, d = th.numpy(), d.numpy()
    dq = dv_rows = np.zeros((b, a), np.float32)
    for rank in range(cluster):
        t0, t1 = rank * rows, min(t_len, (rank + 1) * rows)
        blk_q = blk_v = None
        for warp in range(WARPS):
            gq = gv = np.zeros((b, a), np.float32)
            for i in range(t0 + warp, t1, WARPS):
                gq = gq + w[:, i]
                gv = _fma(th[:, i], d[:, i, None], gv)
            blk_q = gq if blk_q is None else blk_q + gq
            blk_v = gv if blk_v is None else blk_v + gv
        dq, dv_rows = dq + blk_q, dv_rows + blk_v
    dv = np.zeros(a, np.float32)
    for row in dv_rows:
        dv = dv + row
    return (torch.from_numpy(w).to(keys.dtype), torch.from_numpy(dq).to(q.dtype),
            torch.from_numpy(dv).reshape(v.shape).to(v.dtype))


ORDER_SHAPES = [(4, 37, 256), (3, 11, 100), (2, 9, 600)]


@functools.lru_cache(maxsize=None)
def _jax_energy_and_vjp(b, t, a, bf16):
    """Inputs (keys, q, v, de as torch tensors) and JAX's interpreted K1
    energies and K2 VJP on them, every bf16 rounding kept (no excess
    precision)."""
    keys, q, v = _inputs(b, t, a, seed=11)
    de = np.random.default_rng(12).standard_normal((b, t)).astype(np.float32)
    if bf16:
        (jk, jq), (tk, tq) = _bf16(keys, q)
    else:
        (jk, jq), (tk, tq) = (keys, q), (torch.from_numpy(keys), torch.from_numpy(q))

    def fwd_bwd(k, qq, vv, c):
        e, vjp = jax.vjp(_jax_pallas, k, qq, vv)
        return e, vjp(c)

    args = (jk, jq, v, jnp.asarray(de))
    e, grads = jax.jit(fwd_bwd).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    want = [torch.from_numpy(np.array(x, np.float32)) for x in (e, *grads)]
    return (tk, tq, torch.from_numpy(v), torch.from_numpy(de)), want


def _hold(got, want, name, ulp):
    """Each entry of ``got`` within 1e-5 of ``want``'s peak, plus one bf16
    ulp of the entry where ``ulp``."""
    g, w = got.float(), want.float()
    assert g.shape == w.shape, name
    tol = 1e-5 * float(w.abs().max()) + (2.0 ** -7 * w.abs() if ulp else 0.0)
    err = (g - w).abs()
    assert bool((err <= tol).all()), (name, float(err.max()))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,a", ORDER_SHAPES)
def test_fwd_order_matches_plain_and_jax(b, t, a, bf16):
    inputs, want = _jax_energy_and_vjp(b, t, a, bf16)
    got = emulate_energy_fwd(*inputs[:3])
    _hold(got, attention_energy_reference(*inputs[:3]), "e vs plain", False)
    _hold(got, want[0], "e vs JAX", False)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("b,t,a", ORDER_SHAPES)
def test_bwd_order_matches_plain_and_jax(b, t, a, cluster, bf16):
    """At the plan's cluster (None) and at every other, ceil(T / C) rows a
    block."""
    inputs, want = _jax_energy_and_vjp(b, t, a, bf16)
    c = bwd_plan(b, t, H100_RESIDENT).cluster if cluster is None else cluster
    got = emulate_energy_bwd(*inputs, c, -(-t // c))
    ref = energy_bwd_reference(*inputs)
    for name, g, r, w in zip(("dkeys", "dq", "dv"), got, ref, want[1:]):
        assert g.dtype == r.dtype, name
        ulp = bf16 and name != "dv"
        _hold(g, r, f"{name} vs plain", ulp)
        _hold(g, w, f"{name} vs JAX", ulp)
