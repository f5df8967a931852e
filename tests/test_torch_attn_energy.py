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
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

from tacotron_tpu.ops.pallas.attn_energy import attention_energy as jax_energy
from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.ops.attention import BahdanauAttention, energy_scores
from tacotron_tpu_torch.ops.attn_energy import (attention_energy, attention_energy_reference,
                                                energy_bwd_reference)


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
