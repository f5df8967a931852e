"""Fused decode (TPU kernel K3 port): plain version vs the JAX Pallas
kernel run interpreted on the CPU. The CUDA kernel is held against the
plain version in tests/test_torch_kernels_cuda.py.

Dropout is off wherever JAX and the port are compared: neither the TPU's
hardware PRNG nor jax.random can be reproduced in torch.
Tolerances: f32 storage rtol/atol 2e-4, as tests/unit/test_pallas_decode.py;
bf16 storage (both sides round at the same points, but a last-bit
difference in an f32 sum can flip a bf16 rounding) rtol 1e-2 / atol 2e-3,
measured max abs error 3.6e-4 on frames of peak ~0.12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu.models.encoder import Encoder as JaxEncoder
from tacotron_tpu.ops.pallas.decode_loop import decode_loop as jax_decode_loop
from tacotron_tpu.ops.pallas.decode_loop import pack_decoder_weights as jax_pack
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.ops.decode_loop import (decode_loop, decode_loop_reference,
                                                pack_decoder_weights)
from tacotron_tpu_torch.weights import from_flax

N_STEPS = 5
LENGTHS = np.array([9, 6, 4])


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("tiny_cpu").model, vocab_size=32,
                               prenet_dropout=0.0)
    b, t = len(LENGTHS), int(LENGTHS.max())
    text = np.random.default_rng(0).integers(1, 30, (b, t))
    text[np.arange(t)[None, :] >= LENGTHS[:, None]] = 0
    jm = JaxTacotron(jcfg, train=False)
    v = jm.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                jnp.asarray(text), jnp.asarray(LENGTHS),
                gt_mel=jnp.zeros((b, 2 * jcfg.r, jcfg.n_mels)))
    v = jax.tree_util.tree_map(np.asarray, v)
    memory = JaxEncoder(jcfg, train=False).apply(
        {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]},
        jnp.asarray(text), jnp.asarray(LENGTHS), rngs={"dropout": jax.random.PRNGKey(9)})
    keys = memory @ v["params"]["memory_proj"]["kernel"]
    mask = np.arange(t)[None, :] < LENGTHS[:, None]
    cfg = Config.from_json(dataclasses.replace(
        jax_get_config("tiny_cpu"), model=jcfg).to_json()).model
    model = Tacotron(cfg, device="cpu")
    params, stats = from_flax(v)
    model.load_state_dict({**params, **stats})
    return dict(memory=np.array(memory), keys=np.array(keys), mask=mask,
                jax_w=jax_pack(v["params"]["decoder"]["cell"]),
                w=pack_decoder_weights(model.decoder.cell))


def _torch_inputs(s):
    return (torch.from_numpy(s["memory"]), torch.from_numpy(s["keys"]),
            torch.from_numpy(s["mask"]))


@pytest.mark.parametrize("lowp,rtol,atol", [(False, 2e-4, 2e-4), (True, 1e-2, 2e-3)])
def test_plain_matches_jax_interpret(setup, lowp, rtol, atol):
    want_f, want_a = jax_decode_loop(
        jnp.asarray(setup["memory"]), jnp.asarray(setup["keys"]),
        jnp.asarray(setup["mask"]), setup["jax_w"], n_steps=N_STEPS,
        dropout=False, interpret=True, lowp=lowp)
    with torch.no_grad():
        got_f, got_a = decode_loop_reference(*_torch_inputs(setup), setup["w"],
                                             n_steps=N_STEPS, dropout=False, lowp=lowp)
    assert got_f.shape == want_f.shape and got_a.shape == want_a.shape
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=rtol, atol=atol)


def test_mask_is_respected(setup):
    with torch.no_grad():
        _, a = decode_loop_reference(*_torch_inputs(setup), setup["w"], n_steps=3,
                                     dropout=False, lowp=False)
    a = a.numpy()
    assert a[1, :, 6:].max() < 1e-6
    assert a[2, :, 4:].max() < 1e-6
    np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-5)


def test_dropout_rate_zero_is_a_true_noop(setup):
    with torch.no_grad():
        off, _ = decode_loop_reference(*_torch_inputs(setup), setup["w"], n_steps=3,
                                       dropout=False)
        r0, _ = decode_loop_reference(*_torch_inputs(setup), setup["w"], n_steps=3,
                                      dropout=True, dropout_rate=0.0,
                                      generator=torch.Generator().manual_seed(7))
    assert torch.equal(off, r0)


def test_plain_dropout_follows_the_generator(setup):
    def run(seed):
        with torch.no_grad():
            return decode_loop_reference(*_torch_inputs(setup), setup["w"], n_steps=3,
                                         dropout_rate=0.5,
                                         generator=torch.Generator().manual_seed(seed))[0]
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


def test_plain_dropout_keeps_half(setup):
    """Prenet weights replaced so every unit is 1 before each dropout; the
    loop's dropout calls are recorded, and the share of units left nonzero
    is the keep rate (200 steps x 2 layers)."""
    from tacotron_tpu_torch.ops import modules
    seen = []
    real = modules.dropout

    def recorder(x, rate, generator):
        y = real(x, rate, generator)
        if rate > 0:
            seen.append((y != 0).float().mean().item())
        return y

    w = setup["w"]
    ones = w._replace(p_w0=torch.zeros_like(w.p_w0), p_b0=torch.ones_like(w.p_b0),
                      p_w1=torch.zeros_like(w.p_w1), p_b1=torch.ones_like(w.p_b1))
    modules.dropout = recorder
    try:
        with torch.no_grad():
            decode_loop_reference(*_torch_inputs(setup), ones, n_steps=200,
                                  dropout_rate=0.5,
                                  generator=torch.Generator().manual_seed(3))
    finally:
        modules.dropout = real
    assert len(seen) == 400
    assert abs(float(np.mean(seen)) - 0.5) < 0.01


def test_cpu_tensors_take_the_plain_path(setup):
    from tacotron_tpu_torch import runtime
    before = dict(runtime.LAUNCHES)
    with torch.no_grad():
        got = decode_loop(*_torch_inputs(setup), setup["w"], n_steps=3, seed=4)
        want = decode_loop_reference(*_torch_inputs(setup), setup["w"], n_steps=3,
                                     generator=torch.Generator().manual_seed(4))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dict(runtime.LAUNCHES) == before

