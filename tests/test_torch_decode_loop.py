"""Fused decode (TPU kernel K3 port): plain version vs the JAX Pallas
kernel run interpreted on the CPU. The CUDA kernel is held against the
plain version in tests/test_torch_kernels_cuda.py.

The kernel spreads each batch row over a thread-block cluster of C blocks;
here a CPU emulation of its split step (every product split by output unit
over the ranks and concatenated, the energy by encoder position, the
context by memory column, the softmax over the gathered scores) is held
against the plain step for every C, at widths that do not divide by C too:
within 1e-6, and in bf16 storage bit-equal at every rounding point (the
values rounded to bf16 where a product reads them); and against the JAX
kernel at the tolerances below.
The choice of C is a pure function of the card's residency counts.

Dropout is off wherever JAX and the port are compared: neither the TPU's
hardware PRNG nor jax.random can be reproduced in torch.
Tolerances: f32 storage rtol/atol 2e-4, as tests/unit/test_pallas_decode.py;
bf16 storage (both sides round at the same points, but a last-bit
difference in an f32 sum can flip a bf16 rounding) rtol 1e-2 / atol 2e-3,
measured max abs error 3.6e-4 on frames of peak ~0.12.
"""

import dataclasses

import torch.nn.functional as F

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
from tacotron_tpu_torch.ops.attention import NEG_INF
from tacotron_tpu_torch.ops.decode_loop import (CLUSTER_SIZES, DecoderWeights, cluster_size,
                                                cluster_slice, decode_loop,
                                                decode_loop_reference, pack_decoder_weights,
                                                packed_decoder_step)
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



# resident clusters of the kernel at [main]'s shapes, as the occupancy
# calculator counts them on an H100 80GB HBM3 (132 SMs): only 7 clusters of
# 16 fit, because a cluster of 16 needs one GPC with 16 free SMs
H100_RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("b,resident,want", [
    (8, H100_RESIDENT, 8),                 # 8 clusters of 16 would take two waves
    (8, {**H100_RESIDENT, 16: 8}, 16),
    (7, H100_RESIDENT, 16),
    (30, H100_RESIDENT, 4),
    (40, H100_RESIDENT, 2),                # only 30 clusters of 4
    (67, H100_RESIDENT, 1),                # more rows than clusters of 2
    (200, H100_RESIDENT, 1),
    (1, {}, 1),
])
def test_cluster_size_takes_the_largest_resident(b, resident, want):
    assert cluster_size(b, resident) == want


@pytest.mark.parametrize("n", [0, 1, 9, 113, 160, 256])
@pytest.mark.parametrize("c", CLUSTER_SIZES)
def test_cluster_slices_cover_the_items_once(n, c):
    bounds = [cluster_slice(n, c, r) for r in range(c)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert max(hi - lo for lo, hi in bounds) - min(hi - lo for lo, hi in bounds) <= 1


def split_decoder_step(memory, keys, mask, weights: DecoderWeights, *, cluster: int,
                       lowp: bool):
    """``packed_decoder_step`` (dropout off) computed the way the kernel
    splits it over a cluster of ``cluster`` blocks: each product's output
    units by ``cluster_slice``, the scores by encoder position, the context
    by memory column in groups of the kernel's vector width (16 bytes of the
    storage type; single columns where the width does not divide M), the
    softmax over the gathered scores. The slices are concatenated in rank
    order."""
    sd = torch.bfloat16 if lowp else torch.float32
    b, t_in, m_dim = memory.shape
    n_mels = weights.p_w0.shape[1]
    r_frames = weights.f_w.shape[0] // n_mels
    w = DecoderWeights(*[x.to(sd).float() for x in weights])
    mem, keys_s = memory.to(sd), keys.to(sd)
    maskbias = torch.where(mask, 0.0, NEG_INF).float()
    ranks = range(cluster)
    vec = 128 // torch.finfo(sd).bits  # 16 bytes
    group = vec if m_dim % vec == 0 else 1

    def dot(x, wt, bias=None):
        xs = x.to(sd).float()
        return torch.cat([F.linear(xs, wt[lo:hi], None if bias is None else bias[lo:hi])
                          for lo, hi in (cluster_slice(wt.shape[0], cluster, r) for r in ranks)],
                         -1)

    def gru(h, x, wg, bg, wc, bc):
        ru = torch.sigmoid(dot(torch.cat([x, h], -1), wg, bg))
        rr, u = ru.chunk(2, dim=-1)
        c = torch.tanh(dot(torch.cat([x, rr * h], -1), wc, bc))
        return u * h + (1.0 - u) * c

    def scores_of(q):
        out = []
        for lo, hi in (cluster_slice(t_in, cluster, r) for r in ranks):
            e = torch.tanh(keys_s[:, lo:hi] + q.to(sd)[:, None, :])
            out.append((e.float() * w.at_v).sum(-1) + maskbias[:, lo:hi])
        return torch.cat(out, -1)

    def context_of(alpha):
        out = []
        for lo, hi in (cluster_slice(m_dim // group, cluster, r) for r in ranks):
            cols = mem[:, :, lo * group:hi * group]
            out.append((alpha.to(sd)[..., None] * cols).float().sum(1))
        return torch.cat(out, -1)

    def step(state):
        h_att, h0, h1, ctx, prev = state
        x = torch.relu(dot(prev, w.p_w0, w.p_b0))
        x = torch.relu(dot(x, w.p_w1, w.p_b1))
        h_att = gru(h_att, torch.cat([x, ctx], -1), w.ag_wg, w.ag_bg, w.ag_wc, w.ag_bc)
        alpha = torch.softmax(scores_of(dot(h_att, w.at_wq)), dim=-1)
        ctx = context_of(alpha)
        h = dot(torch.cat([h_att, ctx], -1), w.ip_w, w.ip_b)
        h0 = gru(h0, h, w.d0_wg, w.d0_bg, w.d0_wc, w.d0_bc)
        h = h + h0
        h1 = gru(h1, h, w.d1_wg, w.d1_bg, w.d1_wc, w.d1_bc)
        h = h + h1
        frames = dot(h, w.f_w, w.f_b)
        prev = frames[:, (r_frames - 1) * n_mels:]
        return (h_att, h0, h1, ctx, prev), frames, alpha

    h0 = torch.zeros(b, w.d0_wc.shape[0])
    state = (torch.zeros(b, w.ag_wc.shape[0]), h0, torch.zeros_like(h0),
             torch.zeros(b, m_dim), torch.zeros(b, n_mels))
    return state, step


def _random_decoder(seed, *, n_mels, r, prenet, memory_dim, att_gru, att, dec_gru):
    """Packed decoder weights with every entry (biases too) drawn from a
    seeded numpy generator, scaled by 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    p0, p1 = prenet
    shapes = [(p0, n_mels), (p0,), (p1, p0), (p1,),
              (2 * att_gru, p1 + memory_dim + att_gru), (2 * att_gru,),
              (att_gru, p1 + memory_dim + att_gru), (att_gru,),
              (att, att_gru), (att,), (dec_gru, att_gru + memory_dim), (dec_gru,),
              *[(2 * dec_gru, 2 * dec_gru), (2 * dec_gru,), (dec_gru, 2 * dec_gru), (dec_gru,)] * 2,
              (r * n_mels, dec_gru), (r * n_mels,)]
    fan = [s[-1] if len(s) == 2 else 4.0 for s in shapes]
    return DecoderWeights(*[torch.from_numpy((rng.standard_normal(s) / np.sqrt(f)).astype(np.float32))
                            for s, f in zip(shapes, fan)])


@pytest.fixture(scope="module")
def uneven():
    """Widths that do not divide by the cluster sizes: prenet 48/24,
    attention 40, r * n_mels 3 * 20, memory 36 (bf16 context by single
    columns), attention GRU 72, decoder GRUs 56; T_in 9."""
    w = _random_decoder(5, n_mels=20, r=3, prenet=(48, 24), memory_dim=36, att_gru=72,
                        att=40, dec_gru=56)
    rng = np.random.default_rng(6)
    b, t = len(LENGTHS), int(LENGTHS.max())
    memory = rng.standard_normal((b, t, 36)).astype(np.float32)
    keys = rng.standard_normal((b, t, 40)).astype(np.float32)
    mask = np.arange(t)[None, :] < LENGTHS[:, None]
    return dict(memory=memory, keys=keys, mask=mask, w=w)


def _run_steps(state, step, n):
    out = []
    for _ in range(n):
        state, frames, alpha = step(state)
        out.append((frames, alpha, *state))
    return out


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("widths", ["tiny", "uneven"])
def test_split_step_equals_plain_step(setup, uneven, widths, cluster, lowp):
    s = setup if widths == "tiny" else uneven
    memory, keys, mask = _torch_inputs(s)
    with torch.no_grad():
        want = _run_steps(*packed_decoder_step(memory, keys, mask, s["w"], dropout_rate=0.0,
                                               lowp=lowp, generator=None), N_STEPS)
        got = _run_steps(*split_decoder_step(memory, keys, mask, s["w"], cluster=cluster,
                                             lowp=lowp), N_STEPS)
    # frames, alignment and the state after each step: f32 values within
    # 1e-6 (CPU BLAS may sum a product of a few rows in another order); in
    # bf16 storage every one of them is rounded to bf16 where the next
    # product reads it, and those rounded values are bit-equal
    for g_step, w_step in zip(got, want):
        for g, w in zip(g_step, w_step):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
            if lowp:
                assert torch.equal(g.to(torch.bfloat16), w.to(torch.bfloat16))


@pytest.fixture(scope="module")
def jax_decodes(setup):
    """The JAX kernel interpreted, per storage mode, computed once."""
    cache = {}

    def get(lowp):
        if lowp not in cache:
            cache[lowp] = jax_decode_loop(
                jnp.asarray(setup["memory"]), jnp.asarray(setup["keys"]),
                jnp.asarray(setup["mask"]), setup["jax_w"], n_steps=N_STEPS,
                dropout=False, interpret=True, lowp=lowp)
        return cache[lowp]
    return get


@pytest.mark.parametrize("lowp,rtol,atol", [(False, 2e-4, 2e-4), (True, 1e-2, 2e-3)])
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
def test_split_decode_matches_jax_interpret(setup, jax_decodes, cluster, lowp, rtol, atol):
    want_f, want_a = jax_decodes(lowp)
    with torch.no_grad():
        steps = _run_steps(*split_decoder_step(*_torch_inputs(setup), setup["w"],
                                               cluster=cluster, lowp=lowp), N_STEPS)
    got_f = torch.stack([st[0] for st in steps], 1)
    got_a = torch.stack([st[1] for st in steps], 1)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=rtol, atol=atol)
