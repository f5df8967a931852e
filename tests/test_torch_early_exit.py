"""The early-exit decode, ``decode_while``, against the JAX package's on the
same weights and encoder outputs (tiny config, prenet dropout 0: JAX's
per-step PRNG streams cannot be reproduced).

Tolerance: f32 on both sides, atol 1e-5 on frames and alignments [6e-8
measured]; ``steps_done`` equal. Against the port's own step-by-step
``Decoder`` the early exit is held bit for bit (``torch.equal``), at the
tiny width and at full_1chip's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.infer.early_exit import decode_while as jax_decode_while
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu.models.encoder import Encoder as JaxEncoder
from tacotron_tpu.ops.pallas.decode_loop import pack_decoder_weights as jax_pack
from tacotron_tpu_torch.config import Config, get_config
from tacotron_tpu_torch.infer.early_exit import WhileDecode, decode_while
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.ops.decode_loop import decode_loop_reference, pack_decoder_weights
from tacotron_tpu_torch.ops.modules import dropout as dropout_fn
from tacotron_tpu_torch.weights import from_flax, init_params

N_STEPS = 8
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
    model.eval()
    return dict(memory=np.array(memory), keys=np.array(keys), mask=mask, cfg=cfg,
                jax_w=jax_pack(v["params"]["decoder"]["cell"]), model=model,
                w=pack_decoder_weights(model.decoder.cell))


def _both(s, **kw):
    kw = dict(n_steps=N_STEPS, r=s["cfg"].r, n_mels=s["cfg"].n_mels, **kw)
    want = jax_decode_while(jnp.asarray(s["memory"]), jnp.asarray(s["keys"]),
                            jnp.asarray(s["mask"]), s["jax_w"], jax.random.PRNGKey(0), **kw)
    with torch.no_grad():
        got = decode_while(torch.from_numpy(s["memory"]), torch.from_numpy(s["keys"]),
                           torch.from_numpy(s["mask"]), s["w"], **kw)
    return got, want


def _assert_same(got, want):
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)
    assert got[2] == int(want[2])


def _gap(a, b):
    return f"largest difference {float((a - b).abs().max()):.3e}"


def test_never_trips_equals_the_fixed_length_decode(setup):
    s = setup
    got, want = _both(s, silence_threshold=-1.0)
    _assert_same(got, want)
    assert got[2] == N_STEPS
    b = len(LENGTHS)
    assert got[0].shape == (b, N_STEPS * s["cfg"].r, s["cfg"].n_mels)
    assert got[1].shape == (b, N_STEPS, int(LENGTHS.max()))
    # ... and bit for bit the scan decoder of the model, whose operations its
    # step runs (JAX's decode_while takes the cell's forms); the fused
    # decode's plain version sums the attention in the kernel's forms
    mem, keys, mask = (torch.from_numpy(s[k]) for k in ("memory", "keys", "mask"))
    with torch.no_grad():
        mel, align = s["model"].decoder(mem, keys, mask, N_STEPS, None)
        frames, align_f = decode_loop_reference(mem, keys, mask, s["w"], n_steps=N_STEPS,
                                                dropout=False, lowp=False)
    assert torch.equal(got[0], mel), _gap(got[0], mel)
    assert torch.equal(got[1], align), _gap(got[1], align)
    np.testing.assert_allclose(got[0].numpy(), frames.reshape(b, -1, s["cfg"].n_mels).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), align_f.numpy(), atol=1e-5)


@pytest.mark.parametrize("min_silence_steps", [1, 3])
def test_always_silent_stops_after_min_steps(setup, min_silence_steps):
    got, want = _both(setup, silence_threshold=1e9, min_silence_steps=min_silence_steps)
    _assert_same(got, want)
    assert got[2] == min_silence_steps
    r = setup["cfg"].r
    assert float(got[0][:, :min_silence_steps * r].abs().max()) > 0
    assert float(got[0][:, min_silence_steps * r:].abs().max()) == 0.0
    assert float(got[1][:, min_silence_steps:].abs().max()) == 0.0


def test_exit_waits_for_every_row(setup):
    """A threshold between the rows' peaks: the loud row keeps the loop
    going, so it runs to the end, as in JAX."""
    s = setup
    full, _ = _both(s, silence_threshold=-1.0)
    peaks = full[0].reshape(len(LENGTHS), N_STEPS, -1).amax(-1)       # (B, steps)
    row_max = peaks.max(dim=1).values
    thr = float((row_max.min() + row_max.max()) / 2)
    assert row_max.min() < thr < row_max.max()
    got, want = _both(s, silence_threshold=thr, min_silence_steps=2)
    _assert_same(got, want)


def test_threshold_inside_the_run_exits_inside(setup):
    """A threshold just above the whole batch's peaks from step 3 on, so the
    run of silent steps starts there: exit strictly inside (0, n_steps)."""
    s = setup
    full, _ = _both(s, silence_threshold=-1.0)
    peaks = full[0].reshape(len(LENGTHS), N_STEPS, -1).amax(-1)
    thr = float(peaks.max()) + 1.0
    got, want = _both(s, silence_threshold=thr, min_silence_steps=4)
    _assert_same(got, want)
    assert 0 < got[2] == 4 < N_STEPS


def test_frame_width_is_checked(setup):
    s = setup
    mem, keys, mask = (torch.from_numpy(s[k]) for k in ("memory", "keys", "mask"))
    with pytest.raises(ValueError, match="r \\* n_mels"):
        decode_while(mem, keys, mask, s["w"], n_steps=2, r=s["cfg"].r + 1,
                     n_mels=s["cfg"].n_mels)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_full_width_equals_the_decoder_bit_for_bit(dropout):
    """full_1chip's model from a seed (no JAX), B 3, T_in 40, 6 steps: with a
    threshold that never trips, ``decode_while`` is ``torch.equal`` to
    ``model.decoder``, prenet dropout included (both draw the prenet's two
    masks per step from the generator, in the same order); with one that
    trips after step 2, the frames and alignments up to the exit are
    ``torch.equal`` to the decoder's and everything after is zero."""
    cfg = dataclasses.replace(get_config("full_1chip").model, prenet_dropout=dropout)
    model = init_params(Tacotron(cfg, device="cpu"), seed=0).eval()
    lengths = np.array([40, 31, 17])
    b, t, n_steps = len(lengths), int(lengths.max()), 6
    rng = np.random.default_rng(4)
    memory = torch.from_numpy(rng.standard_normal((b, t, cfg.memory_dim)).astype(np.float32))
    mask = torch.from_numpy(np.arange(t)[None, :] < lengths[:, None])
    w = pack_decoder_weights(model.decoder.cell)
    kw = dict(n_steps=n_steps, r=cfg.r, n_mels=cfg.n_mels, dropout_rate=dropout)
    with torch.no_grad():
        keys = model.memory_proj(memory)
        mel, align = model.decoder(memory, keys, mask, n_steps,
                                   torch.Generator().manual_seed(7))
        got = decode_while(memory, keys, mask, w, torch.Generator().manual_seed(7),
                           silence_threshold=-1.0, **kw)
        assert got[2] == n_steps
        assert torch.equal(got[0], mel), _gap(got[0], mel)
        assert torch.equal(got[1], align), _gap(got[1], align)
        if dropout:
            return
        peaks = mel.reshape(b, n_steps, -1).amax(dim=(0, 2))
        thr = float(peaks[:2].max()) + 1e-3
        ex = decode_while(memory, keys, mask, w, silence_threshold=thr, min_silence_steps=2,
                          **kw)
    assert ex[2] == 2
    assert torch.equal(ex[0][:, :2 * cfg.r], mel[:, :2 * cfg.r])
    assert torch.equal(ex[1][:, :2], align[:, :2])
    assert float(ex[0][:, 2 * cfg.r:].abs().max()) == 0.0
    assert float(ex[1][:, 2:].abs().max()) == 0.0


# ------------------------------------------- the step decode kernel's plain counterpart

# (silence threshold, min_silence_steps) over 20 steps in chunks of 8: the
# exit after step 3 (mid-chunk), after step 8 (a chunk's last step), after
# step 11 (mid second chunk), and none (the last chunk partly past n_steps)
CHUNK_EXITS = {"mid_chunk": (1e9, 3), "chunk_last_step": (1e9, 8),
               "second_chunk": (1e9, 11), "no_exit": (-1.0, 3)}
CHUNK_STEPS = 20


def _tiny_loop(dropout, generator, threshold=-1.0, min_steps=3):
    """A WhileDecode on tiny_cpu's model from a seed (no JAX), B 3, T_in 9."""
    cfg = dataclasses.replace(get_config("tiny_cpu").model, prenet_dropout=dropout)
    model = init_params(Tacotron(cfg, device="cpu"), seed=0).eval()
    lengths = torch.tensor([9, 6, 4])
    memory = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 9, cfg.memory_dim)).astype(np.float32))
    mask = torch.arange(9)[None, :] < lengths[:, None]
    with torch.no_grad():
        keys = model.memory_proj(memory)
    return WhileDecode(memory, keys, mask, pack_decoder_weights(model.decoder.cell), generator,
                       n_steps=CHUNK_STEPS, r=cfg.r, n_mels=cfg.n_mels, dropout_rate=dropout,
                       silence_threshold=threshold, min_silence_steps=min_steps)


def _stepwise_chunk(loop):
    """``loop``'s chunk as the steps of ``decode_while`` run it, one by one:
    each step draws its own masks, and its outputs go into the slot under
    ``where(active, ., 0)`` before the next step runs -> the flag "done"."""
    def done(t, run):
        return (t >= loop.n_steps) | (run >= loop.min_steps).all()

    state, t, slot, run = loop.state, loop.t, loop.slot, loop.silent_run
    for _ in range(loop.chunk):
        active = ~done(t, run)
        state, frames, align = loop._step(state)
        loop.frames.index_copy_(1, slot, torch.where(active, frames, 0.0)[:, None])
        loop.aligns.index_copy_(1, slot, torch.where(active, align, 0.0)[:, None])
        silent = frames.amax(dim=-1) < loop.threshold
        run = torch.where(active, torch.where(silent, run + 1, 0), run)
        t = t + active
        slot = slot + 1
    for dst, src in zip(loop.state, state):
        dst.copy_(src)
    loop.t.copy_(t)
    loop.slot.copy_(slot)
    loop.silent_run.copy_(run)
    return done(t, run)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("case", list(CHUNK_EXITS))
def test_plain_chunk_over_drawn_masks_equals_run_chunk(case, dropout):
    """``run_chunk`` on the CPU, which is ``run_chunk_plain`` (the kernel's
    launch in plain PyTorch: every step's raw outputs into its slot, then
    the exit rule over the chunk), against the chunk run step by step
    (``_stepwise_chunk``), from equally seeded generators: the flags chunk
    by chunk, the outputs, the carry and the generators' states bit for
    bit."""
    threshold, min_steps = CHUNK_EXITS[case]
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    steps, plain = (_tiny_loop(dropout, g, threshold, min_steps) for g in gens)
    with torch.no_grad():
        flags = [(bool(_stepwise_chunk(steps)), bool(plain.run_chunk()))
                 for _ in range(-(-CHUNK_STEPS // steps.chunk))]
    assert [a for a, _ in flags] == [b for _, b in flags]
    for a, b in ((steps.frames, plain.frames), (steps.aligns, plain.aligns), (steps.t, plain.t),
                 (steps.slot, plain.slot), (steps.silent_run, plain.silent_run),
                 *zip(steps.state, plain.state)):
        assert torch.equal(a, b), _gap(a.float(), b.float())
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    exit_step = min_steps if threshold > 0 else CHUNK_STEPS
    assert int(plain.t) == exit_step
    assert not plain.frames[:, exit_step:].any() and not plain.aligns[:, exit_step:].any()
    assert plain.frames[:, :exit_step].abs().amax(dim=(0, 2)).gt(0).all()


@pytest.mark.parametrize("dropout", [0.5, 0.2])
def test_chunk_masks_are_the_steps_dropout_draws(dropout):
    """The 16 masks ``draw_masks`` draws for a chunk of 8 are what the
    pre-net's 8 steps of ``dropout`` draw from an equally seeded generator
    (a (B, P0) then a (B, P1) draw a step), and leave it where they do."""
    loop = _tiny_loop(dropout, torch.Generator().manual_seed(5))
    masks = loop.draw_masks()
    assert len(masks) == 2 * loop.chunk == 16
    gen = torch.Generator().manual_seed(5)
    p0, p1 = loop._w.p_w0.shape[0], loop._w.p_w1.shape[0]
    for k in range(loop.chunk):
        for u, width in zip(masks[2 * k:2 * k + 2], (p0, p1)):
            kept = dropout_fn(torch.ones(3, width), dropout, gen) != 0
            assert u.shape == (3, width) and torch.equal(u < 1.0 - dropout, kept)
    assert torch.equal(loop._gen.get_state(), gen.get_state())
    assert _tiny_loop(0.0, torch.Generator()).draw_masks() == []
