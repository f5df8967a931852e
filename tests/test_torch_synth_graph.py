"""The pieces of the graphed synthesis that run on the CPU.

``decode_while`` runs its loop in chunks of K steps on the device
(``infer.early_exit.WhileDecode``) and reads the exit flag once per chunk.
Held against the JAX package's ``decode_while`` (a ``lax.while_loop``) on
the same weights and encoder outputs, tiny config, prenet dropout 0 (JAX's
per-step PRNG streams cannot be reproduced), for K 1, 3, 8 (the default)
and 16 and ``n_steps`` 20 (a multiple of none of 3, 8 and 16): an exit in the middle of a
chunk, an exit on a chunk's last step, and no exit at all. Frames and
alignments f32, atol 1e-5 [as in tests/test_torch_early_exit.py]; past
the exit exactly zero; ``steps_done`` equal; the host reads one flag per
chunk run.

Also: the Synthesizer's shape key, its table of shapes (least recently
used dropped past ``GRAPH_SHAPES``; every graph dropped when the model's
tensors move, none after an in-place ``load_state_dict``), the split
path's Griffin-Lim length (the largest end frame rounded up to the
quantum, within the frames), ``"graphed": False`` on the CPU, the DSP
constants' cache (bit-equal to the host values, made once, refused inside
a capture) and K3's seed given as a tensor. What needs the card is in tests/test_torch_graph_cuda.py.
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
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.dsp import dft
from tacotron_tpu_torch.infer import early_exit, synthesize
from tacotron_tpu_torch.infer.early_exit import WhileDecode, decode_while
from tacotron_tpu_torch.infer.synthesize import GRAPH_SHAPES, Synthesizer
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.ops.decode_loop import decode_loop, pack_decoder_weights
from tacotron_tpu_torch.weights import from_flax, init_params, split_state

N_STEPS = 20
LENGTHS = np.array([9, 6, 4])
# (K, exit step): in the middle of a chunk, or on a chunk's last step
EXITS = [(1, 4), (3, 4), (3, 6), (8, 8), (16, 5), (16, 16)]


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
    s = dict(memory=np.array(memory), keys=np.array(keys), mask=mask, cfg=cfg,
             jax_w=jax_pack(v["params"]["decoder"]["cell"]),
             w=pack_decoder_weights(model.decoder.cell), jax={})
    full = _jax(s, -1.0, 3)
    peaks = np.asarray(full[0]).reshape(b, N_STEPS, -1).max(axis=(0, 2))    # (steps,)
    s["peaks"] = peaks
    return s


def _kw(s):
    return dict(n_steps=N_STEPS, r=s["cfg"].r, n_mels=s["cfg"].n_mels)


def _jax(s, threshold, min_steps):
    """JAX's decode_while at this threshold, once per module."""
    key = (threshold, min_steps)
    if key not in s["jax"]:
        s["jax"][key] = jax_decode_while(
            jnp.asarray(s["memory"]), jnp.asarray(s["keys"]), jnp.asarray(s["mask"]),
            s["jax_w"], jax.random.PRNGKey(0), silence_threshold=threshold,
            min_silence_steps=min_steps, **_kw(s))
    return s["jax"][key]


def _port(s, monkeypatch, threshold, min_steps, chunk):
    """The port's decode_while in chunks of ``chunk`` steps -> (outputs,
    host reads of the flag)."""
    monkeypatch.setattr(early_exit, "DECODE_CHUNK", chunk)
    reads = []
    run_chunk = WhileDecode.run_chunk

    def counted(self):
        reads.append(self.chunk)
        return run_chunk(self)

    monkeypatch.setattr(WhileDecode, "run_chunk", counted)
    with torch.no_grad():
        got = decode_while(*(torch.from_numpy(s[k]) for k in ("memory", "keys", "mask")),
                           s["w"], silence_threshold=threshold, min_silence_steps=min_steps,
                           **_kw(s))
    assert reads == [chunk] * len(reads)
    return got, len(reads)


def _assert_same(got, want, steps):
    r = got[0].shape[1] // N_STEPS
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)
    assert got[2] == int(want[2]) == steps
    assert float(got[0][:, :steps * r].abs().max()) > 0
    assert not got[0][:, steps * r:].any() and not got[1][:, steps:].any()   # zeros past the exit


@pytest.mark.parametrize("chunk,exit_step", EXITS)
def test_chunked_decode_while_exits_as_jax(setup, monkeypatch, chunk, exit_step):
    """A threshold just above the first ``exit_step`` steps' peaks (the rule
    of chip_smoke.exit_threshold) with ``min_silence_steps = exit_step``:
    every row is silent from step 0, so the loop exits after that step."""
    s = setup
    threshold = float(s["peaks"][:exit_step].max()) + 1e-3
    got, reads = _port(s, monkeypatch, threshold, exit_step, chunk)
    _assert_same(got, _jax(s, threshold, exit_step), exit_step)
    assert reads == -(-exit_step // chunk)           # one host read per chunk run


@pytest.mark.parametrize("chunk", [1, 3, 8, 16])
def test_chunked_decode_while_without_exit(setup, monkeypatch, chunk):
    """``silence_threshold < 0`` never exits: all N_STEPS steps, the last
    chunk partly past them, and the fixed-length decode's output."""
    s = setup
    got, reads = _port(s, monkeypatch, -1.0, 3, chunk)
    _assert_same(got, _jax(s, -1.0, 3), N_STEPS)
    assert reads == -(-N_STEPS // chunk)
    assert got[0].shape == (len(LENGTHS), N_STEPS * s["cfg"].r, s["cfg"].n_mels)
    assert got[1].shape == (len(LENGTHS), N_STEPS, int(LENGTHS.max()))


def test_chunk_steps_past_the_exit_change_no_carry(setup, monkeypatch):
    """After the exit a chunk's steps leave ``t`` and ``silent_run`` as they
    were and write zeros into their slots: the flag stays set."""
    s = setup
    monkeypatch.setattr(early_exit, "DECODE_CHUNK", 3)
    loop = WhileDecode(*(torch.from_numpy(s[k]) for k in ("memory", "keys", "mask")), s["w"],
                       silence_threshold=1e9, min_silence_steps=2, **_kw(s))
    with torch.no_grad():
        assert bool(loop.run_chunk())
        t, run = int(loop.t), loop.silent_run.clone()
        assert bool(loop.run_chunk())
    assert t == int(loop.t) == 2 and torch.equal(run, loop.silent_run)
    assert int(loop.slot) == 6
    assert float(loop.frames[:, 2:].abs().max()) == 0.0
    assert float(loop.aligns[:, 2:].abs().max()) == 0.0


def test_decode_while_keeps_its_default_chunk():
    assert early_exit.DECODE_CHUNK == 8
    assert early_exit.run_until_done(lambda: torch.tensor(False), 33, 16) == 3
    assert early_exit.run_until_done(lambda: torch.tensor(True), 33, 16) == 1
    assert early_exit.run_until_done(lambda: torch.tensor(True), 0, 16) == 0


@pytest.fixture(scope="module")
def tiny():
    """-> make(**infer overrides): a Synthesizer on the CPU at tiny widths
    and a small STFT, seeded random weights."""
    cfg = get_config("tiny_cpu")
    cfg = cfg.replace(audio=dataclasses.replace(cfg.audio, n_fft=512, win_length=400,
                                                hop_length=128, griffin_lim_iters=2),
                      model=dataclasses.replace(cfg.model, vocab_size=40, n_freq=257,
                                                max_decode_steps=4))
    state = split_state(init_params(Tacotron(cfg.model, device="cpu"), seed=0))
    vocab = Vocab.build(["hello world"])

    def make(**infer):
        c = cfg.replace(infer=dataclasses.replace(cfg.infer, **infer))
        return Synthesizer(c, *state, vocab, device="cpu")

    return make


@pytest.fixture
def synth(tiny):
    return tiny()


def test_shape_key(synth):
    assert synth.shape_key("cpu", 2, 7, 10, 5) == (torch.device("cpu"), 2, 7, 10, 5)
    assert synth.shape_key(torch.device("cpu"), 2, 7, 10, 5) != synth.shape_key(
        "cpu", 2, 7, 10, 6)


def test_shape_table_drops_the_least_recently_used(synth):
    keys = [synth.shape_key("cpu", 1, t, 4, 2) for t in range(GRAPH_SHAPES + 3)]
    for k in keys[:GRAPH_SHAPES]:
        assert synth._entry(k) is None                 # new: no graphs yet
    assert isinstance(synth._entry(keys[0]), synthesize.ShapeGraphs)    # used again
    for k in keys[GRAPH_SHAPES:]:
        assert synth._entry(k) is None
    # three new shapes pushed out the three least recently used: 1, 2 and 3
    assert list(synth.graphs) == [*keys[4:GRAPH_SHAPES], keys[0], *keys[GRAPH_SHAPES:]]
    assert len(synth.graphs) == GRAPH_SHAPES
    assert synth.graphs[keys[0]].captured() == []


@pytest.mark.parametrize("trim, ends, frames, want", [
    (False, [3, 9], 40, 40),          # no trim: every frame
    (True, [3, 9], 40, 16),           # the largest end, rounded up to the quantum 8
    (True, [0, 0], 40, 8),            # at least one quantum
    (True, [37, 2], 38, 38),          # never past the frames
])
def test_gl_length_is_the_largest_end_rounded_up(tiny, trim, ends, frames, want):
    s = tiny(early_exit=True, trim_before_gl=trim, gl_length_quantum=8)
    assert s._t_gl(np.array(ends), frames) == want


def test_graphs_dropped_when_the_weights_move(synth):
    synth._drop_if_moved()
    synth._entry(synth.shape_key("cpu", 1, 3, 4, 2))
    state = {k: v.clone() + 1 for k, v in synth.model.state_dict().items()}
    synth.model.load_state_dict(state)                 # copied in place
    synth._drop_if_moved()
    assert len(synth.graphs) == 1
    p = synth.model.postnet.linear_proj.weight
    p.data = p.data.clone()                            # a tensor at a new address
    synth._drop_if_moved()
    assert len(synth.graphs) == 0


@pytest.mark.parametrize("infer", [{}, {"early_exit": True, "trim_before_gl": True,
                                       "gl_length_quantum": 8}])
def test_cpu_calls_are_eager_and_say_so(tiny, infer):
    s = tiny(**infer)
    out = s(["hello world", "hello"], seed=3)
    again = s(["hello world", "hello"], seed=3, stage_ms=True)
    assert out["graphed"] is False and again["graphed"] is False
    assert not s.graphs
    for k in ("mel", "linear", "alignments", "wavs", "end_frames"):
        np.testing.assert_array_equal(out[k], again[k])
    assert np.isfinite(out["wavs"]).all()


def test_dsp_constants_are_made_once_and_equal_the_host_values():
    dft._CONSTANTS.clear()
    a = dft.inv_window_sumsquare(400, 512, 128, 7, torch.device("cpu"))
    b = dft.inv_window_sumsquare(400, 512, 128, 7, "cpu")
    assert a is b
    wss = dft.window_sumsquare(400, 512, 128, 7)
    want = (1.0 / np.maximum(wss.astype(np.float32), 1e-11)).astype(np.float32)
    assert np.array_equal(a.numpy(), want)
    assert dft.inv_window_sumsquare(400, 512, 128, 8, "cpu").shape != a.shape
    y = torch.randn(2, 2000, generator=torch.Generator().manual_seed(0))
    re, im = dft.stft_mm(y, 512, 128, 400)
    lo, hi = dft.live_span(512, 400)
    fwd = torch.from_numpy(dft.dft_matrices(512, 400)[0][lo:hi])
    frames = dft.frame_signal(y, 512, 128)[..., lo:hi]
    assert torch.equal(torch.cat([re, im], -1), frames @ fwd)


def test_dsp_constant_refused_inside_a_capture(monkeypatch):
    dft._CONSTANTS.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    made = []
    with pytest.raises(RuntimeError, match="not inside a CUDA graph capture"):
        dft.device_constant("test", torch.device("cuda", 0), lambda: made.append(1),
                            n_fft=512, win_length=400)
    assert not made

    class Host:
        def to(self, device):
            made.append(device)
            return self

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    t = dft.device_constant("test", torch.device("cuda", 0), Host, n_fft=512, win_length=400)
    assert dft.device_constant("test", "cuda:0", Host, n_fft=512, win_length=400) is t
    assert made == [torch.device("cuda", 0)]
    dft._CONSTANTS.clear()


def test_k3_seed_may_be_a_tensor(setup):
    s = setup
    mem, keys, mask = (torch.from_numpy(s[k]) for k in ("memory", "keys", "mask"))
    kw = dict(n_steps=3, dropout=True, dropout_rate=0.5)
    a = decode_loop(mem, keys, mask, s["w"], seed=7, **kw)
    b = decode_loop(mem, keys, mask, s["w"], seed=torch.tensor([7]), **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
