"""Tacotron 2 in the port (``models/tacotron2.py``, ``ops/lstm.py``, the
location-sensitive energy, ``dsp.audio.mel_to_linear``, the stop gate of
``infer.early_exit.WhileDecode``, ``infer.Synthesizer`` with
``cfg.tacotron2``) against the plain reference
``benchmark/reference/tacotron2.py``, on seeded random weights drawn as the
benchmark draws them and the same dropout masks. The JAX package has no
Tacotron 2, so this file imports no JAX.

On the CPU at a small size (embed 32, encoder convs 32, BiLSTM 16, LSTMs
64, attention 16, location 4 x k 7, post-net 32, 8 mels, 65 bins, 24
steps): the mel, linear spectrogram, alignments and gate logits within
TOL of the reference, since the operations are the same, summed in another
order (``torch.lstm_cell``'s fused gates, one product per LSTM input, the
batched BiLSTM). Marked ``cuda`` (skipped without a card; run there with
``python -m pytest tests/test_torch_tacotron2.py -m cuda``): the chunk
graph's replay bit-equal to the eager call under deterministic algorithms,
and a call at the published widths against the reference on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math

import numpy as np
import pytest
import torch

from benchmark.drivers.serve_t2 import make_weights
from benchmark.reference import tacotron2 as ref
from benchmark.reference.masks import prenet_keep
from tacotron_tpu_torch.config import (AudioConfig, Config, ModelConfig, Tacotron2Config,
                                       get_config)
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.dsp.audio import amp_to_db, db_to_amp, denormalize, mel_to_linear, normalize
from tacotron_tpu_torch.dsp.mel import mel_filterbank, mel_pinv
from tacotron_tpu_torch.infer import Synthesizer
from tacotron_tpu_torch.infer.early_exit import WhileDecode, run_until_done, while_decoder_step
from tacotron_tpu_torch.models.tacotron import length_mask
from tacotron_tpu_torch.models.tacotron2 import Tacotron2
from tacotron_tpu_torch.ops.attention import energy_scores, location_scores, location_term
from tacotron_tpu_torch.ops.lstm import BidirectionalLSTM
from tacotron_tpu_torch.utils import profiling

# the port against the reference: the same f32 operations, summed in
# another order, over 24 steps at these widths
TOL = 1e-5
STEPS = 24
PROMPTS = ["the birch canoe slid.", "glue the sheet to the dark blue", "it is easy.", "rice"]
SMALL = dict(
    model=dict(vocab_size=39, embed_dim=32, prenet_dims=(32, 32), attention_dim=16, n_mels=8,
               n_freq=65, r=1, max_decode_steps=STEPS),
    t2=dict(encoder_channels=32, encoder_lstm_dim=16, attention_lstm_dim=64,
            decoder_lstm_dim=64, location_filters=4, location_kernel=7, postnet_channels=32),
    audio=dict(n_fft=128, win_length=100, hop_length=25, n_mels=8, fmin=125.0, fmax=7600.0,
               griffin_lim_power=1.2, griffin_lim_iters=4))


def _cfg(**t2) -> Config:
    base = get_config("synth_fast")
    return base.replace(
        model=dataclasses.replace(base.model, **SMALL["model"]),
        audio=dataclasses.replace(base.audio, **SMALL["audio"]),
        tacotron2=Tacotron2Config(**{**SMALL["t2"], **t2}))


def _plain(cfg) -> dict:
    return {s: dataclasses.asdict(getattr(cfg, s)) for s in ("model", "audio", "infer")}


def _weights(cfg, seed=3, gate_bias=-10.0, device="cpu"):
    return make_weights(_plain(cfg)["model"], dataclasses.asdict(cfg.tacotron2), seed, device,
                        gate_bias)


def _vocab():
    return Vocab.build(PROMPTS)


def _ids(cfg, device="cpu"):
    synth = Synthesizer(cfg, *_weights(cfg), _vocab(), device="cpu")
    return [x.to(device) for x in synth.encode_texts(PROMPTS)]


def _model(cfg, w, stats, device="cpu"):
    model = Tacotron2(cfg.model, cfg.tacotron2, cfg.audio, device=device)
    model.load_state_dict({**w, **stats}, strict=True)
    return model.eval()


def _gap(x, y) -> float:
    x, y = (torch.as_tensor(v).detach().cpu().float() for v in (x, y))
    assert x.shape == y.shape
    return float((x - y).abs().max())


# ------------------------------------------------------------------ CPU
def test_synthesizer_matches_the_reference():
    cfg = _cfg()
    w, stats = _weights(cfg)
    out = Synthesizer(cfg, w, stats, _vocab(), device="cpu")(PROMPTS, seed=11)
    ids, lengths = _ids(cfg)
    with torch.no_grad():
        want = ref.synthesize(_plain(cfg), dataclasses.asdict(cfg.tacotron2), w, stats, ids,
                              lengths, 11, n_steps=STEPS, gl_iters=0)
    for k in ("mel", "linear", "alignments"):
        assert _gap(out[k], want[k]) <= TOL, k
    assert np.array_equal(out["end_frames"], want["end_frames"])
    assert (out["end_frames"] == STEPS).all()          # the gate held shut


def _decode(cfg, w, stats, seed, n_steps):
    """The port's step run ``n_steps`` times without an exit -> (frames,
    alphas, gates, last state) and the reference's, from equal generators."""
    model = _model(cfg, w, stats)
    ids, lengths = _ids(cfg)
    mask = length_mask(ids.shape[1], lengths)
    rate = cfg.model.prenet_dropout
    with torch.no_grad():
        memory = model.encoder(ids, lengths)
        keys = model.memory_proj(memory)
        state, step = while_decoder_step(memory, keys, mask, model.decoder.step_weights(),
                                         dropout_rate=rate,
                                         generator=torch.Generator().manual_seed(seed))
        port = []
        for _ in range(n_steps):
            state, f, a = step(state)
            port.append((f, a, state[-1]))
        r = ref.Tacotron2(_plain(cfg)["model"], dataclasses.asdict(cfg.tacotron2),
                          _plain(cfg)["audio"], w,
                          {k[:-len(".running_mean")]: (v, stats[k.replace("mean", "var")])
                           for k, v in stats.items() if k.endswith("mean")})
        r_mem, r_keys = r.encode(ids, lengths)
        s = r.init_state(*ids.shape, "cpu")
        gen = torch.Generator().manual_seed(seed)
        want = []
        for _ in range(n_steps):
            keep = prenet_keep(gen, (ids.shape[0],), cfg.model.prenet_dims, rate, "cpu")
            s, f, a, g = r.decoder_step(s, r_keys, r_mem, mask, keep)
            want.append((f, a, g))
    return port, want, state, (memory, keys, mask, model)


def test_decoder_steps_and_gate_logits_match_the_reference():
    cfg = _cfg()
    port, want, _, _ = _decode(cfg, *_weights(cfg, gate_bias=0.0), seed=5, n_steps=STEPS)
    for i in range(3):
        got = torch.stack([p[i] for p in port], 1)
        exp = torch.stack([p[i] for p in want], 1)
        assert _gap(got, exp) <= TOL, i


def test_alpha_cum_is_the_sum_of_the_alignments():
    cfg = _cfg()
    port, _, state, _ = _decode(cfg, *_weights(cfg), seed=2, n_steps=STEPS)
    alphas = torch.stack([p[1] for p in port], 1)
    assert torch.allclose(state[6], alphas.sum(1), atol=1e-6)
    assert torch.allclose(state[5], alphas[:, -1])


def test_zero_location_weights_give_the_additive_energy():
    g = torch.Generator().manual_seed(0)
    keys, q, v = (torch.randn(*s, generator=g) for s in ((3, 9, 16), (3, 16), (16, 1)))
    alpha, cum = torch.rand(3, 9, generator=g), torch.rand(3, 9, generator=g)
    loc = location_term(alpha, cum, torch.randn(4, 2, 7, generator=g), torch.zeros(16, 4))
    assert torch.equal(location_scores(keys, q, v, loc), energy_scores(keys, q, v))
    loc = location_term(alpha, cum, torch.randn(4, 2, 7, generator=g), torch.randn(16, 4))
    assert not torch.equal(location_scores(keys, q, v, loc), energy_scores(keys, q, v))


def test_bilstm_padded_rows_equal_each_row_alone():
    g = torch.Generator().manual_seed(1)
    lstm = BidirectionalLSTM(6, 5)
    for p in lstm.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.5
    lengths = torch.tensor([7, 3, 5])
    xs = torch.randn(3, 7, 6, generator=g)
    with torch.no_grad():
        batch = lstm(xs, lengths)
        for i, n in enumerate(lengths.tolist()):
            alone = lstm(xs[i:i + 1, :n], torch.tensor([n]))
            assert torch.allclose(batch[i, :n], alone[0], atol=1e-6), i


@functools.lru_cache(maxsize=1)
def _gate_cfg_weights():
    """Weights whose gate opens at different steps in different rows: the
    gate's weights scaled up (at these widths its logit moves by about 1e-3
    from step to step) and a bias at which the rows cross at different
    steps."""
    cfg = _cfg()
    for bias in np.arange(0.0, 8.0, 0.25):
        w, stats = _weights(cfg, seed=7, gate_bias=float(bias))
        w["decoder.gate.weight"] *= -1000.0
        _, want, _, _ = _decode(cfg, w, stats, seed=4, n_steps=STEPS)
        gates = torch.stack([x[2] for x in want], 1)
        opened = gates > 0
        first = torch.where(opened.any(1), opened.int().argmax(1), STEPS)
        if len(set(first.tolist())) >= 3 and (first < STEPS - 8).sum() >= 2:
            return cfg, w, stats, first
    raise AssertionError("no gate bias opens the gate at 3 different steps")


def test_chunked_gate_exit_equals_the_fixed_decode_cut_at_each_end():
    cfg, w, stats, _ = _gate_cfg_weights()
    port, _, _, (memory, keys, mask, model) = _decode(cfg, w, stats, seed=4, n_steps=STEPS)
    frames = torch.stack([p[0] for p in port], 1)
    aligns = torch.stack([p[1] for p in port], 1)
    opened = torch.stack([p[2] for p in port], 1) > 0
    ends = torch.where(opened.any(1), opened.int().argmax(1) + 1, STEPS)
    with torch.no_grad():
        loop = WhileDecode(memory, keys, mask, model.decoder.step_weights(),
                           torch.Generator().manual_seed(4), n_steps=STEPS, r=1,
                           n_mels=cfg.model.n_mels, dropout_rate=cfg.model.prenet_dropout)
        chunks = run_until_done(loop.run_chunk, STEPS, loop.chunk)
        mel, align = loop.outputs()
        got_ends = loop.gate_ends()
    assert torch.equal(got_ends[:-2], ends)
    assert int(got_ends[-2]) == int(ends.max()) == int(loop.t)
    assert int(got_ends[-1]) == int(opened.any(1).sum())
    assert chunks == -(-int(ends.max()) // loop.chunk)
    live = torch.arange(STEPS)[None, :] < ends[:, None]
    assert torch.equal(mel, torch.where(live[..., None], frames, 0.0))
    assert torch.equal(align, torch.where(live[..., None], aligns, 0.0))


def test_synthesizer_gate_ends_and_trim():
    cfg, w, stats, first = _gate_cfg_weights()
    out = Synthesizer(cfg, w, stats, _vocab(), device="cpu")(PROMPTS, seed=4)
    ids, lengths = _ids(cfg)
    with torch.no_grad():
        want = ref.synthesize(_plain(cfg), dataclasses.asdict(cfg.tacotron2), w, stats, ids,
                              lengths, 4, n_steps=STEPS, gl_iters=0)
    assert np.array_equal(out["end_frames"], want["end_frames"])
    assert np.array_equal(out["end_frames"], np.minimum(first.numpy() + 1, STEPS))
    assert _gap(out["mel"], want["mel"]) <= TOL
    hop = cfg.audio.hop_length
    assert out["wavs"].shape[1] == hop * (want["t_gl"] - 1)


def test_mel_to_linear_is_a_projection():
    a = AudioConfig(n_fft=512, win_length=400, hop_length=100, n_mels=20, fmin=125.0,
                    fmax=7600.0)
    fb = torch.from_numpy(mel_filterbank(a.sample_rate, a.n_fft, a.n_mels, a.fmin, a.fmax))
    pinv = torch.from_numpy(mel_pinv(a.sample_rate, a.n_fft, a.n_mels, a.fmin, a.fmax))
    assert torch.allclose(fb @ pinv, torch.eye(a.n_mels), atol=1e-4)
    # a mel whose linear spectrogram is inside the dB range: the filterbank's
    # image of a spectrum in its row space
    lin = (torch.rand(2, 30, a.n_mels, generator=torch.Generator().manual_seed(0)) + 0.5) @ fb
    mel = normalize(amp_to_db(lin / lin.max() @ fb.T) - a.ref_level_db, a)
    assert 0.05 < float(mel.min()) and float(mel.max()) < 0.95
    linear = mel_to_linear(mel, a, pinv)
    back = normalize(amp_to_db(db_to_amp(denormalize(linear, a) + a.ref_level_db) @ fb.T)
                     - a.ref_level_db, a)
    assert _gap(back, mel) <= 1e-5


def test_synthesizer_outputs_and_refusals():
    cfg = _cfg()
    w, stats = _weights(cfg)
    out = Synthesizer(cfg, w, stats, _vocab(), device="cpu")(PROMPTS, seed=1)
    b = len(PROMPTS)
    assert out["mel"].shape == (b, STEPS, 8) and out["linear"].shape == (b, STEPS, 65)
    assert out["alignments"].shape == (b, STEPS, max(map(len, PROMPTS)))
    assert out["wavs"].shape == (b, cfg.audio.hop_length * (STEPS - 1))
    assert np.isfinite(out["wavs"]).all() and out["graphed"] is False
    for kw in ({"fused": True}, {"mesh": object()}):
        with pytest.raises(ValueError, match="Tacotron 2"):
            Synthesizer(cfg, w, stats, _vocab(), device="cpu", **kw)


def test_record_holds_the_stages_and_both_counters():
    cfg, w, stats, first = _gate_cfg_weights()
    synth = Synthesizer(cfg, w, stats, _vocab(), device="cpu")
    with profiling.tracing():
        out = synth(PROMPTS, seed=4)
    rec = profiling.records()[-1]
    assert set(rec["stage_ms"]) == {"encoder", "decode", "postnet", "griffin_lim",
                                    "istft_inv_preemphasis", "to_host"}
    ends = out["end_frames"]
    assert rec["counters"]["decode_steps"] == int(ends.max())
    assert rec["counters"]["gate_rows"] == int((first < STEPS).sum())
    assert rec["counters"]["chunks"] == -(-int(ends.max()) // 8)
    assert rec["counters"]["decode_kernel_chunks"] == 0


def test_config_round_trips_the_tacotron2_section():
    cfg = _cfg(zoneout=0.2)
    back = Config.from_json(cfg.to_json())
    assert back == cfg and back.tacotron2.zoneout == 0.2
    plain = get_config("synth_fast")
    assert "tacotron2" not in json.loads(plain.to_json())
    assert Config.from_json(plain.to_json()).tacotron2 is None


def test_jax_config_json_loads_as_tacotron1():
    from tacotron_tpu.config import get_config as jax_get_config
    cfg = Config.from_json(jax_get_config("synth_fast").to_json())
    assert cfg.tacotron2 is None and cfg.model == ModelConfig()


def test_counts_at_published_widths():
    from benchmark.counts import tacotron2 as counts
    m = dataclasses.asdict(ModelConfig(vocab_size=39, embed_dim=512, prenet_dims=(256, 256),
                                       attention_dim=128, r=1, max_decode_steps=1000))
    t2 = dataclasses.asdict(Tacotron2Config())
    spec = ref.param_spec(m, t2)
    in_step = sum(math.prod(s) for k, s in spec.items() if k.startswith("decoder."))
    assert counts.step_params(m, t2) == in_step == 18_190_481
    assert sum(math.prod(s) for s in spec.values()) == 28_134_193


# ------------------------------------------------------------------ card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from tacotron_tpu_torch import runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runtime.build(("griffin_lim",))
    return torch.device("cuda")


def _full_cfg(n_steps: int) -> Config:
    base = get_config("synth_fast")
    return base.replace(
        model=dataclasses.replace(base.model, vocab_size=len(_vocab()) + 1, embed_dim=512,
                                  prenet_dims=(256, 256), attention_dim=128, r=1,
                                  max_decode_steps=n_steps),
        audio=dataclasses.replace(base.audio, fmin=125.0, fmax=7600.0, griffin_lim_power=1.2),
        tacotron2=Tacotron2Config())


@pytest.mark.cuda
def test_chunk_graph_replay_is_bit_equal_to_eager(card):
    flags = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = _full_cfg(40)
        w, stats = _weights(cfg, seed=9, device=card)
        synth = Synthesizer(cfg, w, stats, _vocab(), device=card)
        eager = Synthesizer(cfg, w, stats, _vocab(), device=card)
        for seed in (1, 2, 1):
            got = synth(PROMPTS, seed=seed)
            want = eager(PROMPTS, seed=seed, stage_ms=True)
            for k in ("mel", "linear", "alignments", "wavs", "end_frames"):
                assert np.array_equal(got[k], want[k]), (seed, k)
        assert got["graphed"] and "chunk" in dict(synth.graphs[next(iter(synth.graphs))]
                                                  .captured())
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1])


@pytest.mark.cuda
def test_card_call_matches_the_reference(card):
    cfg = _full_cfg(64)
    w, stats = _weights(cfg, seed=10, device=card)
    synth = Synthesizer(cfg, w, stats, _vocab(), device=card)
    for _ in range(3):                                # eager, capture + replay, replay
        out = synth(PROMPTS, seed=6)
    assert out["graphed"]
    ids, lengths = (x.to(card) for x in synth.encode_texts(PROMPTS))
    with torch.no_grad():
        want = ref.synthesize(_plain(cfg), dataclasses.asdict(cfg.tacotron2), w, stats, ids,
                              lengths, 6, n_steps=64, gl_iters=0)
    # f32 on both sides at the published widths, as the benchmark's mel_gap
    # and align_gap hold the served calls
    for k, tol in (("mel", 1e-5), ("alignments", 1e-6)):
        assert _gap(out[k], want[k]) <= tol, k
    assert np.array_equal(out["end_frames"], want["end_frames"])
