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
batched BiLSTM). The step decode kernel's limits (``ops/t2_decode_chunk.py``
``refusal``) and its wrapper's refusals, which need no card, and the plain
chunk kept off the card. Marked ``cuda`` (skipped without a card; run there
with ``python -m pytest tests/test_torch_tacotron2.py -m cuda``): the chunk
graph's replay bit-equal to the eager call under deterministic algorithms
(its one kernel node, no library product, ``decode_kernel_chunks`` equal to
``chunks``), a call at the published widths against the reference on the
card, and the kernel against ``run_chunk_plain`` at the published widths
over 64 steps (B 1, 3, 8; T_in 49, 161; dropout 0 and 0.5): frames,
alignments and every state tensor within ``KERNEL_TOL`` (1e-5, the bound
of the Tacotron 1 step decode kernel against its plain chunk: f32 sums in
another order), the carry and the generator equal; the gate's exit rule
exact against ``_gate_rule`` on the kernel's own gate logits; launches of 1,
3 and 8 steps bit-equal; the wrapper's shared-memory mirror equal to the
built kernel's; a shape outside the kernel's limits refused on the card.
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
from tacotron_tpu_torch.models.tacotron2 import Decoder, Tacotron2
from tacotron_tpu_torch.ops import t2_decode_chunk
from tacotron_tpu_torch.ops.attention import energy_scores, location_scores, location_term
from tacotron_tpu_torch.ops.decode_chunk import draw_masks
from tacotron_tpu_torch.ops.lstm import BidirectionalLSTM
from tacotron_tpu_torch.utils import profiling

# the port against the reference: the same f32 operations, summed in
# another order, over 24 steps at these widths
TOL = 1e-5
# the step decode kernel against run_chunk_plain on the card (f32, summation
# order only), the Tacotron 1 step decode kernel's bound
KERNEL_TOL = 1e-5
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


# the published widths' step (B 8, T_in 161) and shapes beside it, each with
# the part of the reason the kernel's limits give (None: within them)
PUBLISHED = dict(B=8, T=161, M=512, A=128, NM=80, R=1, P0=256, P1=256, HA=1024, HD=1024, F=32,
                 KL=31)
KERNEL_LIMITS = {
    "published": ({}, None),
    "one_row": ({"B": 1, "T": 49}, None),
    "sixteen_rows": ({"B": 16}, None),
    "seventeen_rows": ({"B": 17}, "batch 17"),
    "small_lstm": ({"HA": 64}, "attention LSTM width 64"),
    "uneven_lstm": ({"HD": 1000}, "decoder LSTM width 1000"),
    "wide_lstm": ({"HA": 2048}, "attention LSTM width 2048"),
    "memory_width": ({"M": 500}, "memory width 500"),
    "attention_width": ({"A": 100}, "attention width 100"),
    "filters": ({"F": 33}, "33 location filters"),
    "even_kernel": ({"KL": 30}, "location kernel 30"),
    "long_text_b8": ({"T": 3000}, "shared memory"),
    "long_text_b16": ({"B": 16, "T": 400}, "shared memory"),
}


@pytest.mark.parametrize("case", list(KERNEL_LIMITS))
def test_step_kernel_limits(case):
    """The kernel's limits are shapes: its geometry's multiples, at most 16
    rows, and shared memory for two ring stages; the published widths are
    inside at B 1-16 and T_in up to the largest bucket's."""
    change, why = KERNEL_LIMITS[case]
    dims = tuple({**PUBLISHED, **change}.values())
    got = t2_decode_chunk.refusal(dims)
    if why is None:
        assert got is None
    else:
        assert why in got, got


def test_step_kernel_ring_depth_and_shared_memory():
    """The ring's depth from the shared memory left (``Layout`` mirrored):
    7 stages at B 8 up to T_in 161, 2 at B 16; every block within the
    H100's 227 KiB."""
    for b, t_in, stages in ((1, 49, 7), (8, 161, 7), (16, 49, 2), (16, 161, 2)):
        dims = tuple({**PUBLISHED, "B": b, "T": t_in}.values())
        assert t2_decode_chunk.stages_for(dims) == stages, (b, t_in)
        used = t2_decode_chunk.smem_bytes(dims, stages) + t2_decode_chunk.SMEM_STATIC
        assert used <= t2_decode_chunk.SMEM_LIMIT
        if stages < t2_decode_chunk.MAX_STAGES:
            assert used + t2_decode_chunk.STAGE_BYTES > t2_decode_chunk.SMEM_LIMIT


def _published_step(b=2, t_in=9, device="cpu"):
    """A published-width decoder's step weights and inputs on ``device``."""
    cfg = _full_cfg(16)
    dec = Decoder(cfg.model, cfg.tacotron2, device=device)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        dec.gate.bias.fill_(-10.0)                     # the gate shut
    memory = torch.randn(b, t_in, cfg.tacotron2.memory_dim, generator=g).to(device)
    keys = torch.randn(b, t_in, cfg.model.attention_dim, generator=g).to(device)
    mask = length_mask(t_in, torch.tensor([t_in] * b, device=device))
    return cfg, dec.step_weights(), memory, keys, mask


def _carry(b, device="cpu"):
    z = torch.zeros((), dtype=torch.int64, device=device)
    return t2_decode_chunk.GateCarry(z, torch.zeros(b, dtype=torch.bool, device=device),
                                     torch.zeros(b, dtype=torch.int64, device=device),
                                     torch.zeros(1, dtype=torch.int64, device=device),
                                     torch.zeros((), dtype=torch.bool, device=device), 0.0, 16)


@pytest.mark.parametrize("case", ["shape", "device"])
def test_step_kernel_wrapper_refusals_need_no_card(case):
    """The wrapper refuses with the reason before it looks for a card: a
    shape outside the limits (the small test widths), then a tensor off a
    CUDA device."""
    if case == "shape":
        cfg = _cfg()
        dec = Decoder(cfg.model, cfg.tacotron2)
        w = dec.step_weights()
        memory, keys = torch.zeros(2, 5, cfg.tacotron2.memory_dim), torch.zeros(2, 5, 16)
        why = "attention LSTM width 64"
    else:
        cfg, w, memory, keys, _ = _published_step()
        why = "cpu is not a CUDA device"
    b, t_in, _ = memory.shape
    state, _ = while_decoder_step(memory, keys, None, w, dropout_rate=0.0, generator=None)
    frames = torch.zeros(b, 24, cfg.model.r * cfg.model.n_mels)
    with pytest.raises(ValueError, match=why):
        t2_decode_chunk.T2DecodeChunk(memory, keys, torch.zeros(b, t_in), w, state, frames,
                                      torch.zeros(b, 24, t_in), _carry(b), dropout_rate=0.5)


def test_while_decode_keeps_the_plain_chunk_off_the_card():
    """On the CPU, at the published widths too, ``WhileDecode`` for
    Tacotron 2 builds no kernel and its chunk is ``run_chunk_plain``, bit
    for bit."""
    cfg, w, memory, keys, mask = _published_step()
    loops = [WhileDecode(memory, keys, mask, w, torch.Generator().manual_seed(3), n_steps=16,
                         r=1, n_mels=cfg.model.n_mels, dropout_rate=0.5) for _ in range(2)]
    assert memory.device.type == "cpu"
    assert not loops[0].kernel and not hasattr(loops[0], "_launch")
    with torch.no_grad():
        done = loops[0].run_chunk(), loops[1].run_chunk_plain()
    assert torch.equal(done[0], done[1])
    assert torch.equal(loops[0].frames, loops[1].frames) and int(loops[0].t) == 8


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
    """The graphed call against the eager one, bit for bit; the chunk
    graph is the draws and one launch of the step decode kernel (no library
    product or LSTM cell), and a traced call's record counts every chunk as
    the kernel's."""
    from tacotron_tpu_torch import runtime
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
        graphs = dict(synth.graphs[next(iter(synth.graphs))].captured())
        assert got["graphed"] and "chunk" in graphs
        nodes = profiling.graph_nodes(graphs["chunk"].graph)
        assert sum(n for k, n in nodes.items() if "t2_decode_kernel" in k) == 1, nodes
        assert not [k for k in nodes if any(x in k.lower() for x in ("gemm", "gemv", "lstm"))]
        assert dict(graphs["chunk"].launches) == {"t2_decode_chunk": 1}
        before = runtime.LAUNCHES["t2_decode_chunk"]
        with profiling.tracing():
            synth(PROMPTS, seed=3)
        counters = profiling.records()[-1]["counters"]
        assert counters["decode_kernel_chunks"] == counters["chunks"] == 5
        assert runtime.LAUNCHES["t2_decode_chunk"] == before + 5
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


@pytest.fixture(scope="module")
def t2_card(card):
    """A published-width Tacotron 2 on the card, drawn as the benchmark draws
    it (gate shut)."""
    cfg = _full_cfg(64)
    w, stats = _weights(cfg, seed=12, device=card)
    return cfg, _model(cfg, w, stats, card)


def _card_inputs(model, b, t_in, seed=0):
    """(memory, keys, mask) of ``b`` random texts, rows of ``t_in`` down to
    about half of it."""
    dev = next(model.parameters()).device
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([t_in - (i * t_in) // (2 * b) for i in range(b)], device=dev)
    ids = torch.randint(1, model.cfg.vocab_size, (b, t_in), generator=g).to(dev)
    mask = length_mask(t_in, lengths)
    with torch.no_grad():
        memory = model.encoder(torch.where(mask, ids, 0), lengths)
        return memory, model.memory_proj(memory), mask


def _t2_loop(model, inputs, rate, w=None, n_steps=64, seed=7):
    memory, keys, mask = inputs
    return WhileDecode(memory, keys, mask, w or model.decoder.step_weights(),
                       torch.Generator(device=memory.device).manual_seed(seed), n_steps=n_steps,
                       r=1, n_mels=model.cfg.n_mels, dropout_rate=rate)


def _launch(loop, n):
    """One launch of ``n`` steps, its masks drawn as ``WhileDecode`` draws a
    chunk's."""
    loop._launch.launch(draw_masks(loop.frames.shape[0], loop._w, n, loop.rate, loop._gen,
                                   loop.frames.device), n)


STATE = ("h_a", "c_a", "h_d", "c_d", "ctx", "alpha", "alpha_cum", "prev", "gate")


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("t_in", [49, 161])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_step_kernel_matches_its_plain_counterpart(t2_card, b, t_in, dropout):
    """``WhileDecode.run_chunk`` on the card (one kernel launch a chunk)
    against ``run_chunk_plain`` over the same masks, 64 steps: frames,
    alignments and every state tensor (alpha_cum among them) within
    ``KERNEL_TOL``; the flags, ``t``, ``ended``, ``lengths`` and the
    generator equal."""
    from tacotron_tpu_torch import runtime
    _, model = t2_card
    inputs = _card_inputs(model, b, t_in)
    kernel, plain = (_t2_loop(model, inputs, dropout) for _ in range(2))
    assert kernel.kernel
    before = runtime.LAUNCHES["t2_decode_chunk"]
    with torch.no_grad():
        flags = [(bool(kernel.run_chunk()), bool(plain.run_chunk_plain())) for _ in range(8)]
    assert runtime.LAUNCHES["t2_decode_chunk"] == before + 8
    assert [a for a, _ in flags] == [p for _, p in flags] == [False] * 7 + [True]
    assert int(kernel.t) == int(plain.t) == 64 and int(kernel.slot) == int(plain.slot)
    assert torch.equal(kernel.ended, plain.ended) and torch.equal(kernel.lengths, plain.lengths)
    assert torch.equal(kernel._gen.get_state(), plain._gen.get_state())
    pairs = [("frames", kernel.frames, plain.frames), ("aligns", kernel.aligns, plain.aligns),
             *zip(STATE, kernel.state, plain.state)]
    for name, x, y in pairs:
        assert _gap(x, y) <= KERNEL_TOL, (name, _gap(x, y))
    assert kernel.frames[:, :64].abs().amax(dim=(0, 2)).gt(0).all()


def _first_open(logits, bias, logit):
    """Each row's first step whose gate logit (the kernel's sums plus
    ``bias``, in f32) is over ``logit``; the step count where none is."""
    opened = (logits + bias) > logit
    return torch.where(opened.any(1), opened.int().argmax(1), logits.shape[1])


@pytest.mark.cuda
def test_step_kernel_gate_rule_is_exact(t2_card):
    """The launch's exit rule against ``WhileDecode._gate_rule`` applied to
    the kernel's own gate logits and raw outputs, chunk by chunk: ``t``,
    ``ended``, ``lengths``, ``done`` and the zeroed slots identical, with a
    gate whose rows open at different steps, inside a chunk and across
    chunks. The logits of each step are the state's gate after launches of
    one step, at gate bias 0: the kernel adds the bias last, in f32, so
    ``logits + bias`` is its logit at any bias."""
    _, model = t2_card
    inputs = _card_inputs(model, 8, 161, seed=1)
    base = model.decoder.step_weights()
    w = base._replace(g_w=(base.g_w * -1000.0).contiguous(), g_b=torch.zeros_like(base.g_b))
    with torch.no_grad():
        raw = _t2_loop(model, inputs, 0.5)            # the gate shut: nothing zeroed
        for _ in range(8):
            raw.run_chunk()
        ones = _t2_loop(model, inputs, 0.5, w=w)
        logits = []
        for _ in range(64):
            _launch(ones, 1)
            logits.append(ones.state[-1].clone())
        logits = torch.stack(logits, 1)
        for bias in torch.quantile(logits.flatten(), torch.linspace(0.5, 0.99, 50,
                                                                    device=logits.device)):
            first = _first_open(logits, -bias, raw.logit)
            hits = first[first < 64]
            if (len(set(hits.tolist())) >= 3 and len(set((hits // 8).tolist())) >= 2
                    and ((hits % 8 > 0) & (hits % 8 < 7)).any()):
                break
        else:
            raise AssertionError(f"no gate bias opens rows at 3 steps: {logits}")
        gate = w._replace(g_b=torch.full_like(base.g_b, -float(bias)))
        kernel = _t2_loop(model, inputs, 0.5, w=gate)
        # the plain rule over the raw outputs and the kernel's logits
        ref = raw
        for x in (ref.t, ref.ended, ref.lengths, ref.slot):
            x.zero_()
        for c in range(8):
            done = kernel.run_chunk()
            opened = [(logits[:, 8 * c + k] + (-bias)) > ref.logit for k in range(8)]
            want = ref._gate_rule(ref.slot, opened)
            assert bool(done) == bool(want), c
            for x, y in ((kernel.t, ref.t), (kernel.ended, ref.ended),
                         (kernel.lengths, ref.lengths), (kernel.slot, ref.slot)):
                assert torch.equal(x, y), c
            if bool(done):
                break
    assert torch.equal(kernel.frames, ref.frames) and torch.equal(kernel.aligns, ref.aligns)
    assert torch.equal(kernel.lengths, torch.minimum(first + 1, torch.full_like(first, 64)))


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_step_kernel_launch_lengths_give_the_same_bits(t2_card, dropout):
    """24 steps as launches of 1, 3 and 8 steps: the same frames,
    alignments, state, carry and generator, bit for bit (the loop capped at
    20 steps, so the last launches' steps are inactive)."""
    _, model = t2_card
    inputs = _card_inputs(model, 3, 49, seed=2)
    runs = {}
    with torch.no_grad():
        for n in (1, 3, 8):
            loop = _t2_loop(model, inputs, dropout, n_steps=20)
            for _ in range(24 // n):
                _launch(loop, n)
            runs[n] = (loop.frames, loop.aligns, *loop.state, loop.t, loop.ended, loop.lengths,
                       loop.slot, loop.done, loop._gen.get_state())
    assert int(runs[8][11]) == 20 and bool(runs[8][15])
    for n in (1, 3):
        for i, (x, y) in enumerate(zip(runs[n], runs[8])):
            assert torch.equal(x, y), (n, i)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 16])
def test_step_kernel_shared_memory_is_the_librarys(card, b):
    """The wrapper's mirror of the kernel's shared-memory layout
    (``smem_bytes``, which the limits and the ring's depth read) equals the
    built kernel's (``library_smem``) at the published widths, at every
    ring depth."""
    for t_in in (49, 161):
        dims = tuple({**PUBLISHED, "B": b, "T": t_in}.values())
        for stages in range(t2_decode_chunk.MAX_STAGES + 1):
            assert (t2_decode_chunk.smem_bytes(dims, stages)
                    == t2_decode_chunk.library_smem(dims, stages)), (t_in, stages)


@pytest.mark.cuda
def test_while_decode_on_the_card_refuses_shapes_outside_the_kernel(t2_card):
    """On the card a shape outside the kernel's limits raises the kernel's
    reason: no library-operation chunk stands in for it."""
    _, model = t2_card
    with pytest.raises(ValueError, match="batch 17"):
        _t2_loop(model, _card_inputs(model, 17, 49), 0.5)
