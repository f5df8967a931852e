"""The stage clock (``utils/profiling.py``): one record per synthesis call or
training step, on the CPU at tiny width, and on the card its event nodes
inside the CUDA graphs. This file imports no JAX, so its ``cuda`` tests
run on the card: ``python -m pytest tests/test_torch_tracing.py -m cuda``.

On the CPU: with the clock off nothing is kept; inside ``tracing()`` or
under ``torch.profiler`` each call or step keeps one record whose stages
are the caller's, whose spans nest under its root, and whose ``tt.*``
ranges in the profile hold the call's operators; ``stage_ms=True`` keeps
its keys; ``trace`` writes the records beside the Chrome trace.

On the card: a pair of external timing events inside a captured graph
reads what eager events read around the same work (within 10%); a
graphed call's and step's stages sum to no more than their host wall
time; each graph holds at most 8 event nodes and the chunk graph none; a
call traced replays the outputs an untraced call replays, bit for bit.
"""

import dataclasses
import glob
import json
import time

import numpy as np
import pytest
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.infer import Synthesizer
from tacotron_tpu_torch.infer.synthesize import RECORD_STAGES, STAGES
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.train import create_train_state, make_train_step, train_step
from tacotron_tpu_torch.train.step import STAGES as TRAIN_STAGES
from tacotron_tpu_torch.utils import profiling
from tacotron_tpu_torch.weights import init_params, split_state

PROMPTS = ["hello world", "a tiny test"]
# every width cut: the clock's records, not the model's numbers, are under test
SMALL = dict(vocab_size=40, embed_dim=16, prenet_dims=(16, 8), encoder_bank_k=2,
             encoder_bank_channels=8, encoder_proj_dims=(8, 8), postnet_bank_k=2,
             postnet_bank_channels=8, postnet_proj_dims=(8, 8), highway_layers=1, highway_dim=8,
             gru_dim=4, attention_dim=8, attention_gru_dim=8, decoder_gru_dim=8, n_mels=8,
             n_freq=65, max_decode_steps=12)
PATHS = {"exit": {"early_exit": True, "trim_before_gl": True, "silence_threshold": -1.0},
         "fixed": {}}


def _cfg(**infer):
    base = get_config("tiny_cpu")
    return base.replace(
        audio=dataclasses.replace(base.audio, n_fft=128, win_length=100, hop_length=25,
                                  griffin_lim_iters=2, gl_backend="mm_f32"),
        model=dataclasses.replace(base.model, **SMALL),
        infer=dataclasses.replace(base.infer, **infer))


def _synth(path, device="cpu"):
    cfg = _cfg(**PATHS[path])
    model = init_params(Tacotron(cfg.model, device=device), seed=0)
    return Synthesizer(cfg, *split_state(model), Vocab.build(PROMPTS), device=device)


def _batch(cfg, dev, b=2, t_in=7, t_out=10):
    g = torch.Generator().manual_seed(0)
    text = torch.randint(1, 30, (b, t_in), generator=g)
    mel = torch.rand(b, t_out, cfg.model.n_mels, generator=g)
    linear = torch.rand(b, t_out, cfg.model.n_freq, generator=g)
    return [x.to(dev) for x in (text, torch.full((b,), t_in), mel, linear, torch.full((b,), t_out))]


def _new_records(before: int) -> list:
    return [r for r in profiling.records() if r["id"] >= before]


def _check_spans(rec, root):
    spans = rec["spans"]
    assert spans[0]["name"] == root and spans[0]["parent"] is None
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
    for s in spans[1:]:
        parent = spans[s["parent"]]
        assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]


def test_clock_off_keeps_nothing():
    synth = _synth("exit")
    before = profiling._IDS[0]
    assert not profiling.enabled()
    assert profiling.clock("synthesize", "cpu", STAGES) is profiling.clock("x", "cpu", ())
    assert profiling.span("inputs") is profiling.span("to_host")
    synth(PROMPTS)
    cfg = _cfg()
    step = make_train_step(cfg)
    step(create_train_state(cfg, 0, device="cpu"), *_batch(cfg, "cpu"))
    assert profiling._IDS[0] == before and not _new_records(before)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_call_keeps_one_record(path):
    synth = _synth(path)
    before = profiling._IDS[0]
    with profiling.tracing():
        outs = [synth(PROMPTS, seed=s) for s in (1, 2)]
    recs = _new_records(before)
    assert [r["name"] for r in recs] == ["synthesize"] * 2
    for rec, out in zip(recs, outs):
        assert set(rec["stage_ms"]) == set(RECORD_STAGES) and not rec["profiled"]
        assert all(v >= 0 for v in rec["stage_ms"].values())
        assert sum(rec["stage_ms"].values()) <= rec["device_ms"] + 1e-6
        _check_spans(rec, "synthesize")
        c = rec["counters"]
        host = sum(out[k].nbytes for k in ("mel", "linear", "alignments", "wavs", "end_frames"))
        split = path == "exit"
        assert c["d2h_bytes"] == host
        assert c["graphed"] is False
        assert c["t_gl"] == out["wavs"].shape[1] // synth.cfg.audio.hop_length + 1
        assert ("chunks" in c) == ("chunk_gap_ms" in rec) == ("decode_kernel_chunks" in c) == split
        if split:
            assert c["chunks"] == 2          # 12 steps in chunks of 8, never silent
            assert c["decode_kernel_chunks"] == 0       # the plain steps on the CPU
            assert {s["name"] for s in rec["spans"]} >= {"inputs", "eager", "chunk_loop",
                                                         "to_host"}


def test_each_step_keeps_one_record():
    cfg = _cfg()
    state = create_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg)
    before = profiling._IDS[0]
    with profiling.tracing():
        for _ in range(2):
            state, _, _ = step(state, *_batch(cfg, "cpu"))
    recs = _new_records(before)
    assert [r["name"] for r in recs] == ["train_step"] * 2
    for rec in recs:
        assert set(rec["stage_ms"]) == set(TRAIN_STAGES)
        _check_spans(rec, "train_step")
        assert [s["name"] for s in rec["spans"]] == ["train_step", "eager"]


def test_profiler_ranges_hold_the_call():
    synth = _synth("exit")
    before = profiling._IDS[0]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        synth(PROMPTS, seed=1)
    (rec,) = _new_records(before)
    assert rec["profiled"]
    evs = list(prof.events())
    tt = [e for e in evs if e.name.startswith("tt.")]
    names = {e.name for e in tt}
    assert names == {"tt." + s["name"] for s in rec["spans"]}
    assert len(tt) == len(rec["spans"])
    ops = [e for e in evs if e.name.startswith("aten::")]
    for e in tt:
        inside = [o for o in ops if e.time_range.start <= o.time_range.start
                  and o.time_range.end <= e.time_range.end]
        assert inside, e.name
    assert not any(str(e.device_type).endswith("CUDA") for e in tt)


def test_stage_ms_keeps_its_keys():
    synth = _synth("exit")
    out = synth(PROMPTS, stage_ms=True)
    assert list(out["stage_ms"]) == list(STAGES)
    cfg = _cfg()
    _, metrics, _ = train_step(create_train_state(cfg, 0, device="cpu"), *_batch(cfg, "cpu"),
                               cfg=cfg, stage_ms=True)
    assert list(metrics["stage_ms"]) == list(TRAIN_STAGES)


def test_trace_writes_the_records(tmp_path):
    synth = _synth("fixed")
    with profiling.trace(str(tmp_path)):
        synth(PROMPTS, seed=1)
    assert glob.glob(str(tmp_path / "*.pt.trace.json"))
    (path,) = glob.glob(str(tmp_path / "*.tt_records.json"))
    (rec,) = json.loads(open(path).read())["records"]
    assert rec["name"] == "synthesize" and rec["profiled"]
    assert set(rec["stage_ms"]) == set(RECORD_STAGES)


# ------------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have no CPU mode)")
    flags = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    runtime.build(("attn_energy", "decode_chunk", "decode_loop", "griffin_lim"))
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = flags[0]
    torch.use_deterministic_algorithms(flags[1])


@pytest.mark.cuda
def test_events_in_a_graph_time_like_eager_events(dev):
    a = torch.randn(2048, 2048, device=dev)

    def work():
        x = a
        for _ in range(8):
            x = torch.tanh(x @ a) * 0.01
        return x

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        work()
        eager = []
        for _ in range(5):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            work()
            e1.record()
            e1.synchronize()
            eager.append(e0.elapsed_time(e1))

        def marked():
            profiling.mark(None)
            work()
            profiling.mark("work")

        g = runtime.capture_graph(marked, stream)
        graphed = []
        for _ in range(5):
            runtime.replay_graph(g)
            torch.cuda.synchronize()
            (_, e0), (_, e1) = g.marks
            graphed.append(e0.elapsed_time(e1))
    assert [label for label, _ in g.marks] == [None, "work"]
    assert abs(np.median(graphed) / np.median(eager) - 1) < 0.1, (graphed, eager)


def _nodes(g) -> dict:
    return profiling.graph_nodes(g.graph)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_graphed_call_stages_within_its_wall_time(dev, path):
    synth = _synth(path, dev)
    synth(PROMPTS, seed=1)
    plain = [synth(PROMPTS, seed=s) for s in (2, 3)]      # capture, replay
    before = profiling._IDS[0]
    with profiling.tracing():
        t0 = time.perf_counter()
        traced = synth(PROMPTS, seed=3)
        wall_ms = (time.perf_counter() - t0) * 1e3
    (rec,) = _new_records(before)
    assert traced["graphed"] and rec["counters"]["graphed"] is True
    # on the card every chunk of the early-exit decode is the kernel's
    assert rec["counters"].get("decode_kernel_chunks") == rec["counters"].get("chunks")
    assert set(rec["stage_ms"]) == set(RECORD_STAGES)
    assert 0 < sum(rec["stage_ms"].values()) + rec.get("chunk_gap_ms", 0.0) <= wall_ms
    for k in ("mel", "linear", "alignments", "wavs", "end_frames"):
        assert np.array_equal(traced[k], plain[1][k]), k
    (entry,) = synth.graphs.values()
    for name, g in entry.captured():
        events = _nodes(g).get("<event record>", 0)
        assert events == len(g.marks) and (events == 0 if name == "chunk" else 0 < events <= 8)


@pytest.mark.cuda
def test_graphed_step_stages_within_its_wall_time(dev):
    cfg = _cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, tf_decoder="hoisted",
                                                attention_energy="fused", remat_decoder=True))
    state = create_train_state(cfg, 0, device=dev)
    step = make_train_step(cfg)
    batch = _batch(cfg, dev)
    for _ in range(3):                                   # eager, capture, replay
        state, _, _ = step(state, *batch)
    torch.cuda.synchronize()
    before = profiling._IDS[0]
    with profiling.tracing():
        t0 = time.perf_counter()
        for _ in range(2):
            state, _, _ = step(state, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    recs = _new_records(before)
    assert len(recs) == 2
    for rec in recs:
        assert set(rec["stage_ms"]) == set(TRAIN_STAGES)
        assert [s["name"] for s in rec["spans"]] == ["train_step", "inputs", "replay", "outputs"]
    assert 0 < sum(sum(r["stage_ms"].values()) for r in recs) <= wall_ms
    (entry,) = step.graphs.values()
    assert _nodes(entry)["<event record>"] == len(entry.marks) == 4
