"""Tacotron 2's counts at the published widths (``counts/tacotron2.py``) and
the readers of its two per-layer metrics on synthetic traces whose answer is
known; nothing read where the program keeps no ``decode_steps`` counter
(the port before Tacotron 2)."""

from __future__ import annotations

import math

import pytest

from benchmark import harness
from benchmark.counts import flops, tacotron2
from benchmark.reference import tacotron2 as ref
from benchmark.tests.test_bench_files import BENCH
from benchmark.tests.test_bench_metrics import _call, _serve_info
from benchmark.trace import Event, Trace
from tacotron_tpu_torch.utils import profiling

CELL = harness.load_cell("serve_t2.f32.b8", BENCH)
M, T2 = harness.plain(harness.port_config(CELL))["model"], CELL.config["tacotron2"]


def test_counts_at_published_widths():
    """18,190,481 parameters a step: the pre-net 86,528 (biases included),
    the attention LSTM 7,348,224 (768 + 1024 in, 4 x 1024 out, two biases),
    the query, v, location conv and Dense 137,280, the decoder LSTM
    10,493,952 (1536 + 1024 in), the frame projection 122,960 and the gate
    1,537; 72.8 MB in f32. The whole model, with a 39-row embedding: 28.13 M."""
    assert tacotron2.step_params(M, T2) == 18_190_481
    spec = ref.param_spec(M, T2)
    assert sum(math.prod(s) for k, s in spec.items() if k.startswith("decoder.")) == 18_190_481
    assert sum(math.prod(s) for s in spec.values()) == 28_134_193
    assert tacotron2.step_bytes(M, T2, 8, 160) == 4 * (18_190_481 + 8 * 160 * 640)
    assert tacotron2.decode_bytes(M, T2, 8, 160, 1000) == 1000 * tacotron2.step_bytes(M, T2, 8, 160)
    # two FLOPs a parameter read, a row, plus the attention over the text
    per_row = tacotron2.step_flops(M, T2, 1, 0)
    assert per_row == pytest.approx(2 * 18_190_481, rel=0.01)
    a = harness.plain(harness.port_config(CELL))["audio"]
    call = tacotron2.call_flops(M, T2, a, 8, 160, 1000, 1000, 100)
    decode_and_post = (1000 * tacotron2.step_flops(M, T2, 8, 160)
                       + tacotron2.postnet_flops(M, T2, 8, 1000))
    assert call > decode_and_post
    # 69.5 GFLOP of convolutions and 1.3 of the pseudo-inverse over 8 x 1000 frames
    assert tacotron2.postnet_flops(M, T2, 8, 1000) == pytest.approx(70.78e9, rel=1e-3)


def _trace(n: int, steps: int):
    """``n`` calls of ``test_bench_metrics``'s form (a chunk replay of two 1
    ms kernels), each with the program's root span, and their records with
    ``decode_steps``."""
    ev, spans = [], []
    for i in range(n):
        ev += _call(i * 1e6) + [Event("tt.synthesize", "cpu", i * 1e6 + 1, i * 1e6 + 99_000)]
        spans.append((i * 1e6, i * 1e6 + 100_000))
    info = [dict(_serve_info(), model=M, tacotron2=T2) for _ in range(n)]
    recs = [{"id": i, "profiled": True, "counters": {"decode_steps": steps}} for i in range(n)]
    return Trace(ev, spans, info), recs


def test_readers_on_a_known_trace(monkeypatch):
    tr, recs = _trace(2, 8)
    monkeypatch.setattr(profiling, "records", lambda: recs)
    assert harness.reader("t2_decode_us_per_step").read(tr) == pytest.approx(2e3 / 8)
    bound = 8 * tacotron2.step_bytes(M, T2, 8, 64) / flops.H100_HBM_BYTES_PER_S
    assert harness.reader("t2_decode_roofline_pct").read(tr) == pytest.approx(
        100 * bound / 2e-3)


@pytest.mark.parametrize("metric", ["t2_decode_us_per_step", "t2_decode_roofline_pct"])
def test_readers_read_nothing_without_decode_steps(metric, monkeypatch):
    tr, recs = _trace(2, 8)
    for r in recs:
        del r["counters"]["decode_steps"]            # a program without the counter
    monkeypatch.setattr(profiling, "records", lambda: recs)
    assert harness.reader(metric).read(tr) is None
    monkeypatch.delattr(profiling, "records")
    assert harness.reader(metric).read(_trace(2, 8)[0]) is None
    assert harness.reader(metric).read(Trace([], [], [])) is None
