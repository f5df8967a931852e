"""The traffic is made from the seed alone, and each cell meets exactly the
shapes its set-up warms."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, inputs
from benchmark.tests.test_bench_files import BENCH

SERVE = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("serve")]


@pytest.mark.parametrize("cell", SERVE)
def test_calls_are_a_function_of_the_seed(cell):
    t = harness.load_cell(cell, BENCH).traffic
    a = inputs.call_schedule(2 ** 31 + 5, 30, t["batch"], t["buckets"])
    b = inputs.call_schedule(2 ** 31 + 5, 30, t["batch"], t["buckets"])
    c = inputs.call_schedule(2 ** 31 + 6, 30, t["batch"], t["buckets"])
    assert a == b and a != c


@pytest.mark.parametrize("cell", SERVE)
def test_three_shapes_in_every_run_of_three_calls(cell):
    t = harness.load_cell(cell, BENCH).traffic
    assert len(t["buckets"]) == 3
    calls = inputs.call_schedule(123456789012, 60, t["batch"], t["buckets"])
    his = [hi for _, hi in t["buckets"]]
    for i in range(0, 60, 3):
        shapes = sorted(max(map(len, texts)) for texts, _ in calls[i:i + 3])
        assert shapes == his
    for texts, s in calls:
        assert len(texts) == t["batch"] and 0 <= s < 2 ** 31 - 1
        lo, hi = next(b for b in t["buckets"] if b[1] == max(map(len, texts)))
        assert all(lo <= len(x) <= hi and x == x.strip() and "  " not in x for x in texts)


def test_ids_are_the_programs():
    from tacotron_tpu_torch.data.vocab import Vocab
    vocab = Vocab.build([inputs.charset()])
    texts, _ = inputs.call_schedule(7, 1, 4, [[40, 60]])[0]
    ids, lengths = inputs.encode(texts)
    for row, n, t in zip(ids, lengths, texts):
        assert list(row[:n]) == list(vocab.encode(t)) and not row[n:].any()
    assert len(vocab) == len(inputs.char_ids()) + 1


def test_weights_are_a_function_of_the_seed():
    m = harness.plain(harness.port_config(harness.load_cell("serve_fast.f32.b8", BENCH)))["model"]
    a, _ = inputs.make_weights(m, 2 ** 33 + 1, "cpu")
    b, _ = inputs.make_weights(m, 2 ** 33 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["decoder.cell.attention_gru.gates.bias"].min()) == 1.0
    assert float(a["encoder.cbhg.highway.T0.bias"].max()) == -1.0


def test_speech_like_spectrogram_is_not_flat():
    from benchmark.reference import audio
    a = harness.plain(harness.port_config(harness.load_cell("serve_fast.f32.b8", BENCH)))["audio"]
    y = inputs.speech_like(3, 2, a["hop_length"] * 39, a["sample_rate"], "cpu")
    s = audio.normalized_spectrogram(y, a)
    assert s.shape == (2, 40, a["n_fft"] // 2 + 1)
    assert float(s.max()) > 0.6 and float(s.min()) < 0.2
