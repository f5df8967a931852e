"""The readers of the metrics the program times itself (``benchmark/
records.py``): each on synthetic records whose answer is known; nothing
read when the program keeps no records (the port before its stage clock)
or when their count differs from the profiled calls'; and a traced run of
each cell on the CPU at a small size reports every one its cell lists."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests import tiny
from benchmark.tests.test_bench_files import BENCH
from benchmark.trace import Event, Trace
from tacotron_tpu_torch.utils import profiling

NEW = {"encoder_ms_per_call": ("stage_ms", "encoder"),
       "postnet_ms_per_call": ("stage_ms", "postnet"),
       "griffin_lim_ms_per_call": ("stage_ms", "griffin_lim"),
       "final_ms_per_call": ("stage_ms", "istft_inv_preemphasis"),
       "chunk_gap_ms_per_call": ("chunk_gap_ms", None),
       "train_forward_ms_per_step": ("stage_ms", "forward"),
       "train_backward_ms_per_step": ("stage_ms", "backward"),
       "train_optimizer_ms_per_step": ("stage_ms", "optimizer")}
SERVE_STAGES = {"encoder": 2.0, "decode": 80.0, "postnet": 9.0, "griffin_lim": 30.0,
                "istft_inv_preemphasis": 3.0, "to_host": 20.0}
TRAIN_STAGES = {"forward": 60.0, "backward": 100.0, "optimizer": 8.0}


def _record(i, stages, scale, profiled=True, **extra):
    return {"id": i, "name": "x", "profiled": profiled, "spans": [], "counters": {},
            "stage_ms": {k: v * scale for k, v in stages.items()}, **extra}


def _trace(root: str, n: int, per_span: bool = True) -> Trace:
    """``n`` profiled calls (one benchmark span each) or steps (one span
    over them all), each with the program's root span inside."""
    ev = [Event(root, "cpu", 1_000 * i + 10, 1_000 * i + 900) for i in range(n)]
    spans = [(1_000 * i, 1_000 * i + 950) for i in range(n)] if per_span else [(0, 1_000 * n)]
    return Trace(ev, spans, [{} for _ in range(n)])


@pytest.fixture
def kept(monkeypatch):
    """Set what ``profiling.records()`` returns."""
    def put(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return put


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_averages_the_profiled_records(metric, kept):
    train = metric.startswith("train")
    stages = TRAIN_STAGES if train else SERVE_STAGES
    key, stage = NEW[metric]
    # an unprofiled record first (outside the window), then the window's two
    recs = [_record(0, stages, 9.0, profiled=False, chunk_gap_ms=99.0)]
    recs += [_record(1 + i, stages, 1.0 + i, chunk_gap_ms=3.0 * (1 + i)) for i in range(2)]
    kept(recs)
    tr = _trace("tt.train_step" if train else "tt.synthesize", 2, per_span=not train)
    want = 4.5 if key == "chunk_gap_ms" else stages[stage] * 1.5
    assert harness.reader(metric).read(tr) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_reads_nothing_without_matching_records(metric, kept, monkeypatch):
    train = metric.startswith("train")
    root = "tt.train_step" if train else "tt.synthesize"
    stages = TRAIN_STAGES if train else SERVE_STAGES
    reader = harness.reader(metric)
    kept([_record(i, stages, 1.0, chunk_gap_ms=1.0) for i in range(2)])
    assert reader.read(_trace(root, 2)) is not None
    tr = _trace(root, 2)
    tr.info.append({})                               # three calls traced, two records
    assert reader.read(tr) is None
    kept([_record(0, stages, 1.0, chunk_gap_ms=1.0)])  # one record for two calls
    assert reader.read(_trace(root, 2)) is None
    kept([])
    assert reader.read(_trace(root, 2)) is None
    monkeypatch.delattr(profiling, "records")         # a program without the stage clock
    assert reader.read(_trace(root, 2)) is None


def test_chunk_gap_needs_it_in_every_record(kept):
    kept([_record(0, SERVE_STAGES, 1.0, chunk_gap_ms=2.0), _record(1, SERVE_STAGES, 1.0)])
    assert harness.reader("chunk_gap_ms_per_call").read(_trace("tt.synthesize", 2)) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_reports_each_metric_its_cell_lists(cell):
    out = tiny.run(cell, trace=1)
    listed = {m["name"] for m in BENCH["per_layer"]
              if m["name"] in NEW and cell in m["workloads"]}
    assert listed and listed <= set(out["metrics"]), (listed, out["metrics"])
    assert all(out["metrics"][m]["value"] > 0 for m in listed)
