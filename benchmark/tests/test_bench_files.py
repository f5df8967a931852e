"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, driver and per-layer reader exists, parses and agrees."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from benchmark import harness, inputs
from benchmark.reference.model import param_spec

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_metrics():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = harness.load_cell(cell, BENCH)
    assert c.entry["chips"] == 1 and len(c.entry["why"]) <= 200
    assert (harness.HERE / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert c.checks["limits"] and c.checks["control"]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(c.end_to_end) >= 3 and c.per_layer
    cfg = harness.port_config(c)
    spec = param_spec(harness.plain(cfg)["model"])
    assert spec["encoder.embed.embedding"][0] == len(inputs.char_ids()) + 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    from tacotron_tpu_torch.config import ModelConfig
    path = harness.ROOT / entry["file"]
    assert path.parts[len(harness.ROOT.parts)] == "benchmark"
    cfg = json.loads(path.read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert set(cfg["model"]) == {f.name for f in dataclasses.fields(ModelConfig)}
    # every key that departs from the paper is explained, and none is a width
    assert set(cfg["assumed"]) == {"vocab_size", *cfg["reduced"]}
    assert not set(cfg["reduced"]) & set(cfg["model"])
    assert cfg["audio"]["griffin_lim_power"] == 1.2 and cfg["audio"]["n_fft"] == 2048


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_declares_what_the_benchmark_says(metric):
    r = harness.reader(metric["name"])
    assert (r.LAYER, r.UNIT, r.MOVES) == (metric["layer"], metric["unit"], metric["moves"])


def test_layers_spelled_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
