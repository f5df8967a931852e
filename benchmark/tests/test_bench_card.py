"""On the card: each cell runs a short window at its own size and comes out
correct, and its control at that size comes out not correct. Skipped
without a card; run there with

    python3 -m pytest benchmark/tests/test_bench_card.py -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark import run as bench_run
from benchmark.tests.test_bench_files import BENCH

CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench_run.precision_flags()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                          str(2 ** 31 + 1234), "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct_at_full_size(card, cell):
    from benchmark.compare import judge, worst
    c = harness.load_cell(cell, BENCH)
    run = harness.driver(c).Run(c, 2 ** 31 + 4321, "cuda")
    run.setup()
    run.window(2.0)
    run.release()
    run.check()
    ok, rows = judge(worst(run.control(**c.checks["control"])), c.checks["limits"])
    assert not ok, rows
