"""``tacotron_tpu_torch.utils.profiling`` on the CPU: ``force`` and
``time_fn`` (JAX's leaf order and semantics), ``enable_compilation_cache``
(the built libraries' directory, moved and restored), the live-capture
server alone, and the training CLI's ``--profile-port`` on a 6-utterance
synthetic corpus (``tiny_cpu``, a small STFT), preprocessed by the port's
CLI as ``tests/test_torch_train_cli.py``'s ``work`` fixture does.

The CLI test makes the capture window wait, by a wrapped ``stop_trace``,
until the client's overlapping request has been answered, so that the
request lands while the window is open whatever the host's speed.
"""

import contextlib
import glob
import io
import json
import os
import socket
import subprocess
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.cli import preprocess as preprocess_cli
from tacotron_tpu_torch.cli import train as train_cli
from tacotron_tpu_torch.native import binding
from tacotron_tpu_torch.utils import profiling

AUDIO = ["--set", "audio.n_fft=512", "--set", "audio.win_length=400",
         "--set", "audio.hop_length=128"]
# r 5: a step of the corpus's 200 frames is 40 decoder steps, not 100
TRAIN = ["--preset", "tiny_cpu", "--batch-size", "8", "--num-buckets", "1", "--set", "model.r=5",
         "--summary-every", "1", "--checkpoint-every", "100", *AUDIO]


def _trees():
    a, b, c = (np.arange(n, dtype=np.float32) - 1.5 for n in (3, 4, 5))
    return [a, [b, c], (None, b), {"z": a, "b": {"y": c, "x": b}}, {"k": [None, (c,)], "a": None},
            2.5]


@pytest.mark.parametrize("i", range(len(_trees())))
def test_force_takes_jax_first_leaf(i):
    tree = _trees()[i]
    want = float(np.abs(np.asarray(jax.tree_util.tree_leaves(tree)[0])).sum())
    assert profiling.force(tree) == want
    as_torch = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x, tree)
    assert profiling.force(as_torch) == want


def test_force_without_a_leaf_raises():
    with pytest.raises(ValueError, match="no leaf"):
        profiling.force({"a": None, "b": []})


def test_time_fn_calls_and_waits():
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.01)
        return {"out": x * 2}

    s = profiling.time_fn(fn, torch.ones(3), iters=3, warmup=2)
    assert len(calls) == 5 and 0.01 <= s < 1.0


@pytest.fixture
def cache_dir(tmp_path):
    yield tmp_path / "kernels"
    profiling.enable_compilation_cache(None)


def test_compilation_cache_moves_and_restores_the_build_dir(cache_dir, monkeypatch):
    assert runtime.BUILD_DIR == runtime.DEFAULT_BUILD_DIR
    profiling.enable_compilation_cache(cache_dir)
    for name in runtime.KERNEL_SOURCES:
        assert runtime.library_path(name).parent == cache_dir
    assert binding.library_path().parent == cache_dir
    # the native assembler is built there once; a second process finds it
    assert binding.build() == binding.library_path() and binding.library_path().exists()

    def no_compiler(*a, **k):
        raise AssertionError(f"a compiler was started: {a}")

    monkeypatch.setattr(subprocess, "run", no_compiler)
    monkeypatch.setattr(subprocess, "Popen", no_compiler)
    assert binding.build() == binding.library_path()
    profiling.enable_compilation_cache(None)
    assert runtime.BUILD_DIR == runtime.DEFAULT_BUILD_DIR
    assert runtime.library_path("probe").parent == runtime.DEFAULT_BUILD_DIR
    assert binding.library_path().parent == runtime.DEFAULT_BUILD_DIR


def _get(port, path):
    """-> (HTTP status, JSON reply)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _listening(port):
    with socket.socket() as s:
        return s.connect_ex(("127.0.0.1", port)) == 0


def test_server_alone_hands_over_and_answers():
    server = profiling.start_server(0)
    port = server.port
    replies = {}
    try:
        assert _get(port, "/status") == (200, {"state": "idle", "step": None})
        assert server.poll(0) == 0
        t = threading.Thread(target=lambda: replies.update(a=_get(port, "/capture?steps=3")))
        t.start()
        while server.status()["state"] != "pending":
            time.sleep(0.005)
        assert _get(port, "/capture?steps=1")[0] == 409
        assert server.poll(4, idle=False) == 0          # another window is open: it waits
        assert server.poll(5) == 3 and server.status() == {"state": "open", "step": 5}
        assert _get(port, "/capture?steps=2")[0] == 409
        assert _get(port, "/capture?steps=x")[0] == 400
        assert _get(port, "/nowhere")[0] == 404
        server.finish({"steps": [6, 8]})
        t.join(30)
        assert not t.is_alive() and replies["a"] == (200, {"steps": [6, 8]})
        # a request still waiting when the run ends gets 503
        t = threading.Thread(target=lambda: replies.update(b=_get(port, "/capture?steps=1")))
        t.start()
        while server.status()["state"] != "pending":
            time.sleep(0.005)
    finally:
        server.close()
    t.join(30)
    assert not t.is_alive() and replies["b"][0] == 503
    assert not _listening(port)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("profiling")
    with contextlib.redirect_stdout(io.StringIO()):
        preprocess_cli.main(["--corpus-dir", str(root / "corpus"), "--data-dir",
                             str(root / "data"), "--preset", "tiny_cpu", "--synthetic", "6",
                             "--chunk", "4", *AUDIO, "--platform", "cpu"])
    return root / "data"


@pytest.fixture
def one_thread():
    """One intra-op thread for the CLI runs: a tiny step is thousands of
    small operations, which a loaded host (the suite's other workers) slows
    by 10-100x when each waits for a team of threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_with_client(monkeypatch, data_dir, run, steps, client):
    """``cli.train`` with ``--profile-port`` on a free port; ``client(port,
    server)`` runs on its own thread, started once the server is up, and
    the run starts its first step once the client's first request is
    pending. -> the CLI's stdout lines."""
    port = _free_port()
    start = profiling.start_server
    threads = []

    def start_with_client(p):
        server = start(p)
        threads.append(threading.Thread(target=client, args=(port, server)))
        threads[0].start()
        while server.status()["state"] == "idle" and threads[0].is_alive():
            time.sleep(0.005)
        return server

    monkeypatch.setattr(profiling, "start_server", start_with_client)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--data-dir", str(data_dir), "--run-dir", str(run), "--steps", str(steps),
                        "--platform", "cpu", "--profile-port", str(port), *TRAIN])
    threads[0].join(120)
    assert not threads[0].is_alive()
    assert not _listening(port)
    lines = buf.getvalue().strip().splitlines()
    assert json.loads(lines[-1]) == {"done": True, "step": steps}
    return lines


def test_profile_port_captures_a_step(data_dir, tmp_path, monkeypatch, one_thread):
    run = tmp_path / "run"
    answered = threading.Event()
    stop = profiling.stop_trace

    def stop_after_the_client(prof):
        assert answered.wait(60), "the client's bad requests were not answered"
        stop(prof)

    monkeypatch.setattr(profiling, "stop_trace", stop_after_the_client)
    replies = {}

    def client(port, server):
        try:
            first = threading.Thread(target=lambda: replies.update(
                capture=_get(port, "/capture?steps=1")))
            first.start()
            while _get(port, "/status")[1]["state"] != "open":
                time.sleep(0.005)
            replies["overlap"] = _get(port, "/capture?steps=1")
            replies["zero"] = _get(port, "/capture?steps=0")
            answered.set()
            first.join(120)
        finally:
            answered.set()

    lines = _train_with_client(monkeypatch, data_dir, run, 2, client)
    code, reply = replies["capture"]
    assert code == 200 and reply["trace_dir"] == str(run / "trace") and reply["steps"] == [1, 1]
    # the Chrome trace and, beside it, the stage clock's records of the window
    traces = [f for f in reply["files"] if f.endswith(".pt.trace.json")]
    recs = [f for f in reply["files"] if f.endswith(".tt_records.json")]
    assert len(traces) == len(recs) == 1 and len(reply["files"]) == 2
    assert sorted(os.path.basename(f) for f in glob.glob(str(run / "trace" / "*.pt.trace.json"))) \
        == traces
    (rec,) = json.loads((run / "trace" / recs[0]).read_text())["records"]
    assert rec["name"] == "train_step" and rec["profiled"]
    assert "trace written: " + str(run / "trace") in lines
    assert replies["overlap"][0] == 409 and "already open" in replies["overlap"][1]["error"]
    assert replies["zero"][0] == 400 and "steps" in replies["zero"][1]["error"]


def test_profile_port_window_past_the_last_step(data_dir, tmp_path, monkeypatch, one_thread):
    """A capture asked for more steps than the run has left is written at
    the run's last step and answered with the steps it spans."""
    replies = {}
    _train_with_client(monkeypatch, data_dir, tmp_path / "run", 2,
                       lambda port, server: replies.update(c=_get(port, "/capture?steps=10")))
    code, reply = replies["c"]
    assert code == 200 and reply["steps"] == [1, 2] and len(reply["files"]) == 2
    assert sum(f.endswith(".pt.trace.json") for f in reply["files"]) == 1
