"""The port's preprocessing and training CLIs against the JAX package's, on
the CPU, in process (``main(argv)``), at ``tiny_cpu`` with a small STFT
(n_fft 512, win 400, hop 128) on a 6-utterance synthetic corpus.

* Both preprocessing CLIs, each generating its corpus (``--synthetic 6``):
  the same corpus files, the same JSON line (but ``seconds``), and data
  directories with equal ``index.json``, ``vocab.json`` and ``texts.npy``
  and f16 features apart on at most 0.1% of their elements.
* The JAX CLI trains 4 steps (prenet dropout 0); both CLIs then resume
  copies of that run directory to step 6, reading the same data: each
  prints ``resumed from step 4``, the losses of steps 5 and 6 agree at rel
  1e-5, and every parameter and batch-statistic entry of the step-6
  checkpoints at rtol 1e-4 plus atol 1e-5, 1% of one Adam step (lr 1e-3).
  Adam's moments are warm by then, so the update is well conditioned
  (ROADMAP.md, traps), but biases that started at 0 are only ~5e-3 after
  six steps and a bias gradient is a sum that cancels, so they carry the
  summation-order difference of the last two updates (7.0e-6, a post-net
  batch-norm bias moved 1.8e-3 by them). As in tests/test_torch_train.py,
  an entry whose gradient is near 0 turns rounding noise into up to lr per
  step: at most 1 in 10^4 entries may miss, each within the two steps' 2 lr
  (1 of 535,729 entries measured, 2.1e-5, a post-net conv weight).
* The port CLI's own lines, checkpoints, ``--trace-steps`` (a trace file
  and its line), ``--eval-every`` (audio and alignment summaries),
  ``--device-cache`` (the same losses as the native assembler),
  ``--debug-nans`` (a NaN in the data raises), and both CLIs raising
  without a card and without ``--platform cpu``. ``--profile-port`` is
  tested in ``tests/test_torch_profiling.py``.
* ``SummaryWriter`` in both of its forms: tensorboardX, and plain files
  when tensorboardX (or matplotlib, or PIL) does not import.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from tacotron_tpu.cli import preprocess as jax_preprocess_cli
from tacotron_tpu.cli import train as jax_train_cli
from tacotron_tpu_torch.cli import preprocess as preprocess_cli
from tacotron_tpu_torch.cli import train as train_cli
from tacotron_tpu_torch.utils import SummaryWriter

AUDIO = ["--set", "audio.n_fft=512", "--set", "audio.win_length=400",
         "--set", "audio.hop_length=128"]
TRAIN = ["--preset", "tiny_cpu", "--batch-size", "8", "--num-buckets", "1",
         "--summary-every", "1", "--checkpoint-every", "2", *AUDIO]


def _run(main, argv):
    """-> stdout lines of ``main(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines()


def _summaries(lines):
    return [json.loads(ln) for ln in lines if ln.startswith('{"step"')]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    out = {}
    for name, main, extra in (("jax", jax_preprocess_cli.main, []),
                              ("port", preprocess_cli.main, ["--platform", "cpu"])):
        lines = _run(main, ["--corpus-dir", str(root / f"corpus_{name}"),
                            "--data-dir", str(root / f"data_{name}"), "--preset", "tiny_cpu",
                            "--synthetic", "6", "--chunk", "4", *AUDIO, *extra])
        out[name] = json.loads(lines[-1])
    lines = _run(jax_train_cli.main,
                 ["--data-dir", str(root / "data_jax"), "--run-dir", str(root / "run_jax4"),
                  "--steps", "4", "--platform", "cpu", "--set", "model.prenet_dropout=0.0",
                  *TRAIN])
    assert json.loads(lines[-1]) == {"done": True, "step": 4}
    return root, out


def test_preprocess_clis_agree(work):
    root, out = work
    assert {k: v for k, v in out["port"].items() if k != "seconds"} == \
        {k: v for k, v in out["jax"].items() if k != "seconds"}
    assert set(out["port"]) == set(out["jax"])
    for f in ("metadata.csv", *(os.path.join("wavs", w)
                                for w in os.listdir(root / "corpus_jax" / "wavs"))):
        assert (root / "corpus_port" / f).read_bytes() == (root / "corpus_jax" / f).read_bytes()
    for name in ("index.json", "vocab.json"):
        assert json.loads((root / "data_port" / name).read_text()) == \
            json.loads((root / "data_jax" / name).read_text())
    np.testing.assert_array_equal(np.load(root / "data_port" / "texts.npy"),
                                  np.load(root / "data_jax" / "texts.npy"))
    for name, tol in (("mels.npy", 1e-5), ("linears.npy", 3e-5)):
        got, want = np.load(root / "data_port" / name), np.load(root / "data_jax" / name)
        d = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert (d <= np.maximum(np.spacing(np.abs(want)), tol)).all(), name
        assert (d > 0).mean() <= 1e-3, name


def _leaves(ckpt):
    data = np.load(os.path.join(ckpt, "leaves.npz"))
    meta = json.loads(open(os.path.join(ckpt, "treedef.json")).read())
    return data, meta


def test_resume_of_a_jax_run_matches_jax(work):
    root, _ = work
    lines = {}
    for name, main, extra in (("jax", jax_train_cli.main, []),
                              ("port", train_cli.main, [])):
        run = root / f"resume_{name}"
        shutil.copytree(root / "run_jax4", run)
        lines[name] = _run(main, ["--data-dir", str(root / "data_jax"), "--run-dir", str(run),
                                  "--steps", "6", "--platform", "cpu",
                                  "--set", "model.prenet_dropout=0.0", *TRAIN, *extra])
    for name in ("jax", "port"):
        assert lines[name][0] == lines["jax"][0] and lines[name][0].startswith("buckets: [")
        assert lines[name][1] == "resumed from step 4"
        assert json.loads(lines[name][-1]) == {"done": True, "step": 6}
    got, want = _summaries(lines["port"]), _summaries(lines["jax"])
    assert [s["step"] for s in got] == [s["step"] for s in want] == [5, 6]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("mel_loss", "linear_loss", "total_loss"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (g["step"], k, g[k], w[k])
    (data, meta), (jdata, jmeta) = (_leaves(root / f"resume_{n}" / "ckpt" / "step_6")
                                    for n in ("port", "jax"))
    assert meta["n_leaves"] == jmeta["n_leaves"] and meta["step"] == jmeta["step"] == 6
    checked, n_off, n_all = 0, 0, 0
    for i, path in enumerate(meta["paths"]):
        if not path.startswith(("params/", "batch_stats/")):
            continue
        a, b = data[f"leaf_{i}"], jdata[f"leaf_{i}"]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        d = np.abs(a - b)
        off = d > 1e-5 + 1e-4 * np.abs(b)
        assert (d[off] <= 2 * 1e-3).all(), path
        n_off, n_all, checked = n_off + int(off.sum()), n_all + b.size, checked + 1
    assert checked > 40 and n_off <= 1e-4 * n_all, (n_off, n_all)


def test_port_cli_trains_traces_evaluates_and_resumes(work):
    root, _ = work
    run = root / "port_run"
    lines = _run(train_cli.main, ["--data-dir", str(root / "data_port"), "--run-dir", str(run),
                                  "--steps", "3", "--platform", "cpu", "--trace-steps", "2:2",
                                  "--eval-every", "3", *TRAIN])
    assert lines[0].startswith("buckets: [") and "resumed" not in "".join(lines)
    assert f"trace written: {run / 'trace'}" in lines
    assert [s["step"] for s in _summaries(lines)] == [1, 2, 3]
    assert all(np.isfinite(s["total_loss"]) and s["frames_per_s"] > 0 for s in _summaries(lines))
    assert json.loads(lines[-1]) == {"done": True, "step": 3}
    assert sorted(os.listdir(run / "ckpt")) == ["step_2", "step_3"]
    assert [f for f in os.listdir(run / "trace") if f.endswith(".pt.trace.json")]
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["model"]["vocab_size"] == 64 and cfg["model"]["n_freq"] == 257
    assert os.listdir(run / "tb")
    more = _run(train_cli.main, ["--data-dir", str(root / "data_port"), "--run-dir", str(run),
                                 "--steps", "4", "--platform", "cpu", *TRAIN])
    assert more[1] == "resumed from step 3"
    assert json.loads(more[-1]) == {"done": True, "step": 4}


def test_device_cache_trains_as_the_native_assembler(work):
    root, _ = work
    losses = {}
    for name, extra in (("native", []), ("cache", ["--device-cache"])):
        lines = _run(train_cli.main, ["--data-dir", str(root / "data_port"),
                                      "--run-dir", str(root / f"dc_{name}"), "--steps", "2",
                                      "--platform", "cpu", *TRAIN, *extra])
        losses[name] = [s["total_loss"] for s in _summaries(lines)]
    assert losses["native"] == losses["cache"] and len(losses["native"]) == 2


def test_debug_nans_raises_on_nan_data(work, tmp_path):
    root, _ = work
    data = tmp_path / "data"
    shutil.copytree(root / "data_port", data)
    mels = np.load(data / "mels.npy")
    mels[:] = np.nan
    np.save(data / "mels.npy", mels)
    with pytest.raises((RuntimeError, FloatingPointError), match="nan|not finite"):
        _run(train_cli.main, ["--data-dir", str(data), "--run-dir", str(tmp_path / "run"),
                              "--steps", "1", "--platform", "cpu", "--debug-nans", *TRAIN])
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("cli", ["preprocess", "train", "train_device_cache"])
def test_no_card_and_no_platform_raises(work, tmp_path, monkeypatch, cli):
    root, _ = work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if cli == "preprocess":
            preprocess_cli.main(["--corpus-dir", str(root / "corpus_port"),
                                 "--data-dir", str(tmp_path / "d"), "--preset", "tiny_cpu"])
        else:
            train_cli.main(["--data-dir", str(root / "data_port"),
                            "--run-dir", str(tmp_path / "r"), "--steps", "1", *TRAIN,
                            *(["--device-cache"] if cli == "train_device_cache" else [])])
    assert not (tmp_path / "d").exists() and not (tmp_path / "r").exists()


def _write_summaries(w):
    w.scalars({"loss": 0.5, "grad_norm": torch.tensor(2.0)}, 3, prefix="train/")
    w.alignment("train/alignment", np.eye(6, 4, dtype=np.float32), 3)
    w.audio("eval/audio", 0.1 * np.sin(np.arange(400) / 5.0), 16000, 3)
    w.flush()
    w.close()


def test_summary_writer_tensorboardx(tmp_path, capsys):
    w = SummaryWriter(str(tmp_path / "tb"))
    assert w.kind == "tensorboardX"
    assert "summary writer: tensorboardX" in capsys.readouterr().err
    _write_summaries(w)
    assert [f for f in os.listdir(tmp_path / "tb") if f.startswith("events.out.tfevents")]


def test_summary_writer_files_without_tensorboardx(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    w = SummaryWriter(str(tmp_path / "tb"))
    assert w.kind == "files"
    assert "summary writer: files" in capsys.readouterr().err
    _write_summaries(w)
    rows = [json.loads(ln) for ln in (tmp_path / "tb" / "scalars.jsonl").read_text().splitlines()]
    assert rows == [{"step": 3, "tag": "train/loss", "value": 0.5},
                    {"step": 3, "tag": "train/grad_norm", "value": 2.0}]
    np.testing.assert_array_equal(
        np.load(tmp_path / "tb" / "alignments" / "train_alignment_3.npy"), np.eye(6, 4))
    assert (tmp_path / "tb" / "audio" / "eval_audio_3.wav").stat().st_size > 800
