"""The port's synthesis CLI (``python -m tacotron_tpu_torch.cli.synthesize``)
against the JAX package's, on the CPU.

A run directory is written in the test as the JAX package's training CLI
writes one: ``config.json`` (``Config.to_json``), ``ckpt/`` (its
``checkpoint.save`` of a ``tiny_cpu`` ``create_train_state``) and, in the
data directory, ``vocab.json``. Both CLIs' ``main`` restore it and write
wavs for two prompts, on the step-by-step path and with ``--fused``, at
``--steps 4 --gl-iters 2`` (prenet dropout 0: JAX's PRNG cannot be
reproduced; the f32 Griffin-Lim loop, as tests/test_torch_synthesize.py
runs it).

Tolerance: the int16 samples within 5e-4 x 32767 + 1, the synthesis
tolerance of tests/test_torch_synthesize.py on peak-normalised wavs
plus one step of the PCM rounding. The JSON lines carry the same keys and
the same counts and audio seconds; the argparse exclusions exit with code
2 as the JAX package's do.
"""

import dataclasses
import glob
import json
import os
import wave

import numpy as np
import pytest

import jax

from tacotron_tpu.cli import synthesize as jax_cli
from tacotron_tpu.config import AudioConfig, get_config as jax_get_config
from tacotron_tpu.data.vocab import Vocab as JaxVocab
from tacotron_tpu.train import checkpoint as jax_checkpoint
from tacotron_tpu.train.step import create_train_state as jax_create_train_state
from tacotron_tpu_torch.cli import synthesize as cli

TEXTS = ["hello world", "test synthesis"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    c = jax_get_config("tiny_cpu")
    acfg = AudioConfig(n_fft=512, win_length=400, hop_length=128, n_mels=80,
                       griffin_lim_iters=4, gl_backend="mm_f32")
    jcfg = dataclasses.replace(c, audio=acfg, model=dataclasses.replace(
        c.model, vocab_size=40, n_freq=acfg.n_freq, prenet_dropout=0.0, max_decode_steps=6))
    run_dir, data_dir = root / "run", root / "data"
    os.makedirs(run_dir)
    os.makedirs(data_dir)
    (run_dir / "config.json").write_text(jcfg.to_json())
    jax_checkpoint.save(str(run_dir / "ckpt"), 3, jax_create_train_state(jcfg, jax.random.PRNGKey(0)))
    JaxVocab.build(TEXTS).save(str(data_dir / "vocab.json"))
    return root


def _argv(run, out, *extra):
    argv = ["--run-dir", str(run / "run"), "--data-dir", str(run / "data"),
            "--out-dir", str(out), "--steps", "4", "--gl-iters", "2", *extra]
    for t in TEXTS:
        argv += ["--text", t]
    return argv


def _read(out):
    wavs = []
    for path in sorted(glob.glob(os.path.join(out, "utt_*.wav"))):
        with wave.open(path) as f:
            assert f.getnchannels() == 1 and f.getsampwidth() == 2
            wavs.append((f.getframerate(), np.frombuffer(f.readframes(f.getnframes()), "<i2")))
    return wavs


def _json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "restored checkpoint at step 3"
    return json.loads(lines[-1])


@pytest.mark.parametrize("fused", [False, True])
def test_cli_matches_jax(run, capsys, fused):
    flag = ["--fused"] if fused else []
    jax_cli.main(_argv(run, run / f"jax_{fused}", *flag))
    want_line = _json_line(capsys)
    cli.main(_argv(run, run / f"port_{fused}", "--platform", "cpu", *flag))
    got_line = _json_line(capsys)
    assert sorted(got_line) == sorted(want_line)
    for k in ("n", "audio_seconds", "trimmed_audio_seconds"):
        assert got_line[k] == want_line[k], k
    want, got = _read(run / f"jax_{fused}"), _read(run / f"port_{fused}")
    assert len(got) == len(want) == len(TEXTS)
    for (gr, g), (wr, w) in zip(got, want):
        assert gr == wr and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.int32), w.astype(np.int32), rtol=0,
                                   atol=5e-4 * 32767 + 1)


def test_cli_preset_and_trace(run, capsys):
    """The serving preset (early exit, trimming, bf16 Griffin-Lim) on the
    split path, traced: trimmed wavs and a trace file."""
    out, trace = run / "fast", run / "trace"
    cli.main(_argv(run, out, "--platform", "cpu", "--preset", "synth_fast",
                   "--trace-dir", str(trace)))
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line["traced"] is True and line["n"] == len(TEXTS)
    assert f"trace written: {trace}" in lines
    assert glob.glob(os.path.join(trace, "*.pt.trace.json"))
    wavs = _read(out)
    assert len(wavs) == len(TEXTS) and all(0 < len(w) <= 4 * 5 * 128 for _, w in wavs)


@pytest.mark.parametrize("extra", [
    ["--fused", "--early-exit"],
    ["--fused", "--trim"],
    ["--fused", "--preset", "synth_fast"],
    ["--fused", "--set", "infer.early_exit=true"],
    ["--data-parallel", "--fused"],
])
def test_cli_exclusions_exit_2_as_jax(run, capsys, extra):
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(_argv(run, run / "never", *extra))
        assert e.value.code == 2
    assert "cannot combine" in capsys.readouterr().err


def test_cli_refusals(run, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--run-dir", "r", "--data-dir", "d", "--out-dir", "o"])
    assert e.value.code == 2 and "no prompts" in capsys.readouterr().err


def test_cli_runs_on_the_card_by_default(run):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_argv(run, run / "never"))
