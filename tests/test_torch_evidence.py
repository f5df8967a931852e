"""The evidence runners, ``cli.alignment_run`` and ``cli.audio_evidence``,
against the JAX package's ``scripts/alignment_run.py`` and
``scripts/audio_evidence.py``, on the CPU; and the gates on the port's
committed evidence.

* The prompts: ``held_out_prompts`` string-equal to the JAX script's, and
  the corpus-prompt filter and the decode budget to what the JAX script's
  ``main`` picks on the same corpus (its synthesis and checkpoint replaced
  by stand-ins in this test: only the prompt choice is held).
* The scorers: the port's ``decode_char_tones`` and ``char_accuracy`` equal
  to JAX's on the JAX run's committed wavs
  (``artifacts/audio_evidence_r5_heldout/``).
* The scoring pass: the runner's ``eval_fwd`` against JAX's (a
  ``Tacotron(train=False)`` apply with a fixed dropout key, as the JAX
  script defines it) on weights carried by ``weights.from_flax`` with
  perturbed running statistics, ``tiny_cpu``, prenet dropout 0: alignments
  atol 1e-5.
* Both runners end to end at ``tiny_cpu`` on ``--platform cpu``: 4
  utterances, 3 steps with ``--save-every 2``, a resume for 2 more, then 2
  prompts at ``--gl-iters 4``. The summaries carry the JAX summaries' keys,
  the resume continues at the right step, and the saved alignments
  re-score to the recorded summary.
* The alignment PNG without matplotlib: the plain heatmap, read back.
* Gates on ``artifacts/alignment_r5_torch/``,
  ``artifacts/audio_evidence_r5_torch/`` and
  ``artifacts/audio_evidence_r5_torch_heldout/`` with the port's own
  scorers, at the JAX gates' bars (``tests/unit/test_alignment_artifact.py``,
  ``tests/unit/test_audio_evidence.py``): alignments recomputed from the
  ``.npy`` (diag_corr >= 0.9, monotonic >= 0.95, equal to the recorded
  summary), every wav re-decoded to its recorded accuracy (atol 1e-4) and
  the mean >= 0.7. Each skips while its artifact is absent.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.data import ljspeech as jax_ljspeech
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu_torch.cli import alignment_run, audio_evidence
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.data import ljspeech
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.utils.metrics import alignment_scores
from tacotron_tpu_torch.weights import from_flax

ROOT = os.path.join(os.path.dirname(__file__), "..")
ART = os.path.join(ROOT, "artifacts")
DIAG_CORR_GATE, MONOTONIC_GATE, ACCURACY_GATE = 0.9, 0.95, 0.7


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines()


# ------------------------------------------------------------------ prompts

@pytest.mark.parametrize("n,text_len,alphabet,seed",
                         [(8, 20, 26, 123), (5, 7, 3, 0), (3, 30, 26, 9)])
def test_held_out_prompts_equal_jax(n, text_len, alphabet, seed):
    want = _jax_script("audio_evidence").held_out_prompts(n, text_len, alphabet, seed)
    assert audio_evidence.held_out_prompts(n, text_len, alphabet, seed) == want


@pytest.mark.parametrize("corpus", [False, True], ids=["held_out", "corpus"])
def test_prompt_choice_and_budget_equal_jax_main(tmp_path, monkeypatch, corpus):
    """The JAX script's ``main`` on a 40-utterance corpus with its
    synthesis and checkpoint replaced: the prompts it synthesizes and its
    decode budget, against the port's choice on the same files."""
    jax_ljspeech.generate_char_tone_corpus(str(tmp_path / "corpus"), n=40, text_len=20,
                                           alphabet_size=26, char_sec=0.06)
    data = tmp_path / "data"
    data.mkdir()
    Vocab.build(["abcdefghijklmnopqrstuvwxyz"]).save(str(data / "vocab.json"))
    run = tmp_path / "run"
    run.mkdir()
    jcfg = jax_get_config("tiny_cpu")
    (run / "config.json").write_text(jcfg.to_json())
    seen = {}

    class Synth:
        def __init__(self, *a, **k):
            pass

        def __call__(self, prompts, n_steps, gl_iters):
            seen.update(prompts=list(prompts), n_steps=n_steps)
            return {"wavs": [np.zeros(4096, np.float32)] * len(prompts)}

    import tacotron_tpu.infer
    import tacotron_tpu.train.checkpoint
    import tacotron_tpu.train.step

    state = types.SimpleNamespace(params=None, batch_stats=None)
    monkeypatch.setattr(tacotron_tpu.infer, "Synthesizer", Synth)
    monkeypatch.setattr(tacotron_tpu.train.step, "create_train_state", lambda *a, **k: state)
    monkeypatch.setattr(tacotron_tpu.train.checkpoint, "restore", lambda *a, **k: (state, 0))
    argv = ["--run-dir", str(run), "--data-dir", str(data), "--out", str(tmp_path / "out"),
            "--char-sec", "0.06", *(["--corpus-prompts"] if corpus else [])]
    monkeypatch.setattr(sys, "argv", ["audio_evidence.py", *argv])
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_script("audio_evidence").main()
    if corpus:
        got = audio_evidence.corpus_prompts(str(data), 8)
        assert any(a == b for ln in (tmp_path / "corpus" / "metadata.csv").read_text().split()
                   for t in [ln.split("|")[1]] for a, b in zip(t, t[1:]))   # some are skipped
    else:
        got = audio_evidence.held_out_prompts(8, 20, 26, 123)
    assert got == seen["prompts"] and len(got) == 8
    cfg = Config.from_json(jcfg.to_json())
    assert audio_evidence.decode_budget(20, 0.06, cfg.audio.sample_rate, cfg.audio.hop_length,
                                        cfg.model.r) == seen["n_steps"]


# ------------------------------------------------------------------ scorers

def _jax_heldout():
    art = os.path.join(ART, "audio_evidence_r5_heldout")
    with open(os.path.join(art, "summary.json")) as f:
        return art, json.load(f)


def test_decoder_and_accuracy_equal_jax_on_the_committed_jax_wavs():
    art, s = _jax_heldout()
    assert len(s["per_prompt"]) == 8
    for row in s["per_prompt"]:
        path = os.path.join(art, row["wav"])
        wav = ljspeech.load_wav(path)
        np.testing.assert_array_equal(wav, jax_ljspeech.load_wav(path))
        full = ljspeech.decode_char_tones(wav, s["sample_rate"], s["alphabet_size"])
        assert full == jax_ljspeech.decode_char_tones(wav, s["sample_rate"], s["alphabet_size"])
        hyp = full[: len(row["prompt"])]
        assert hyp == row["decoded"]
        acc = ljspeech.char_accuracy(row["prompt"], hyp)
        assert acc == jax_ljspeech.char_accuracy(row["prompt"], hyp)
        np.testing.assert_allclose(acc, row["char_accuracy"], atol=1e-4)


# ------------------------------------------------------------------ scoring pass

def test_eval_fwd_matches_jax_eval_fwd():
    c = jax_get_config("tiny_cpu")
    jcfg = dataclasses.replace(c, model=dataclasses.replace(
        c.model, vocab_size=32, n_freq=257, prenet_dropout=0.0))
    lens = np.array([9, 6, 4])
    rs = np.random.default_rng(0)
    text = rs.integers(1, 30, (3, 9)) * (np.arange(9)[None, :] < lens[:, None])
    mel = rs.uniform(0, 1, (3, 20, 80)).astype(np.float32)
    jm = JaxTacotron(jcfg.model, train=False)
    v = jm.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                jnp.asarray(text), jnp.asarray(lens), gt_mel=jnp.asarray(mel))
    v = jax.tree_util.tree_map(np.asarray, v)

    # running statistics away from init, so that eval mode is what is held
    def stat(path, x):
        name = jax.tree_util.keystr(path)
        return (rs.uniform(0.5, 1.5, x.shape) if "var" in name
                else rs.normal(0, 0.2, x.shape)).astype(x.dtype)

    v = {**v, "batch_stats": jax.tree_util.tree_map_with_path(stat, v["batch_stats"])}
    # the JAX script's eval_fwd
    want = JaxTacotron(jcfg.model, train=False).apply(
        v, jnp.asarray(text), jnp.asarray(lens), gt_mel=jnp.asarray(mel),
        rngs={"dropout": jax.random.PRNGKey(0)}).alignments

    model = Tacotron(Config.from_json(jcfg.to_json()).model, device="cpu")
    params, stats = from_flax(v)
    model.load_state_dict({**params, **stats})
    model.train()
    got = alignment_run.eval_fwd(model, torch.from_numpy(text), torch.from_numpy(lens),
                                 torch.from_numpy(mel).half())
    assert model.training                       # the mode is restored
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------------ the runners

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("evidence")
    out, run = str(root / "align"), str(root / "align_work" / "run")
    common = ["--platform", "cpu", "--n-utts", "4", "--text-len", "6", "--batch-size", "2",
              "--save-every", "2", "--log-every", "1", "--out", out, "--save-run", run]
    first = _run(alignment_run.main, [*common, "--steps", "3"])
    with open(os.path.join(out, "summary.json")) as f:
        first_summary = json.load(f)
    resumed = _run(alignment_run.main, [*common, "--steps", "2", "--resume-from", run])
    audio = _run(audio_evidence.main,
                 ["--platform", "cpu", "--run-dir", run, "--data-dir",
                  str(root / "align_work" / "data"), "--out", str(root / "audio"),
                  "--n-prompts", "2", "--text-len", "6", "--char-sec", "0.06",
                  "--gl-iters", "4", "--no-dropout"])
    return dict(root=root, out=out, run=run, first=first, first_summary=first_summary,
                resumed=resumed, audio=audio)


def _summary(path):
    with open(os.path.join(path, "summary.json")) as f:
        return json.load(f)


def test_alignment_run_summary_has_jax_keys_and_rescores(runs):
    s = _summary(runs["out"])
    jax_s = _summary(os.path.join(ART, "alignment_r5"))
    assert sorted(s) == sorted(jax_s)
    assert sorted(s["args"]) == sorted(jax_s["args"])
    assert sorted(s["final"]) == sorted(jax_s["final"])
    assert "eval_fwd" in s["scoring"] and s["backend"] == "cpu"
    assert [row["step"] for row in s["curve"]] == [4, 5]          # the resumed run's curve
    al = np.load(os.path.join(runs["out"], "final_alignments.npy"))
    assert al.shape[0] == 2
    scores = [alignment_scores(al[j], s["text_lens"][j], s["frame_steps"][j])
              for j in range(al.shape[0])]
    for key, agg in (("diag_corr", np.mean), ("monotonic_frac", np.mean),
                     ("diag_corr", np.min), ("monotonic_frac", np.min)):
        name = f"{key}_{'mean' if agg is np.mean else 'min'}"
        np.testing.assert_allclose(float(agg([x[key] for x in scores])), s[name], atol=1e-6)
    png = open(os.path.join(runs["out"], "alignment_utt0.png"), "rb").read()
    assert png.startswith(b"\x89PNG\r\n\x1a\n")


def test_alignment_run_resumes_at_the_saved_step(runs):
    from tacotron_tpu_torch.train import checkpoint

    assert runs["first_summary"]["steps"] == 3
    assert any("at step 3" in ln and ln.startswith("resumed from") for ln in runs["resumed"])
    assert _summary(runs["out"])["steps"] == 5
    # every --save-every step below the end, and the end
    assert checkpoint.all_steps(os.path.join(runs["run"], "ckpt")) == [2, 3, 4, 5]
    cfg = Config.from_json(open(os.path.join(runs["run"], "config.json")).read())
    assert cfg.audio.n_fft == 512 and cfg.audio.hop_length == 128 and cfg.model.r == 5


def test_audio_evidence_summary_has_jax_keys(runs):
    s = _summary(runs["root"] / "audio")
    jax_s = _summary(os.path.join(ART, "audio_evidence_r5_heldout"))
    assert sorted(s) == sorted(jax_s)
    assert sorted(s["per_prompt"][0]) == sorted(jax_s["per_prompt"][0])
    assert s["checkpoint_step"] == 5 and s["prenet_dropout"] == 0.0 and s["backend"] == "cpu"
    assert [r["prompt"] for r in s["per_prompt"]] == audio_evidence.held_out_prompts(2, 6, 26, 123)
    for row in s["per_prompt"]:
        wav = ljspeech.load_wav(str(runs["root"] / "audio" / row["wav"]))
        hyp = ljspeech.decode_char_tones(wav, s["sample_rate"], s["alphabet_size"])[:6]
        assert hyp == row["decoded"]


def test_alignment_png_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib does not import (the card's machine), the PNG is the
    plain heatmap, written with zlib: decoder steps left to right, encoder
    positions bottom to top."""
    from tacotron_tpu_torch.utils import metrics

    def no_matplotlib(*a, **k):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(metrics, "plot_alignment", no_matplotlib)
    al = np.repeat(np.eye(6, dtype=np.float32), 2, axis=0)   # step i attends position i // 2
    path = str(tmp_path / "a.png")
    with contextlib.redirect_stdout(io.StringIO()):
        alignment_run.save_alignment_png(path, al, "t")
    import PIL.Image

    img = np.asarray(PIL.Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(img, metrics.alignment_heatmap(al))
    h, w, _ = img.shape
    bright = img.sum(-1) > img.sum(-1).mean()
    assert bright[h - 1, 0] and bright[0, w - 1] and not bright[0, 0]


# ------------------------------------------------------------------ gates

def test_port_alignment_artifact_is_a_monotonic_diagonal():
    art = os.path.join(ART, "alignment_r5_torch")
    if not os.path.exists(os.path.join(art, "final_alignments.npy")):
        pytest.skip("artifact not yet committed")
    s = _summary(art)
    al = np.load(os.path.join(art, "final_alignments.npy"))
    scores = [alignment_scores(al[j], s["text_lens"][j], s["frame_steps"][j])
              for j in range(al.shape[0])]
    diag = float(np.mean([x["diag_corr"] for x in scores]))
    mono = float(np.mean([x["monotonic_frac"] for x in scores]))
    np.testing.assert_allclose(diag, s["diag_corr_mean"], atol=1e-6)
    np.testing.assert_allclose(mono, s["monotonic_frac_mean"], atol=1e-6)
    assert "eval_fwd" in s["scoring"]
    assert diag >= DIAG_CORR_GATE, f"diag_corr_mean {diag}"
    assert mono >= MONOTONIC_GATE, f"monotonic_frac_mean {mono}"


@pytest.mark.parametrize("dirname", ["audio_evidence_r5_torch", "audio_evidence_r5_torch_heldout"])
def test_port_committed_audio_decodes_back_to_its_prompts(dirname):
    art = os.path.join(ART, dirname)
    if not os.path.exists(os.path.join(art, "summary.json")):
        pytest.skip(f"{dirname} artifact not yet committed")
    s = _summary(art)
    accs = []
    for row in s["per_prompt"]:
        wav = ljspeech.load_wav(os.path.join(art, row["wav"]))
        hyp = ljspeech.decode_char_tones(wav, s["sample_rate"],
                                         s["alphabet_size"])[: len(row["prompt"])]
        acc = ljspeech.char_accuracy(row["prompt"], hyp)
        np.testing.assert_allclose(acc, row["char_accuracy"], atol=1e-4)
        accs.append(acc)
    assert abs(float(np.mean(accs)) - s["char_accuracy_mean"]) <= 1e-4
    assert float(np.mean(accs)) >= ACCURACY_GATE, accs
