"""The whole synthesis slice: JAX ``Synthesizer`` vs the port's
``Synthesizer(device="cpu")`` on the same weights, for the step-by-step
decode and the fused decode; plus the port's entry-point contract (GPU by
default, refusals, config compatibility) and its import rule.

JAX runs with ``gl_backend="mm_f32"``: its ``"pallas"`` falls back to the
bf16 ``"mm"`` loop on the CPU, which would compare bf16 against the port's
f32. The port runs its default ``"pallas"`` backend (the plain f32 loop on
CPU tensors) against it. Dropout is 0: JAX's PRNG cannot be reproduced.

Tolerances (max abs error measured on this setup in brackets): the
step-by-step path is f32 everywhere, atol 1e-5 on mel, linear, alignments
and the peak-normalised wavs [all <= 6e-8]; the fused path stores in bf16
on both sides, where a last-bit difference in an f32 sum can flip a bf16
rounding: mel rtol 1e-2 atol 2e-3 [5.1e-4 on a peak of 0.175], alignments
atol 2e-4 [2.7e-5], linear atol 1e-3 [2.0e-4], wavs atol 5e-4 [3.7e-5].
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from tacotron_tpu.config import AudioConfig, get_config as jax_get_config
from tacotron_tpu.data.vocab import Vocab as JaxVocab
from tacotron_tpu.infer import Synthesizer as JaxSynthesizer
from tacotron_tpu.infer.early_exit import end_frames_device as jax_end_frames_device
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu_torch.config import Config, apply_overrides
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.infer import Synthesizer
from tacotron_tpu_torch.infer.early_exit import end_frames, end_frames_device
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.weights import from_flax, init_params, split_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
TEXTS = ["hello world", "test synthesis"]
N_STEPS, GL_ITERS = 6, 4


@pytest.fixture(scope="module")
def setup():
    c = jax_get_config("tiny_cpu")
    acfg = AudioConfig(n_fft=512, win_length=400, hop_length=128, n_mels=80,
                       griffin_lim_iters=GL_ITERS, gl_backend="mm_f32")
    jcfg = dataclasses.replace(
        c, audio=acfg,
        model=dataclasses.replace(c.model, vocab_size=40, n_freq=acfg.n_freq,
                                  prenet_dropout=0.0, max_decode_steps=N_STEPS))
    vocab_chars = ["hello world test synthesis"]
    m = JaxTacotron(jcfg.model, train=False)
    v = m.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
               np.ones((2, 5), np.int32), np.array([5, 3]),
               gt_mel=np.zeros((2, 2 * jcfg.model.r, 80), np.float32))
    v = jax.tree_util.tree_map(np.asarray, v)
    cfg = Config.from_json(jcfg.to_json())
    cfg = apply_overrides(cfg, ['audio.gl_backend="pallas"'])
    params, stats = from_flax(v)
    return dict(jcfg=jcfg, v=v, jvocab=JaxVocab.build(vocab_chars), cfg=cfg,
                params=params, stats=stats, vocab=Vocab.build(vocab_chars))


@pytest.mark.parametrize("fused", [False, True])
def test_slice_matches_jax(setup, fused):
    s = setup
    want = JaxSynthesizer(s["jcfg"], s["v"]["params"], s["v"]["batch_stats"],
                          s["jvocab"], fused=fused)(TEXTS, seed=3)
    got = Synthesizer(s["cfg"], s["params"], s["stats"], s["vocab"], fused=fused,
                      device="cpu")(TEXTS, seed=3)
    assert sorted(got) == sorted(want)
    for k in ("mel", "linear", "alignments", "wavs"):
        assert got[k].shape == want[k].shape, k
    if fused:
        tol = {"mel": (1e-2, 2e-3), "alignments": (0, 2e-4),
               "linear": (0, 1e-3), "wavs": (0, 5e-4)}
    else:
        tol = {"mel": (0, 1e-5), "alignments": (0, 1e-5), "linear": (0, 1e-5),
               "wavs": (0, 1e-5)}
    for k, (rtol, atol) in tol.items():
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(got["end_frames"], np.asarray(want["end_frames"]))
    np.testing.assert_array_equal(got["wav_lengths"], np.asarray(want["wav_lengths"]))
    assert got["audio_seconds"] == pytest.approx(want["audio_seconds"])


def test_tacotron_forward_matches_jax(setup):
    s = setup
    text = np.array([[3, 5, 7, 2, 9, 4], [8, 1, 6, 0, 0, 0]])
    lengths = np.array([6, 3])
    want = JaxTacotron(s["jcfg"].model, train=False).apply(
        s["v"], text, lengths, n_steps=N_STEPS, rngs={"dropout": jax.random.PRNGKey(0)})
    model = Tacotron(s["cfg"].model, device="cpu")
    model.load_state_dict({**s["params"], **s["stats"]})
    model.eval()                                    # running batch-norm statistics
    with torch.no_grad():
        got = model(torch.from_numpy(text), torch.from_numpy(lengths), n_steps=N_STEPS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_end_frames_match_jax():
    mel = np.random.default_rng(0).uniform(0, 0.2, (4, 40, 8)).astype(np.float32)
    mel[1, 13:] = 0.01                      # silence from frame 13
    mel[2, 30:] = 0.0                       # a run shorter than min_run at the end
    mel[3] = 0.0                            # silent throughout
    want = np.asarray(jax_end_frames_device(mel, threshold=0.05, min_run=12))
    np.testing.assert_array_equal(end_frames(mel), want)
    np.testing.assert_array_equal(end_frames_device(torch.from_numpy(mel)).numpy(), want)
    assert want[1] == 13 and want[3] == 0
    short = end_frames_device(torch.from_numpy(mel[:, :5]))
    np.testing.assert_array_equal(short.numpy(), 5)


def test_stage_times_and_outputs(setup):
    s = setup
    out = Synthesizer(s["cfg"], s["params"], s["stats"], s["vocab"], fused=True,
                      device="cpu")(TEXTS, gl_iters=1, stage_ms=True)
    assert set(out["stage_ms"]) == {"encoder", "decode", "postnet", "griffin_lim",
                                    "istft_inv_preemphasis"}
    assert np.isfinite(out["wavs"]).all()
    assert np.abs(out["wavs"]).max() <= 1.0 + 1e-6


def test_default_device_is_the_gpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device does not raise")
    s = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer(s["cfg"], s["params"], s["stats"], s["vocab"])


@pytest.mark.parametrize("override,fused,error", [
    ("infer.early_exit=true", True, ValueError),
    ("infer.trim_before_gl=true", True, ValueError),
    ("infer.early_exit=true", False, NotImplementedError),
    ("infer.trim_before_gl=true", False, NotImplementedError),
    ("model.compute_dtype=bfloat16", False, NotImplementedError),
])
def test_refusals(setup, override, fused, error):
    s = setup
    cfg = apply_overrides(s["cfg"], [override])
    with pytest.raises(error):
        Synthesizer(cfg, s["params"], s["stats"], s["vocab"], fused=fused, device="cpu")


def test_unported_backends_and_mesh_raise(setup):
    s = setup
    with pytest.raises(NotImplementedError):
        Synthesizer(s["cfg"], s["params"], s["stats"], s["vocab"], mesh=object(),
                    device="cpu")
    for backend in ("mm", "fft"):
        cfg = apply_overrides(s["cfg"], [f"audio.gl_backend={backend}"])
        synth = Synthesizer(cfg, s["params"], s["stats"], s["vocab"], device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            synth(TEXTS, n_steps=2, gl_iters=1)


def test_config_json_from_jax_parses_strictly():
    for name in ("tiny_cpu", "synth_gl1000", "synth_fast", "pod_dp"):
        js = jax_get_config(name).to_json()
        assert Config.from_json(js).to_json() == js
    with pytest.raises(ValueError, match="unknown key"):
        Config.from_json('{"model": {"no_such_field": 1}}')
    assert Config.from_json("{}").model.cdtype is None
    assert Config.from_json('{"model": {"compute_dtype": "bfloat16"}}').model.cdtype \
        == torch.bfloat16


def test_seeded_init_drives_the_full_path_on_cpu():
    cfg = Config.from_json(jax_get_config("tiny_cpu").to_json())
    cfg = apply_overrides(cfg, ["audio.n_fft=256", "audio.win_length=200",
                                "audio.hop_length=64", "model.n_freq=129"])
    vocab = Vocab.build(TEXTS)
    cfg = apply_overrides(cfg, [f"model.vocab_size={len(vocab)}"])
    p, bs = split_state(init_params(Tacotron(cfg.model, device="cpu"), seed=0))
    out = Synthesizer(cfg, p, bs, vocab, fused=True, device="cpu")(
        TEXTS, n_steps=4, gl_iters=2, seed=1)
    assert out["wavs"].shape == (2, 64 * (4 * cfg.model.r - 1))
    assert np.isfinite(out["wavs"]).all() and np.abs(out["wavs"]).max() > 0


def _port_files():
    pkg = os.path.join(ROOT, "tacotron_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax():
    banned = ("jax", "flax", "tacotron_tpu")
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in banned:
                    bad.append(f"{path}: {n}")
    assert len(_port_files()) > 10
    assert not bad, bad
