"""The whole synthesis slice: JAX ``Synthesizer`` vs the port's
``Synthesizer(device="cpu")`` on the same weights, for the step-by-step
decode, the fused decode, the early-exit decode and trimming before
Griffin-Lim (the ``synth_fast`` recipe's shape) and every Griffin-Lim
backend; plus the port's entry-point contract (GPU by default, refusals,
config compatibility) and its import rule.

Both sides run ``gl_backend="mm_f32"`` unless a test says otherwise, so
that the model's tolerances are not hidden under bf16 Griffin-Lim noise.
Dropout is 0: JAX's PRNG cannot be reproduced.

Tolerances (max abs error measured on this setup in brackets): the
step-by-step path is f32 everywhere, atol 1e-5 on mel, linear, alignments
and the peak-normalised wavs [all <= 6e-8], the same for the early-exit and
trimmed runs [<= 8.7e-7]; the fused path stores in bf16
on both sides, where a last-bit difference in an f32 sum can flip a bf16
rounding: mel rtol 1e-2 atol 2e-3 [5.1e-4 on a peak of 0.175], alignments
atol 2e-4 [2.7e-5], linear atol 1e-3 [2.0e-4], wavs atol 5e-4 [3.7e-5].
Griffin-Lim backends, peak-normalised wavs: ``"mm"`` (the bf16 loop with
the JAX loop's rounding points) one bf16 ulp, 2^-8 [9.3e-6]; ``"fft"``
1e-4 [1.9e-8]; ``"pallas"``, where JAX on the CPU runs its bf16 ``"mm"`` loop
and the port the kernel's plain bf16 version, which round at different
points (tests/test_torch_gl_lowp.py says why), 1e-2 [5.4e-5: the random
weights' linear spectrogram is nearly flat, so the two agree far better
here than on the speech-like input of that file].
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from tacotron_tpu.config import AudioConfig, get_config as jax_get_config
from tacotron_tpu.config import apply_overrides as jax_apply_overrides
from tacotron_tpu.data.vocab import Vocab as JaxVocab
from tacotron_tpu.infer import Synthesizer as JaxSynthesizer
from tacotron_tpu.infer.early_exit import end_frames_device as jax_end_frames_device
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu_torch.config import Config, apply_overrides, get_config
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
    # JAX's keys, and which path ran: the eager one on the CPU
    assert sorted(got) == sorted([*want, "graphed"]) and got["graphed"] is False
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
])
def test_refusals(setup, override, fused, error):
    s = setup
    cfg = apply_overrides(s["cfg"], [override])
    with pytest.raises(error):
        Synthesizer(cfg, s["params"], s["stats"], s["vocab"], fused=fused, device="cpu")


def test_unported_backends_and_mesh_raise(setup):
    s = setup
    # mesh synthesis is ported (tests/test_torch_multiprocess.py holds it);
    # on a mesh the fused decode is refused, as in JAX
    from tacotron_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="drop fused=True"):
        Synthesizer(s["cfg"], s["params"], s["stats"], s["vocab"], fused=True,
                    mesh=make_mesh(s["cfg"].mesh, platform="cpu"), device="cpu")
    cfg = apply_overrides(s["cfg"], ["audio.gl_backend=librosa"])
    synth = Synthesizer(cfg, s["params"], s["stats"], s["vocab"], device="cpu")
    with pytest.raises(ValueError, match="unknown gl_backend"):
        synth(TEXTS, n_steps=2, gl_iters=1)


def _pair(s, overrides, **call):
    """The JAX Synthesizer and the port's on the same overrides and call."""
    jcfg = jax_apply_overrides(s["jcfg"], overrides)
    cfg = apply_overrides(s["cfg"], overrides)
    want = JaxSynthesizer(jcfg, s["v"]["params"], s["v"]["batch_stats"],
                          s["jvocab"])(TEXTS, seed=3, **call)
    got = Synthesizer(cfg, s["params"], s["stats"], s["vocab"],
                      device="cpu")(TEXTS, seed=3, **call)
    assert sorted(got) == sorted([*want, "graphed"]) and got["graphed"] is False
    for k in ("mel", "linear", "alignments", "wavs"):
        assert got[k].shape == np.asarray(want[k]).shape, k
    np.testing.assert_array_equal(got["end_frames"], np.asarray(want["end_frames"]))
    np.testing.assert_array_equal(got["wav_lengths"], np.asarray(want["wav_lengths"]))
    assert got["audio_seconds"] == pytest.approx(want["audio_seconds"])
    assert got["trimmed_audio_seconds"] == pytest.approx(want["trimmed_audio_seconds"])
    return got, want


# The tiny model's per-step peaks rise from 0.09 / 0.11 (rows 0 / 1) at step
# 0 to 0.15 / 0.19 at step 9; row 1 crosses 0.133 at step 3. Per frame, row
# 0 first falls below 0.0675 at frame 1, row 1 at frame 3.
_EXIT = ["infer.early_exit=true", "infer.silence_threshold=0.133"]
# bf16 compute: JAX's jitted Synthesizer keeps a fusion's bf16 intermediates
# in f32 on the CPU (xla_allow_excess_precision), the port rounds where the
# JAX code writes bf16, so the two differ by bf16 roundings. atol, the
# largest error over the scan, early-exit, trimmed and fused paths x 2:
# mel [9.8e-4 on a peak of 0.22], linear [6.1e-4 of 0.11], alignments
# [5.0e-5], peak-normalised wavs [2.2e-4]
BF16_TOL = {"mel": (0, 2e-3), "linear": (0, 1.3e-3), "alignments": (0, 1e-4), "wavs": (0, 5e-4)}
_TRIM = ["infer.trim_before_gl=true", "infer.silence_threshold=0.0675",
         "infer.min_silence_frames=1", "infer.gl_length_quantum=2"]


@pytest.mark.parametrize("name,overrides,steps_done,t_gl,ends", [
    ("early_exit, not fused", _EXIT, 3, 50, [0, 0]),
    ("trim_before_gl, not fused", _TRIM, 10, 4, [1, 3]),
    ("synth_fast shape: early exit + trim, quantum 8",
     _EXIT + ["infer.trim_before_gl=true", "infer.gl_length_quantum=8"], 3, 8, [0, 0]),
])
def test_split_path_matches_jax(setup, name, overrides, steps_done, t_gl, ends):
    s = setup
    hop, r = s["cfg"].audio.hop_length, s["cfg"].model.r
    got, want = _pair(s, overrides, n_steps=10)
    for k in ("mel", "linear", "alignments", "wavs"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, err_msg=k)
    assert got["wavs"].shape == (2, hop * (t_gl - 1))
    np.testing.assert_array_equal(got["end_frames"], ends)
    mel = got["mel"]
    assert np.abs(mel[:, :steps_done * r]).min(axis=(0, 2)).max() > 0
    assert np.abs(mel[:, steps_done * r:]).max(initial=0.0) == 0.0
    assert np.abs(got["alignments"][:, steps_done:]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("dropout", ["0.0", "0.5"])
def test_early_exit_path_equals_the_fixed_path(setup, dropout):
    """The split path's early-exit decode at a threshold that never trips
    against the fixed path's step-by-step decode, the same weights and seed:
    the mel and the alignments are equal bit for bit (the early exit's step
    runs the cell's operations and draws the prenet's dropout masks in the
    cell's order)."""
    s = setup
    fixed = apply_overrides(s["cfg"], [f"model.prenet_dropout={dropout}"])
    early = apply_overrides(fixed, ["infer.early_exit=true", "infer.silence_threshold=-1"])
    got, want = (Synthesizer(c, s["params"], s["stats"], s["vocab"], device="cpu")(
        TEXTS, n_steps=10, seed=3) for c in (early, fixed))
    assert got["mel"].shape == want["mel"].shape == (2, 10 * s["cfg"].model.r, 80)
    np.testing.assert_array_equal(got["mel"], want["mel"])
    np.testing.assert_array_equal(got["alignments"], want["alignments"])


@pytest.mark.parametrize("backend,atol", [("mm", 2.0 ** -8), ("fft", 1e-4), ("pallas", 1e-2)])
def test_gl_backends_match_jax(setup, backend, atol):
    got, want = _pair(setup, [f"audio.gl_backend={backend}"], n_steps=N_STEPS)
    np.testing.assert_allclose(got["linear"], np.asarray(want["linear"]), atol=1e-5)
    np.testing.assert_allclose(got["wavs"], np.asarray(want["wavs"]), atol=atol)


@pytest.mark.parametrize("path,overrides", [
    ("scan", []),
    ("early_exit", _EXIT),
    ("early_exit_trim", _EXIT + ["infer.trim_before_gl=true", "infer.gl_length_quantum=8"]),
])
def test_bf16_matches_jax(setup, path, overrides):
    """``compute_dtype="bfloat16"`` through the step-by-step decode and the
    split early-exit path, against JAX's bf16 ``Synthesizer``."""
    got, want = _pair(setup, ["model.compute_dtype=bfloat16"] + overrides, n_steps=10)
    for k, (rtol, atol) in BF16_TOL.items():
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k)


def test_bf16_fused_matches_jax(setup):
    s = setup
    cfg = apply_overrides(s["cfg"], ["model.compute_dtype=bfloat16"])
    jcfg = jax_apply_overrides(s["jcfg"], ["model.compute_dtype=bfloat16"])
    want = JaxSynthesizer(jcfg, s["v"]["params"], s["v"]["batch_stats"],
                          s["jvocab"], fused=True)(TEXTS, seed=3)
    got = Synthesizer(cfg, s["params"], s["stats"], s["vocab"], fused=True,
                      device="cpu")(TEXTS, seed=3)
    for k, (rtol, atol) in BF16_TOL.items():
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k)


def test_synth_fast_preset_runs_the_split_path(setup):
    """The preset itself (early exit, trim, momentum 0.99, the kernel's bf16
    mode through its plain version, gl_trim_chunks accepted) on the tiny
    model and geometry."""
    s = setup
    fast = get_config("synth_fast")
    assert fast.infer.early_exit and fast.infer.trim_before_gl
    assert fast.audio.gl_backend == "pallas" and fast.audio.gl_trim_chunks
    assert fast.audio.gl_momentum == 0.99 and fast.audio.griffin_lim_iters == 100
    cfg = dataclasses.replace(
        s["cfg"], infer=dataclasses.replace(fast.infer, silence_threshold=0.133),
        audio=dataclasses.replace(s["cfg"].audio, gl_backend="pallas", gl_momentum=0.99,
                                  gl_trim_chunks=True, griffin_lim_iters=3))
    out = Synthesizer(cfg, s["params"], s["stats"], s["vocab"], device="cpu")(
        TEXTS, n_steps=40, seed=3)
    q, hop = fast.infer.gl_length_quantum, cfg.audio.hop_length
    assert out["mel"].shape[1] == 40 * cfg.model.r
    assert out["wavs"].shape == (2, hop * (q - 1))            # trimmed to one quantum
    assert np.isfinite(out["wavs"]).all() and np.abs(out["wavs"]).max() > 0
    with pytest.raises(ValueError, match="fused decode cannot combine"):
        Synthesizer(cfg, s["params"], s["stats"], s["vocab"], fused=True, device="cpu")


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
