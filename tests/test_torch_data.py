"""The port's data pipeline against the JAX package's, on the CPU.

At the JAX data tests' small audio config (``ACFG``: n_fft 512, win 400,
hop 128, 20 mels) and on the same generated corpora:

* the Slaney filterbank equal to JAX's;
* ``spectrogram`` / ``melspectrogram`` within 3e-5 (linear) and 1e-5 (mel)
  of JAX's, both FFT-bound: on the 10-utterance synthetic corpus the port's
  ``torch.fft`` and JAX's FFT differ by up to 1.80e-5 on the normalised
  linear spectrogram and 3.1e-7 on the mel (the dB scale multiplies an
  FFT's last-bit error in a spectral valley);
* ``preprocess`` against JAX's on one corpus: ``index.json``,
  ``vocab.json`` and ``texts.npy`` equal; the f16 ``mels`` / ``linears``
  differ on at most 0.1% of their elements (20 of 219,221 linear ones),
  each by at most one f16 ulp or the f32 features' tolerance above: near 0
  an f16 ulp is finer than the FFT's error (one linear element, 0.0037,
  lies 2 ulps, 3.8e-6, from JAX's). The features are independent of the
  chunk grouping, bit for bit;
* the corpus generators' files byte-equal to JAX's, ``read_metadata`` on
  all four layouts, ``load_wav`` with resampling, ``decode_char_tones`` and
  ``char_accuracy`` equal to JAX's;
* ``make_buckets`` / ``assign_bucket`` equal to JAX's on seeded lengths;
* ``DataLoader`` on a data directory the JAX package wrote: the same bucket
  specs, the same bucket and items at every step of two shuffled epochs
  (wrap-fill included) and batches equal element for element to JAX's
  numpy assembler, on the port's native, numpy and CPU device-cache paths;
* the native library built under ``build/tacotron_tpu_torch/``, a broken
  compiler raising, the device-cache preflight refusing an oversized
  corpus, ``device_prefetch`` order and drain, the loader's thread stopped
  on close and its errors raised.
"""

import filecmp
import json
import os
import stat

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tacotron_tpu import dsp as jax_dsp
from tacotron_tpu.config import AudioConfig as JaxAudioConfig
from tacotron_tpu.data import buckets as jax_buckets
from tacotron_tpu.data import ljspeech as jax_ljspeech
from tacotron_tpu.data.loader import DataLoader as JaxDataLoader
from tacotron_tpu.data.loader import Dataset as JaxDataset
from tacotron_tpu.dsp.mel import mel_filterbank as jax_mel_filterbank
from tacotron_tpu_torch import dsp, runtime
from tacotron_tpu_torch.config import AudioConfig
from tacotron_tpu_torch.data import buckets, ljspeech
from tacotron_tpu_torch.data.loader import (DataLoader, Dataset, DeviceCache, device_prefetch,
                                            put_batch)
from tacotron_tpu_torch.dsp.mel import mel_filterbank
from tacotron_tpu_torch.native import binding

AKW = dict(n_fft=512, win_length=400, hop_length=128, n_mels=20)
ACFG, JAX_ACFG = AudioConfig(**AKW), JaxAudioConfig(**AKW)
LINEAR_TOL, MEL_TOL = 3e-5, 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    jax_ljspeech.generate_synthetic_corpus(str(d), n=10, min_sec=0.3, max_sec=0.8)
    return str(d)


@pytest.fixture(scope="module")
def jax_data(corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_data")
    jax_ljspeech.preprocess(corpus, str(d), JAX_ACFG, chunk=4)
    return str(d)


@pytest.fixture(scope="module")
def port_data(corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("port_data")
    stats = ljspeech.preprocess(corpus, str(d), ACFG, chunk=4, device="cpu")
    assert stats["n_utterances"] == 10
    return str(d)


@pytest.fixture(scope="module")
def loader_data(tmp_path_factory):
    """A JAX-written data directory with buckets that batches of 3 do not
    fill: 23 utterances over 0.2-1.2 s."""
    root = tmp_path_factory.mktemp("loader")
    jax_ljspeech.generate_synthetic_corpus(str(root / "c"), n=23, min_sec=0.2, max_sec=1.2)
    jax_ljspeech.preprocess(str(root / "c"), str(root / "d"), JAX_ACFG, chunk=8)
    return str(root / "d")


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (22050, 512, 20, 0.0, None), (22050, 2048, 80, 0.0, None),
    (16000, 1024, 40, 50.0, 7000.0), (48000, 2048, 128, 0.0, 12000.0)])
def test_mel_filterbank_equals_jax(sr, n_fft, n_mels, fmin, fmax):
    np.testing.assert_array_equal(mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                                  jax_mel_filterbank(sr, n_fft, n_mels, fmin, fmax))


@pytest.mark.parametrize("preemph,center", [(True, True), (False, False)])
def test_features_match_jax(corpus, preemph, center):
    worst = {"linear": 0.0, "mel": 0.0}
    for f in sorted(os.listdir(os.path.join(corpus, "wavs"))):
        y = jax_ljspeech.load_wav(os.path.join(corpus, "wavs", f))
        pairs = {"linear": (dsp.spectrogram, jax_dsp.spectrogram),
                 "mel": (dsp.melspectrogram, jax_dsp.melspectrogram)}
        for name, (ours, theirs) in pairs.items():
            got = ours(torch.from_numpy(y), ACFG, preemph=preemph, center=center).numpy()
            want = np.asarray(theirs(jnp.asarray(y), JAX_ACFG, preemph=preemph, center=center))
            assert got.shape == want.shape
            worst[name] = max(worst[name], float(np.abs(got - want).max()))
    assert worst["linear"] <= LINEAR_TOL and worst["mel"] <= MEL_TOL, worst


def test_forward_helpers_match_jax():
    rs = np.random.default_rng(0)
    y = rs.standard_normal((2, 3000)).astype(np.float32)
    np.testing.assert_allclose(dsp.preemphasis(torch.from_numpy(y), 0.97).numpy(),
                               np.asarray(jax_dsp.preemphasis(jnp.asarray(y), 0.97)),
                               rtol=0, atol=1e-6)
    x = np.abs(y) * 10
    np.testing.assert_allclose(dsp.amp_to_db(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_dsp.amp_to_db(jnp.asarray(x))), rtol=1e-6, atol=1e-5)
    s = rs.uniform(-120, 10, (4, 7)).astype(np.float32)
    np.testing.assert_allclose(dsp.normalize(torch.from_numpy(s), ACFG).numpy(),
                               np.asarray(jax_dsp.normalize(jnp.asarray(s), JAX_ACFG)),
                               rtol=0, atol=1e-7)
    mag = dsp.stft_magnitude(torch.from_numpy(y), 512, 128, 400).numpy()
    want = np.asarray(jax_dsp.stft_magnitude(jnp.asarray(y), 512, 128, 400))
    np.testing.assert_allclose(mag, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def _f16_apart(got, want, tol):
    """-> (every element within one f16 ulp of ``want`` or ``tol``, the
    fraction of elements that differ)."""
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    ulp = np.spacing(np.abs(want)).astype(np.float32)
    return bool((d <= np.maximum(ulp, tol)).all()), float((d > 0).mean())


def test_preprocess_matches_jax(jax_data, port_data):
    for name in ("index.json", "vocab.json"):
        with open(os.path.join(jax_data, name)) as f, open(os.path.join(port_data, name)) as g:
            assert json.load(f) == json.load(g), name
    np.testing.assert_array_equal(np.load(os.path.join(port_data, "texts.npy")),
                                  np.load(os.path.join(jax_data, "texts.npy")))
    for name, tol in (("mels.npy", MEL_TOL), ("linears.npy", LINEAR_TOL)):
        got, want = np.load(os.path.join(port_data, name)), np.load(os.path.join(jax_data, name))
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        within, frac = _f16_apart(got, want, tol)
        assert within and frac <= 1e-3, (name, within, frac)
    with open(os.path.join(jax_data, "config.json")) as f, \
            open(os.path.join(port_data, "config.json")) as g:
        assert json.load(f) == json.load(g)


def test_features_independent_of_chunk_grouping(corpus, tmp_path):
    d1, d5 = tmp_path / "c1", tmp_path / "c5"
    ljspeech.preprocess(corpus, str(d1), ACFG, chunk=1, device="cpu")
    ljspeech.preprocess(corpus, str(d5), ACFG, chunk=5, device="cpu")
    a, b = Dataset(str(d1)), Dataset(str(d5))
    np.testing.assert_array_equal(a.mels, b.mels)
    np.testing.assert_array_equal(a.linears, b.linears)


def test_batched_features_match_single_utterance(corpus, port_data):
    """Every stored frame, the tail frames whose window crosses the
    signal's end included, equals the utterance's own features (f16)."""
    ds = Dataset(port_data)
    wav = ljspeech.load_wav(os.path.join(corpus, "wavs", "SYN-0003.wav"))
    single = dsp.melspectrogram(torch.from_numpy(wav), ACFG).numpy()
    _, stored, _ = ds.utterance(3)
    assert len(stored) == len(single) == len(wav) // ACFG.hop_length + 1
    np.testing.assert_array_equal(stored, single.astype(np.float16).astype(np.float32))


def test_preprocess_needs_a_card_or_cpu(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ljspeech.preprocess(corpus, str(tmp_path / "d"), ACFG)
    assert not (tmp_path / "d").exists()


@pytest.mark.parametrize("kind,kw", [
    ("synthetic", dict(n=5, seed=3, min_sec=0.2, max_sec=0.5)),
    ("char_tone", dict(n=4, seed=1, text_len=6, char_sec=0.05, char_sec_jitter=0.3,
                       alphabet_size=12))])
def test_corpus_generators_write_jax_files(tmp_path, kind, kw):
    fn = f"generate_{kind}_corpus"
    getattr(ljspeech, fn)(str(tmp_path / "port"), **kw)
    getattr(jax_ljspeech, fn)(str(tmp_path / "jax"), **kw)
    cmp = filecmp.dircmp(tmp_path / "port", tmp_path / "jax")
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    wavs = sorted(os.listdir(tmp_path / "port" / "wavs"))
    assert len(wavs) == kw["n"]
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port" / "wavs", tmp_path / "jax" / "wavs",
                                           wavs, shallow=False)
    assert not mismatch and not errors


def test_decode_char_tones_and_accuracy_match_jax(tmp_path):
    jax_ljspeech.generate_char_tone_corpus(str(tmp_path), n=3, text_len=8, char_sec=0.08,
                                           alphabet_size=10, seed=2)
    entries = jax_ljspeech.read_metadata(str(tmp_path))
    for _, wav_path, text in entries:
        y = jax_ljspeech.load_wav(wav_path)
        got = ljspeech.decode_char_tones(y, alphabet_size=10)
        assert got == jax_ljspeech.decode_char_tones(y, alphabet_size=10)
        assert ljspeech.char_accuracy(text, got) == jax_ljspeech.char_accuracy(text, got)
    for ref, hyp in [("abcde", "abde"), ("abc", ""), ("", "xy"), ("kitten", "sitting")]:
        assert ljspeech.char_accuracy(ref, hyp) == jax_ljspeech.char_accuracy(ref, hyp)


def _write_layouts(root):
    """One corpus of each layout read_metadata knows; -> {fmt: dir}."""
    z = np.zeros(100, np.float32)
    lj = root / "lj"
    (lj / "wavs").mkdir(parents=True)
    (lj / "metadata.csv").write_text("LJ-1|Raw text one|normalized one\nLJ-2|only raw|\nbad\n")
    vctk = root / "vctk"
    for spk, utts in [("p225", ["p225_001", "p225_002"]), ("p226", ["p226_001"])]:
        (vctk / "txt" / spk).mkdir(parents=True)
        (vctk / "wav48" / spk).mkdir(parents=True)
        for u in utts:
            (vctk / "txt" / spk / f"{u}.txt").write_text(f"utterance {u}\n")
            jax_ljspeech.save_wav(str(vctk / "wav48" / spk / f"{u}.wav"), z, 22050)
    (vctk / "txt" / "p226" / "p226_009.txt").write_text("no wav for this one")
    arctic = root / "arctic"
    (arctic / "etc").mkdir(parents=True)
    (arctic / "wav").mkdir()
    (arctic / "etc" / "txt.done.data").write_text(
        '( arctic_a0001 "Author of the danger trail." )\n'
        '( arctic_a0002 "Not at this particular case." )\n( arctic_a0003 "no wav" )\n')
    for u in ["arctic_a0001", "arctic_a0002"]:
        jax_ljspeech.save_wav(str(arctic / "wav" / f"{u}.wav"), z, 22050)
    nancy = root / "nancy"
    (nancy / "wavn").mkdir(parents=True)
    (nancy / "prompts.data").write_text('( APDC2-001-01 "Hello there." )\n')
    jax_ljspeech.save_wav(str(nancy / "wavn" / "APDC2-001-01.wav"), z, 22050)
    return {"ljspeech": lj, "vctk": vctk, "arctic": arctic, "blizzard": nancy}


def test_read_metadata_matches_jax_on_every_layout(tmp_path):
    for fmt, d in _write_layouts(tmp_path).items():
        got = ljspeech.read_metadata(str(d), fmt)
        assert got == jax_ljspeech.read_metadata(str(d), fmt) and got, fmt
    with pytest.raises(ValueError, match="unknown corpus format"):
        ljspeech.read_metadata(str(tmp_path), "timit")


def test_load_wav_and_resample_match_jax(tmp_path):
    t = np.arange(24000) / 48000.0
    path = str(tmp_path / "tone48k.wav")
    jax_ljspeech.save_wav(path, 0.5 * np.sin(2 * np.pi * 440.0 * t), 48000)
    for rate in (None, 48000, 22050, 16000):
        got, want = ljspeech.load_wav(path, rate), jax_ljspeech.load_wav(path, rate)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_preprocess_vctk_at_native_rate_matches_jax(tmp_path):
    root = tmp_path / "vctk"
    (root / "txt" / "p225").mkdir(parents=True)
    (root / "wav48" / "p225").mkdir(parents=True)
    t = np.arange(24000) / 48000.0
    for u in ["p225_001", "p225_002"]:
        (root / "txt" / "p225" / f"{u}.txt").write_text(f"utt {u}")
        jax_ljspeech.save_wav(str(root / "wav48" / "p225" / f"{u}.wav"),
                              0.4 * np.sin(2 * np.pi * 300 * t), 48000)
    stats = ljspeech.preprocess(str(root), str(tmp_path / "p"), ACFG, fmt="vctk", device="cpu")
    want = jax_ljspeech.preprocess(str(root), str(tmp_path / "j"), JAX_ACFG, fmt="vctk")
    assert stats == want
    with open(tmp_path / "p" / "index.json") as f, open(tmp_path / "j" / "index.json") as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("seed,num_buckets,r", [(0, 8, 5), (1, 3, 2), (2, 1, 5), (3, 5, 1)])
def test_buckets_match_jax(seed, num_buckets, r):
    rs = np.random.default_rng(seed)
    frames = rs.integers(20, 500, 150)
    texts = rs.integers(5, 90, 150)
    got = buckets.make_buckets(texts, frames, num_buckets, r)
    want = jax_buckets.make_buckets(texts, frames, num_buckets, r)
    assert [b.key() for b in got] == [b.key() for b in want]
    assert all(b.n_frames % r == 0 for b in got)
    for t, f in zip(rs.integers(1, 120, 60), rs.integers(1, 600, 60)):
        assert buckets.assign_bucket(got, int(t), int(f)) == \
            jax_buckets.assign_bucket(want, int(t), int(f))


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("assembler", ["native", "numpy", "device_cache"])
def test_loader_matches_jax(loader_data, assembler):
    """Two shuffled epochs: the same bucket and items at every step, wrap
    fill included, and the same batch element for element."""
    kw = dict(batch_size=3, num_buckets=3, r=5, seed=7)
    want_dl = JaxDataLoader(JaxDataset(loader_data), use_native=False, **kw)
    dl = DataLoader(Dataset(loader_data), use_native=assembler == "native",
                    device_cache=assembler == "device_cache", device="cpu", **kw)
    assert dl.assembler == assembler
    assert [b.key() for b in dl.buckets] == [b.key() for b in want_dl.buckets]
    assert len(dl.buckets) > 1
    assert {b: v.tolist() for b, v in dl.assignments.items()} == \
        {b: v.tolist() for b, v in want_dl.assignments.items()}
    for _ in range(2):
        got, want = list(dl.epoch()), list(want_dl.epoch())
        assert [(b.bucket, tuple(map(int, b.items))) for b in got] == \
            [(b.bucket, tuple(map(int, b.items))) for b in want]
        for g, w in zip(got, want):
            for name, a, b in zip(("text", "text_len", "mel", "linear", "frame_len"),
                                  g.arrays(), (w.text, w.text_len, w.mel, w.linear, w.frame_len)):
                a = _as_numpy(a)
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    steps = sum(-(-len(v) // 3) for v in dl.assignments.values())
    assert steps * 3 > len(Dataset(loader_data)), "no bucket needs a wrap fill"


def test_native_library_builds_under_build_dir(loader_data):
    DataLoader(Dataset(loader_data), batch_size=2, num_buckets=1, r=5)
    path = binding.library_path()
    assert path.parent == runtime.BUILD_DIR
    assert runtime.BUILD_DIR.parts[-2:] == ("build", "tacotron_tpu_torch")
    assert path.exists() and path in binding._LIBS
    assert not [p for p in os.listdir(binding.SOURCE.parent) if p.endswith(".so")]


def test_native_build_failure_raises(loader_data, tmp_path, monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'broken compiler: no' >&2\nexit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(binding, "CXX", str(cxx))
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken compiler"):
        DataLoader(Dataset(loader_data), batch_size=2, num_buckets=1, r=5, use_native=True)
    assert not list((tmp_path / "build").glob("*"))
    monkeypatch.setattr(binding, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native batcher build failed"):
        DataLoader(Dataset(loader_data), batch_size=2, num_buckets=1, r=5)


def test_device_cache_preflight_refuses_oversized_corpus(loader_data, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: calls.append(dev) or (512, 1024))
    with pytest.raises(ValueError, match="DeviceCache: packed corpus needs"):
        DataLoader(Dataset(loader_data), batch_size=2, num_buckets=1, r=5,
                   device_cache=True)
    assert calls == [torch.device("cuda")]


def test_device_cache_without_a_card_raises(loader_data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCache(Dataset(loader_data))


def test_device_prefetch_keeps_depth_in_flight_in_order():
    put_log, out = [], []
    for host, dev in device_prefetch(iter(range(6)), lambda b: put_log.append(b) or b * 10,
                                     depth=2):
        assert len(put_log) >= min(len(out) + 2, 6)
        out.append((host, dev))
    assert out == [(i, i * 10) for i in range(6)]
    assert put_log == list(range(6))


def test_device_prefetch_drains_tail():
    assert list(device_prefetch(iter([7]), lambda b: b, depth=4)) == [(7, 7)]
    assert list(device_prefetch(iter([]), lambda b: b)) == []


def test_put_batch_on_the_cpu(loader_data):
    b = next(DataLoader(Dataset(loader_data), batch_size=2, num_buckets=2, r=5,
                        use_native=False).epoch())
    arrays, pinned = put_batch(b, "cpu")
    assert pinned == ()
    for t, a in zip(arrays, b.arrays()):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), a)


def test_stream_follows_epochs_and_stops_on_close(loader_data):
    kw = dict(batch_size=3, num_buckets=3, r=5, seed=5, use_native=False)
    ref = DataLoader(Dataset(loader_data), **kw)
    want = [b.items for _ in range(2) for b in ref.epoch()]
    stream = iter(DataLoader(Dataset(loader_data), **kw))
    got = [next(stream).items for _ in range(len(want))]
    assert got == want
    stream.close()
    assert not [t for t in __import__("threading").enumerate() if t.name == "DataLoader"]


def test_stream_raises_the_threads_error(loader_data, monkeypatch):
    dl = DataLoader(Dataset(loader_data), batch_size=3, num_buckets=3, r=5, use_native=False)

    def broken(bucket_id, items):
        raise OSError("disk gone")

    monkeypatch.setattr(dl, "_make_batch", broken)
    stream = iter(dl)
    with pytest.raises(RuntimeError, match="thread failed") as e:
        next(stream)
    assert isinstance(e.value.__cause__, OSError)

