"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: without a GPU every test skips (the kernels have
no CPU mode). This file imports no JAX, so it also runs where only PyTorch
is installed: ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.

Tolerances (max abs error): decode frames and alignments in f32 storage
1e-4 (summation order only; alignments 1e-5 at every cluster size); in
bf16 storage 2e-2 on frames and 1e-3 on alignments (a last-bit difference
in an f32 sum can flip a bf16 rounding); the decode's keep counts equal at
every cluster size;
Griffin-Lim waveform 1e-3 of its peak in f32 and 2e-2 in bf16 (kernel and
plain version share every rounding point, so only sums that differ in their
last bit flip a bf16 rounding, which Griffin-Lim then carries along), the
bf16 kernel also held to converging as well as its plain version (magnitude
error <= plain's * 1.05 + 1e-3); the streaming kernel (K5) the same per
mode, and in f32 within 1e-3 of the whole-loop kernel; at 2048/275/1102
one bf16 iteration of either kernel within one bf16 ulp (2^-7) of the
magnitude's peak, one f32 iteration of either (split TF32 products) within
2x the plain f32 step's own error against the same step summed in f64, and
K5 bit-equal to K4 at beta 0 in both modes; the probes: shared
memory exact, ops 1e-4 of its peak, one launch, the same bits on every
call, the cluster barrier launched at every
cluster size, the empty kernel launched at every cluster size of K2 and on
the ops kernel's cluster (launches counted as the kernel nodes of a CUDA
graph captured around one call, which cannot miss one);
attention energy (K1) and its
three gradients (K2) 1e-5 of each one's peak (f32, summation order only),
at K2's every cluster size too, dv the same bits on every call, K2 one
device kernel per call and its counter back at 0 between calls of other
batch sizes, and calls in flight on two streams each held as alone;
in bf16 (keys and q bf16) against ``energy_bwd_reference`` with the same
rounding points: e and dv (f32) 1e-5 of the peak, dkeys and dq each entry
within one bf16 ulp (2^-7 of its magnitude: an f32 sum's last bit can flip
a rounding) plus 1e-5 of the peak (dq is an f32 sum taken in another
order, which near 0 differs by more than an ulp of the result), and under
autograd against autograd through the formula 4e-2
of each peak, JAX's bf16 tolerance for its kernel against the formula;
the teacher-forced training loss through the kernels vs the plain formula
rtol 1e-5, every parameter gradient within 1e-4 of its peak plus 1e-7.
"""

import collections
import dataclasses

import pytest
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.dsp.audio import spectrogram_magnitude
from tacotron_tpu_torch.dsp.dft import gl_spectrum_mm, istft_mm, stft_mm
from tacotron_tpu_torch import probe
from tacotron_tpu_torch.dsp.fused_gl import (f64_matmul, gl_spectrum_reference,
                                             gl_step_reference, griffin_lim_spectrum,
                                             griffin_lim_step, zero_phase)
from tacotron_tpu_torch.models.tacotron import Tacotron, length_mask
from tacotron_tpu_torch.ops.attn_energy import (BWD_CLUSTERS, _ticket, attention_energy,
                                                attention_energy_reference, energy_bwd,
                                                energy_bwd_reference, energy_fwd, fwd_grid)
from tacotron_tpu_torch.ops.decode_loop import (CLUSTER_SIZES, _decode_loop_cuda,
                                                cluster_plan, decode_loop,
                                                decode_loop_reference, pack_decoder_weights)
from tacotron_tpu_torch.train.loss import tacotron_loss
from tacotron_tpu_torch.weights import init_params


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def decoder_inputs(dev):
    cfg = dataclasses.replace(get_config("tiny_cpu").model, vocab_size=32)
    model = init_params(Tacotron(cfg, device=dev), seed=0).eval()
    lengths = torch.tensor([9, 6, 4], device=dev)
    text = torch.randint(1, 30, (3, 9), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        memory = model.encoder(text, lengths, torch.Generator(device=dev).manual_seed(2))
        keys = model.memory_proj(memory)
    return memory, keys, length_mask(9, lengths), pack_decoder_weights(model.decoder.cell)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp,atol_f,atol_a", [(False, 1e-4, 1e-4), (True, 2e-2, 1e-3)])
def test_decode_kernel_matches_plain(decoder_inputs, lowp, atol_f, atol_a):
    memory, keys, mask, w = decoder_inputs
    before = runtime.LAUNCHES["decode_loop"]
    with torch.no_grad():
        kf, ka = decode_loop(memory, keys, mask, w, n_steps=6, dropout=False, lowp=lowp)
        pf, pa = decode_loop_reference(memory, keys, mask, w, n_steps=6,
                                       dropout=False, lowp=lowp)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["decode_loop"] == before + 1
    assert float((kf - pf).abs().max()) <= atol_f
    assert float((ka - pa).abs().max()) <= atol_a
    assert float(ka[2, :, 4:].max()) < 1e-6


@pytest.mark.cuda
def test_decode_kernel_dropout(decoder_inputs):
    memory, keys, mask, w = decoder_inputs
    with torch.no_grad():
        a, _, counts = decode_loop(memory, keys, mask, w, n_steps=100, seed=1,
                                   dropout_rate=0.5, return_keep_counts=True)
        b, _ = decode_loop(memory, keys, mask, w, n_steps=100, seed=1, dropout_rate=0.5)
        c, _ = decode_loop(memory, keys, mask, w, n_steps=100, seed=2, dropout_rate=0.5)
        off, _ = decode_loop(memory, keys, mask, w, n_steps=100, dropout=False)
        r0, _ = decode_loop(memory, keys, mask, w, n_steps=100, seed=3, dropout_rate=0.0)
    units = memory.shape[0] * 100 * (w.p_w0.shape[0] + w.p_w1.shape[0])
    assert abs(float(counts.sum()) / units - 0.5) < 0.01
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert torch.equal(off, r0)


@pytest.fixture(scope="module")
def full_decoder_inputs(dev):
    """synth_gl1000 widths (the [main] path's), B 8, T_in 120, rows of
    120 down to 64 positions."""
    cfg = dataclasses.replace(get_config("synth_gl1000").model, vocab_size=40)
    model = init_params(Tacotron(cfg, device=dev), seed=0).eval()
    lengths = torch.tensor([120, 96, 111, 80, 120, 64, 101, 90], device=dev)
    text = torch.randint(1, 40, (8, 120), generator=torch.Generator().manual_seed(1)).to(dev)
    mask = length_mask(120, lengths)
    with torch.no_grad():
        memory = model.encoder(torch.where(mask, text, 0), lengths,
                               torch.Generator(device=dev).manual_seed(2))
        keys = model.memory_proj(memory)
    return memory, keys, mask, pack_decoder_weights(model.decoder.cell)


def _cluster_decode(inputs, cluster, **kw):
    memory, keys, mask, w = inputs
    kw = dict(dict(seed=0, dropout=False, dropout_rate=0.5, lowp=True,
                   return_keep_counts=False), **kw)
    return _decode_loop_cuda(memory, keys, mask, w, _cluster=cluster, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp,atol_f,atol_a", [(False, 1e-4, 1e-5), (True, 2e-2, 1e-3)])
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_decode_kernel_at_every_cluster_size(request, width, cluster, lowp, atol_f, atol_a):
    """Every cluster size against the plain version: B 3, T_in 9 on the
    tiny widths (slices of uneven size, empty ones at C 16), and the [main]
    path's widths at B 8, T_in 120; one launch per call."""
    inputs = request.getfixturevalue("decoder_inputs" if width == "tiny"
                                     else "full_decoder_inputs")
    n = 6 if width == "tiny" else 50
    before = runtime.LAUNCHES["decode_loop"]
    with torch.no_grad():
        kf, ka = _cluster_decode(inputs, cluster, n_steps=n, lowp=lowp)
        pf, pa = decode_loop_reference(*inputs, n_steps=n, dropout=False, lowp=lowp)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["decode_loop"] == before + 1
    assert bool(torch.isfinite(kf).all())
    assert float((kf - pf).abs().max()) <= atol_f
    assert float((ka - pa).abs().max()) <= atol_a


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_decode_kernel_dropout_does_not_depend_on_the_cluster(request, width):
    """The keep masks are the units' owners' hash of (seed, row, step,
    layer, unit): the keep counts are equal at every cluster size, and the
    frames at C = 1 and at the chosen C agree within the f32 tolerance."""
    inputs = request.getfixturevalue("decoder_inputs" if width == "tiny"
                                     else "full_decoder_inputs")
    memory, keys, _, w = inputs
    chosen, resident = cluster_plan(memory, keys, w, lowp=False)
    assert resident[chosen] >= memory.shape[0]
    if width == "full":
        assert chosen > 1
    with torch.no_grad():
        runs = {c: _cluster_decode(inputs, c, n_steps=40, seed=3, dropout=True, lowp=False,
                                   return_keep_counts=True) for c in CLUSTER_SIZES}
        default = decode_loop(*inputs, n_steps=40, seed=3, dropout_rate=0.5, lowp=False)
    for c in CLUSTER_SIZES:
        assert torch.equal(runs[c][2], runs[1][2])
    assert float((runs[chosen][0] - runs[1][0]).abs().max()) <= 1e-4
    assert torch.equal(default[0], runs[chosen][0])


GL_KW = dict(n_fft=256, hop_length=48, win_length=190)


def _gl_mag(dev):
    y = torch.cumsum(torch.randn(2, 4096, generator=torch.Generator().manual_seed(6)), -1)
    re, im = stft_mm((0.1 * y).to(dev), **GL_KW)
    return torch.sqrt(re * re + im * im + 1e-12)


def _wav_err(got, want):
    got, want = (istft_mm(*(x.float() for x in s), **GL_KW) for s in (got, want))
    return float((got - want).abs().max()) / float(want.abs().max())


def _mag_err(spec, mag):
    re, im = stft_mm(istft_mm(*(x.float() for x in spec), **GL_KW), **GL_KW)
    return float((torch.sqrt(re * re + im * im + 1e-12) - mag).abs().mean() / mag.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_griffin_lim_kernel_matches_plain(dev, momentum):
    mag = _gl_mag(dev)
    before = runtime.LAUNCHES["griffin_lim"]
    got = griffin_lim_spectrum(mag, **GL_KW, n_iter=8, momentum=momentum, lowp=False)
    assert runtime.LAUNCHES["griffin_lim"] == before + 3 * 8
    # the matmul-DFT f32 loop and the kernel's plain f32 version are one loop
    want = gl_spectrum_mm(mag, **GL_KW, n_iter=8, momentum=momentum, lowp=False)
    assert _wav_err(got, want) <= 1e-3
    ref = gl_spectrum_reference(mag, **GL_KW, n_iter=8, momentum=momentum, lowp=False)
    assert all(torch.equal(a, b) for a, b in zip(want, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("momentum,n_iter", [(0.0, 8), (0.99, 8), (0.99, 7)])
def test_griffin_lim_bf16_kernel_matches_plain(dev, momentum, n_iter):
    mag = _gl_mag(dev)
    before = runtime.LAUNCHES["griffin_lim"]
    got = griffin_lim_spectrum(mag, **GL_KW, n_iter=n_iter, momentum=momentum)
    assert runtime.LAUNCHES["griffin_lim"] == before + 3 * n_iter
    want = gl_spectrum_reference(mag, **GL_KW, n_iter=n_iter, momentum=momentum)
    assert want[0].dtype == torch.bfloat16
    assert _wav_err(got, want) <= 2e-2
    assert _mag_err(got, mag) <= _mag_err(want, mag) * 1.05 + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("lowp,tol", [(False, 1e-3), (True, 2e-2)])
def test_streaming_kernel_matches_plain_and_whole_loop(dev, lowp, tol):
    mag = _gl_mag(dev)
    re, im = zero_phase(mag, lowp)
    before = runtime.LAUNCHES["griffin_lim_step"]
    k_re, k_im = griffin_lim_step(re, im, mag, **GL_KW, lowp=lowp)
    n = 4                                           # the pack launch, then three
    assert runtime.LAUNCHES["griffin_lim_step"] == before + n
    p_re, p_im = gl_step_reference(re, im, mag, **GL_KW, lowp=lowp)
    assert k_re.dtype == re.dtype and k_re.shape == mag.shape
    assert _wav_err((k_re, k_im), (p_re, p_im)) <= tol
    got = griffin_lim_spectrum(mag, **GL_KW, n_iter=6, inner=1, lowp=lowp)
    assert runtime.LAUNCHES["griffin_lim_step"] == before + n + n * 6
    assert _wav_err(got, gl_spectrum_reference(mag, **GL_KW, n_iter=6, lowp=lowp)) <= tol
    assert _wav_err(got, griffin_lim_spectrum(mag, **GL_KW, n_iter=6, lowp=lowp)) <= tol
    with pytest.raises(TypeError):
        griffin_lim_step(re.double(), im.double(), mag, **GL_KW, lowp=lowp)


GL_REAL = dict(n_fft=2048, hop_length=275, win_length=1102)


def _gl_mag_real(dev, f, b=3):
    y = torch.cumsum(torch.randn(b, 275 * (f - 1), generator=torch.Generator().manual_seed(f)), -1)
    re, im = stft_mm((0.1 * (y - y.mean(-1, keepdim=True))).to(dev), **GL_REAL)
    return torch.sqrt(re * re + im * im + 1e-12)


def _within_ulp(got, want, mag):
    """Each component within one bf16 ulp (2^-7) of the magnitude's peak."""
    tol = 2.0 ** -7 * float(mag.max())
    return all(float((g.float() - w.float()).abs().max()) <= tol for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [37, 5])
def test_griffin_lim_bf16_steps_at_real_widths(dev, f):
    """The tensor-core products at 2048/275/1102: B 3 x F 37 rows (a ragged
    M), and F 5, the fewest frames the reflect pad allows. One K4 iteration
    from the zero-phase start, with and without momentum, and one K5 call
    from the plain loop's state after two steps, against the plain version."""
    mag = _gl_mag_real(dev, f)
    assert mag.shape == (3, f, 1025)
    for momentum in (0.0, 0.99):
        before = runtime.LAUNCHES["griffin_lim"]
        got = griffin_lim_spectrum(mag, **GL_REAL, n_iter=1, momentum=momentum)
        assert runtime.LAUNCHES["griffin_lim"] == before + 3
        want = gl_spectrum_reference(mag, **GL_REAL, n_iter=1, momentum=momentum)
        assert _within_ulp(got, want, mag)
    re, im = zero_phase(mag, True)
    for _ in range(2):
        re, im = gl_step_reference(re, im, mag, **GL_REAL)
    before = runtime.LAUNCHES["griffin_lim_step"]
    got = griffin_lim_step(re, im, mag, **GL_REAL)
    assert runtime.LAUNCHES["griffin_lim_step"] == before + 4
    assert got[0].dtype == torch.bfloat16 and got[0].shape == mag.shape
    assert _within_ulp(got, gl_step_reference(re, im, mag, **GL_REAL), mag)


@pytest.mark.cuda
def test_griffin_lim_bf16_steps_at_the_spectrogram_floor(dev):
    """The magnitudes a model with random weights gives (B 8 x F 64, the
    trimmed shape of synth_fast's early exit): every bin near the floor,
    1e-6 to 7e-6, nearly flat. There the synthesis frames cancel most of
    their terms, and one K5 step from the plain loop's state at depths 0-9
    stays within one bf16 ulp of the peak only if the synthesis sums are no
    less exact than the plain f32 loop's."""
    mag = _floor_magnitude(dev)
    re, im = zero_phase(mag, True)
    for _ in range(10):
        want = gl_step_reference(re, im, mag, **GL_REAL)
        assert _within_ulp(griffin_lim_step(re, im, mag, **GL_REAL), want, mag)
        re, im = want


def _floor_magnitude(dev):
    """A synthetic spectrogram at its floor (B 8 x F 64, synth_fast's trimmed
    shape): every bin 1e-6 to 7e-6, nearly flat."""
    s = 0.11 * torch.rand(8, 64, 1025, generator=torch.Generator().manual_seed(3))
    return spectrogram_magnitude(s.to(dev), get_config("synth_fast").audio)


def _model_magnitude(dev):
    """synth_fast's spectrogram from a model with seeded random weights:
    B 8 x F 1000 (500 decoder steps) at the floor."""
    cfg = get_config("synth_fast")
    model = init_params(Tacotron(cfg.model, device=dev), seed=0).eval()
    g = torch.Generator().manual_seed(1)
    lengths = torch.tensor([115, 99, 104, 110, 112, 113, 102, 108])
    text = torch.randint(1, cfg.model.vocab_size, (8, 115), generator=g)
    text = torch.where(length_mask(115, lengths), text, 0)
    with torch.no_grad():
        out = model(text.to(dev), lengths.to(dev), n_steps=cfg.model.max_decode_steps,
                    generator=torch.Generator(device=dev).manual_seed(1))
    return spectrogram_magnitude(out.linear.float(), cfg.audio)


def _speech_magnitude(dev, b, f, seed):
    """A speech-like spectrogram (a random walk's), as chip_smoke.py's
    sample_magnitude makes it."""
    g = torch.Generator().manual_seed(seed)
    y = torch.cumsum(torch.randn(b, 275 * (f - 1), generator=g), -1) * 0.1
    re, im = stft_mm((y - y.mean(-1, keepdim=True)).to(dev), **GL_REAL)
    return torch.sqrt(re * re + im * im + 1e-12)


F32_MAGNITUDES = {"floor_b8_f64": _floor_magnitude, "model_b8_f1000": _model_magnitude,
                  "speech_b8_f1000": lambda dev: _speech_magnitude(dev, 8, 1000, seed=6),
                  "speech_b3_f37": lambda dev: _gl_mag_real(dev, 37),
                  "speech_b3_f5": lambda dev: _gl_mag_real(dev, 5)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(F32_MAGNITUDES))
def test_griffin_lim_f32_steps_as_exact_as_plain(dev, name):
    """The f32 mode's split TF32 products on the magnitudes of
    scripts/gl_accumulation.py (a model's floor, a synthetic floor, a
    speech-like one) and at a ragged M (B 3 x F 37) and the fewest frames
    (F 5): one K4 iteration from the zero-phase start and one K5 call from
    the plain f32 loop's state at depths 0-9, each one's largest component
    error against the same step summed in f64 (over the magnitude's peak)
    within 2x the plain f32 step's largest."""
    mag = F32_MAGNITUDES[name](dev)
    peak = float(mag.max())
    err = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b)) / peak
    re, im = zero_phase(mag, False)
    before = runtime.LAUNCHES["griffin_lim"]
    k4 = griffin_lim_spectrum(mag, **GL_REAL, n_iter=1, lowp=False)
    assert runtime.LAUNCHES["griffin_lim"] == before + 3
    worst = {"k4": err(k4, gl_step_reference(re, im, mag, **GL_REAL, lowp=False,
                                             product=f64_matmul)),
             "k5": 0.0, "plain": 0.0}
    for _ in range(10):
        exact = gl_step_reference(re, im, mag, **GL_REAL, lowp=False, product=f64_matmul)
        plain = gl_step_reference(re, im, mag, **GL_REAL, lowp=False)
        got = griffin_lim_step(re, im, mag, **GL_REAL, lowp=False)
        assert got[0].dtype == torch.float32 and got[0].shape == mag.shape
        worst["k5"] = max(worst["k5"], err(got, exact))
        worst["plain"] = max(worst["plain"], err(plain, exact))
        re, im = plain
    assert worst["k4"] <= 2 * worst["plain"] and worst["k5"] <= 2 * worst["plain"], worst


@pytest.mark.cuda
def test_streaming_f32_equals_whole_loop_at_beta0(dev):
    """The f32 K5 packs its planar input and runs K4's three f32 launches:
    at beta 0 the two are bit-equal."""
    mag = _gl_mag_real(dev, 37)
    for n_iter in (1, 3):
        k5 = griffin_lim_spectrum(mag, **GL_REAL, n_iter=n_iter, inner=1, lowp=False)
        k4 = griffin_lim_spectrum(mag, **GL_REAL, n_iter=n_iter, lowp=False)
        assert all(torch.equal(a, b) for a, b in zip(k5, k4))


@pytest.mark.cuda
def test_streaming_bf16_equals_whole_loop_at_beta0(dev):
    """K5 packs its planar input and then runs K4's three launches: at beta
    0 the two are bit-equal."""
    mag = _gl_mag_real(dev, 37)
    for n_iter in (1, 3):
        k5 = griffin_lim_spectrum(mag, **GL_REAL, n_iter=n_iter, inner=1)
        k4 = griffin_lim_spectrum(mag, **GL_REAL, n_iter=n_iter)
        assert all(torch.equal(a, b) for a, b in zip(k5, k4))


@pytest.mark.cuda
@pytest.mark.parametrize("kib", [48, 100, 227])
def test_probe_smem_fits(dev, kib):
    x = torch.randn(probe.SMEM_SHAPE, generator=torch.Generator().manual_seed(kib)).to(dev)
    before = runtime.LAUNCHES["probe_smem"]
    out, limit = probe.probe_smem(x, kib)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["probe_smem"] == before + 1
    assert torch.equal(out, probe.probe_smem_reference(x))
    assert limit >= kib * 1024


@pytest.mark.cuda
def test_probe_smem_refusal_is_raised(dev):
    x = torch.ones(probe.SMEM_SHAPE, device=dev)
    _, limit = probe.probe_smem(x, 48)
    before = runtime.LAUNCHES["probe_smem"]
    with pytest.raises(probe.ProbeError, match="CUDA error"):
        probe.probe_smem(x, limit // 1024 + 1)
    assert runtime.LAUNCHES["probe_smem"] == before
    out, _ = probe.probe_smem(x, 48)                 # the device is still usable
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTER_SIZES)
def test_probe_cluster_barrier_runs(dev, cluster):
    before = runtime.LAUNCHES["probe_cluster_barrier"]
    probe.probe_cluster_barrier(2, cluster, 1000, device=dev)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["probe_cluster_barrier"] == before + 1
    with pytest.raises(probe.ProbeError, match="CUDA error"):
        probe.probe_cluster_barrier(1, 32, 10, device=dev)
    assert runtime.LAUNCHES["probe_cluster_barrier"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [None, 0, 1])
def test_probe_ops_matches_plain(dev, seed):
    inputs = probe.ops_inputs(dev, seed)
    before = runtime.LAUNCHES["probe_ops"]
    got = probe.probe_ops(*inputs)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["probe_ops"] == before + 1
    want = probe.probe_ops_reference(*inputs)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    with pytest.raises(ValueError, match="probe_ops: d"):
        probe.probe_ops(inputs[0], inputs[1][:, :-1], inputs[2])


@pytest.mark.cuda
def test_probe_ops_is_the_same_bits_every_call(dev):
    """No float atomics: three calls give the same bits, and every output
    element got the same addend s (rows 0..2 hold only s)."""
    inputs = probe.ops_inputs(dev, 0)
    outs = [probe.probe_ops(*inputs) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0][:3], outs[0][0, 0].expand(3, probe.OPS_H))


def _kernel_nodes(fn):
    """(kernel nodes, ``runtime.LAUNCHES`` added) of one call of ``fn``
    captured into a CUDA graph: the capture records every launch the call
    makes, so none can be missed (the profiler can miss a ~1 us kernel). A
    warm call on the capture stream first fills the wrappers' caches (and
    K2's counter for that stream), so the capture holds the call alone."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    before = collections.Counter(runtime.LAUNCHES)
    with torch.cuda.graph(g, stream=s):
        fn()
    added = collections.Counter(runtime.LAUNCHES)
    added.subtract(before)
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    g.reset()
    return kinds.count(0), {k: v for k, v in added.items() if v}   # 0: CU_GRAPH_NODE_TYPE_KERNEL


@pytest.mark.cuda
def test_probe_ops_is_one_launch(dev):
    """Exactly one kernel per probe_ops call, counted in a CUDA graph
    captured around it."""
    inputs = probe.ops_inputs(dev, 0)
    kernels, launches = _kernel_nodes(lambda: probe.probe_ops(*inputs))
    assert kernels == 1 and launches == {"probe_ops": 1}, (kernels, launches)


@pytest.mark.cuda
def test_probe_empty_on_the_ops_cluster(dev):
    plan = probe.ops_plan()
    before = runtime.LAUNCHES["probe_empty"]
    probe.probe_empty(plan.cluster, plan.threads, plan.cluster, device=dev,
                      smem_bytes=plan.smem_bytes)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["probe_empty"] == before + 1


def _energy_inputs(dev, b, t, a, seed=0):
    g = torch.Generator().manual_seed(seed)
    keys, q = torch.randn(b, t, a, generator=g), torch.randn(b, a, generator=g)
    v, de = torch.randn(a, 1, generator=g) * 0.3, torch.randn(b, t, generator=g)
    return [x.to(dev) for x in (keys, q, v, de)]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, *BWD_CLUSTERS])
def test_probe_empty_runs(dev, cluster):
    blocks, threads = fwd_grid(32, 128, torch.bfloat16)
    before = runtime.LAUNCHES["probe_empty"]
    probe.probe_empty(blocks, threads, cluster, device=dev)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["probe_empty"] == before + 1
    with pytest.raises(probe.ProbeError, match="CUDA error"):
        probe.probe_empty(blocks + 1, threads, 8, device=dev)     # not a multiple of 8
    assert runtime.LAUNCHES["probe_empty"] == before + 1


# the shapes of the kernels' checks: the training path's, JAX's odd one, the
# scalar path's, one row, one batch row, and more clusters than fit at once
ENERGY_SHAPES = [(32, 128, 256), (32, 1, 256), (1, 128, 256), (256, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,a", [(4, 37, 256), (3, 11, 30), *ENERGY_SHAPES])
def test_attn_energy_kernels_match_plain(dev, b, t, a):
    keys, q, v, de = _energy_inputs(dev, b, t, a)
    leaves = [x.clone().requires_grad_(True) for x in (keys, q, v)]
    before = dict(runtime.LAUNCHES)
    e = attention_energy(*leaves)
    grads = torch.autograd.grad(e, leaves, de)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["attn_energy_fwd"] == before.get("attn_energy_fwd", 0) + 1
    assert runtime.LAUNCHES["attn_energy_bwd"] == before.get("attn_energy_bwd", 0) + 1
    ref_leaves = [x.clone().requires_grad_(True) for x in (keys, q, v)]
    e_ref = attention_energy_reference(*ref_leaves)
    ref = torch.autograd.grad(e_ref, ref_leaves, de)
    for got, want in zip((e.detach(), *grads), (e_ref.detach(), *ref)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    again = torch.autograd.grad(attention_energy(*leaves), leaves, de)
    assert torch.equal(again[2], grads[2])          # dv: fixed-order sums


def _hold_bwd(got, want, ulp):
    """K2's (dkeys, dq, dv) against its plain version's: dv (f32) within
    1e-5 of its peak; dkeys and dq within 1e-5 of the peak, plus one bf16
    ulp of each entry where ``ulp``."""
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.float()
        tol = 1e-5 * float(w.abs().max()) + (2.0 ** -7 * w.abs() if ulp and i < 2 else 0.0)
        assert bool(((g.float() - w).abs() <= tol).all()), ("dkeys", "dq", "dv")[i]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,a", [(6, 37, 256), (3, 11, 100), *ENERGY_SHAPES])
def test_attn_energy_bf16_kernels_match_plain(dev, b, t, a):
    """The bf16 mode at JAX's odd shape, a width that takes the scalar path
    (A % 8 != 0), and ENERGY_SHAPES."""
    keys, q, v, de = _energy_inputs(dev, b, t, a)
    keys, q = keys.bfloat16(), q.bfloat16()
    before = dict(runtime.LAUNCHES)
    e = energy_fwd(keys, q, v)
    dkeys, dq, dv = energy_bwd(keys, q, v, de)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["attn_energy_fwd"] == before.get("attn_energy_fwd", 0) + 1
    assert runtime.LAUNCHES["attn_energy_bwd"] == before.get("attn_energy_bwd", 0) + 1
    assert (e.dtype, dkeys.dtype, dq.dtype, dv.dtype) == (torch.float32, torch.bfloat16,
                                                          torch.bfloat16, torch.float32)
    e_ref = attention_energy_reference(keys, q, v)
    assert float((e - e_ref).abs().max()) <= 1e-5 * float(e_ref.abs().max())
    _hold_bwd((dkeys, dq, dv), energy_bwd_reference(keys, q, v, de), ulp=True)

    leaves = [x.clone().requires_grad_(True) for x in (keys, q, v)]
    grads = torch.autograd.grad(attention_energy(*leaves), leaves, de)
    ref_leaves = [x.clone().requires_grad_(True) for x in (keys, q, v)]
    ref = torch.autograd.grad(attention_energy_reference(*ref_leaves), ref_leaves, de)
    for got, want in zip(grads, ref):
        assert got.dtype == want.dtype
        assert float((got.float() - want.float()).abs().max()) <= 4e-2 * float(want.abs().max())


@pytest.mark.cuda
def test_attn_energy_refuses_what_it_does_not_take(dev):
    keys, q, v, _ = _energy_inputs(dev, 2, 5, 8)
    with pytest.raises(TypeError, match="f32"):
        attention_energy(keys.double(), q.double(), v.double())
    with pytest.raises(TypeError, match="both f32 or both bf16"):
        attention_energy(keys.bfloat16(), q, v)
    with pytest.raises(ValueError, match="shape"):
        attention_energy(keys, q[:, :4], v)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["scan", "hoisted"])
def test_training_loss_and_grads_through_the_kernels(dev, form):
    """Teacher-forced loss and every parameter gradient with
    ``attention_energy="fused"`` (K1/K2) vs ``"xla"`` (plain), remat on."""
    base = dataclasses.replace(get_config("tiny_cpu").model, vocab_size=32,
                               prenet_dropout=0.0, tf_decoder=form, remat_decoder=True)
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 30, (3, 9), generator=g).to(dev)
    lengths = torch.tensor([9, 6, 4], device=dev)
    mel = torch.rand(3, 20, 80, generator=g).to(dev)
    linear = torch.rand(3, 20, base.n_freq, generator=g).to(dev)
    out = {}
    for energy in ("xla", "fused"):
        cfg = dataclasses.replace(base, attention_energy=energy)
        model = init_params(Tacotron(cfg, device=dev), seed=0).train()
        before = runtime.LAUNCHES["attn_energy_bwd"]
        o = model(text, lengths, gt_mel=mel)
        loss, _ = tacotron_loss(o.mel, o.linear, mel, linear)
        loss.backward()
        torch.cuda.synchronize()
        n_bwd = runtime.LAUNCHES["attn_energy_bwd"] - before
        assert n_bwd == (4 if energy == "fused" else 0)
        out[energy] = (loss.item(), {k: p.grad for k, p in model.named_parameters()})
    assert out["fused"][0] == pytest.approx(out["xla"][0], rel=1e-5)
    for k, want in out["xla"][1].items():
        err = float((out["fused"][1][k] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-7, k


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("cluster", [1, *BWD_CLUSTERS])
@pytest.mark.parametrize("b,t,a", [(6, 37, 256), (3, 11, 100), (2, 9, 600)])
def test_attn_energy_bwd_at_every_cluster_size(dev, b, t, a, cluster, bf16):
    """K2 pinned to each cluster size (ceil(T / C) rows a block; at T 11
    and C 8 two blocks take no row), against its plain version."""
    keys, q, v, de = _energy_inputs(dev, b, t, a, seed=cluster)
    if bf16:
        keys, q = keys.bfloat16(), q.bfloat16()
    got = energy_bwd(keys, q, v, de, _cluster=cluster)
    torch.cuda.synchronize()
    _hold_bwd(got, energy_bwd_reference(keys, q, v, de), ulp=bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_energy_dv_is_the_same_bits_every_call(dev, bf16):
    keys, q, v, de = _energy_inputs(dev, 32, 128, 256, seed=4)
    if bf16:
        keys, q = keys.bfloat16(), q.bfloat16()
    calls = [energy_bwd(keys, q, v, de) for _ in range(3)]
    torch.cuda.synchronize()
    for got in calls[1:]:
        assert all(torch.equal(g, w) for g, w in zip(got, calls[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_energy_bwd_counter_resets(dev, bf16):
    """B 32 and B 5 back to back, no synchronisation between: each call's
    last cluster (ticket B - 1) sums dv and leaves the counter at 0 for the
    next, whatever its B."""
    inputs = {b: _energy_inputs(dev, b, 37, 256, seed=b) for b in (32, 5)}
    if bf16:
        inputs = {b: [x.bfloat16() if i < 2 else x for i, x in enumerate(xs)]
                  for b, xs in inputs.items()}
    order = (32, 5, 32, 5, 5, 32)
    got = [energy_bwd(*inputs[b]) for b in order]
    torch.cuda.synchronize()
    assert int(_ticket(dev).item()) == 0
    for b, g in zip(order, got):
        _hold_bwd(g, energy_bwd_reference(*inputs[b]), ulp=bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_energy_bwd_is_one_launch(dev, bf16):
    """Exactly one kernel per K2 call, counted in a CUDA graph captured
    around it."""
    keys, q, v, de = _energy_inputs(dev, 32, 128, 256)
    if bf16:
        keys, q = keys.bfloat16(), q.bfloat16()
    kernels, launches = _kernel_nodes(lambda: energy_bwd(keys, q, v, de))
    assert kernels == 1 and launches == {"attn_energy_bwd": 1}, (kernels, launches)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_attn_energy_bwd_on_two_streams(dev, bf16):
    """K2 in flight on two streams at once, with different inputs: each
    stream's calls take its own counter, so each call's dv is summed by its
    own last cluster. Both streams' results against the plain version, and
    both counters back at 0."""
    inputs = [_energy_inputs(dev, b, 128, 256, seed=10 + b) for b in (32, 24)]
    if bf16:
        inputs = [[x.bfloat16() if i < 2 else x for i, x in enumerate(xs)] for xs in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):                 # interleaved launches, no waits between
        for i, (s, xs) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                got[i].append(energy_bwd(*xs))
    torch.cuda.synchronize()
    for s in streams:
        assert int(_ticket(dev, s).item()) == 0
    for xs, calls in zip(inputs, got):
        want = energy_bwd_reference(*xs)
        for g in calls:
            _hold_bwd(g, want, ulp=bf16)


@pytest.fixture(scope="module")
def card_data(dev, tmp_path_factory):
    """A synthetic corpus preprocessed on the card at a small STFT."""
    from tacotron_tpu_torch.config import AudioConfig
    from tacotron_tpu_torch.data import ljspeech
    root = tmp_path_factory.mktemp("card_data")
    ljspeech.generate_synthetic_corpus(str(root / "corpus"), n=10, min_sec=0.3, max_sec=0.9)
    acfg = AudioConfig(n_fft=512, win_length=400, hop_length=128)
    ljspeech.preprocess(str(root / "corpus"), str(root / "data"), acfg, chunk=4)
    return root


@pytest.mark.cuda
def test_device_cache_on_the_card_equals_numpy_assembler(card_data):
    from tacotron_tpu_torch.data.loader import DataLoader, Dataset
    kw = dict(batch_size=3, num_buckets=3, r=5, seed=3)
    ds = Dataset(str(card_data / "data"))
    host = DataLoader(ds, use_native=False, **kw)
    cache = DataLoader(ds, device_cache=True, **kw)
    assert cache.assembler == "device_cache"
    for _ in range(2):
        for h, c in zip(host.epoch(), cache.epoch()):
            assert h.bucket == c.bucket and h.items == c.items
            for a, t in zip(h.arrays(), c.arrays()):
                assert t.is_cuda and str(t.dtype).endswith(str(a.dtype))
                assert torch.equal(t.cpu(), torch.from_numpy(a))


@pytest.mark.cuda
def test_pinned_prefetch_delivers_the_host_bytes(card_data, dev):
    from tacotron_tpu_torch.data.loader import DataLoader, Dataset, device_prefetch, put_batch
    dl = DataLoader(Dataset(str(card_data / "data")), batch_size=3, num_buckets=2, r=5)
    assert dl.assembler == "native"
    batches = list(dl.epoch())
    n = 0
    for b, (arrays, pinned) in device_prefetch(iter(batches), lambda b: put_batch(b, dev)):
        assert len(pinned) == 5 and all(p.is_pinned() for p in pinned)
        for a, t in zip(b.arrays(), arrays):
            assert t.is_cuda
            assert torch.equal(t.cpu(), torch.from_numpy(a))
        n += 1
    assert n == len(batches) > 0


@pytest.mark.cuda
def test_train_cli_two_steps_launch_k1_k2(card_data, tmp_path):
    import ast
    import contextlib
    import io
    import json
    from tacotron_tpu_torch.cli import train as train_cli
    buf = io.StringIO()
    runtime.LAUNCHES.clear()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--data-dir", str(card_data / "data"), "--run-dir", str(tmp_path / "run"),
                        "--preset", "tiny_cpu", "--batch-size", "4", "--num-buckets", "1",
                        "--steps", "2", "--summary-every", "1",
                        "--set", "model.attention_energy=fused"])
    lines = buf.getvalue().strip().splitlines()
    bucket = ast.literal_eval(lines[0].removeprefix("buckets: "))[0]
    n_dec = bucket[1] // get_config("tiny_cpu").model.r
    assert runtime.LAUNCHES["attn_energy_fwd"] == runtime.LAUNCHES["attn_energy_bwd"] == 2 * n_dec
    assert json.loads(lines[-1]) == {"done": True, "step": 2}
    losses = [json.loads(ln)["total_loss"] for ln in lines if ln.startswith('{"step"')]
    assert len(losses) == 2 and all(v == v for v in losses)
