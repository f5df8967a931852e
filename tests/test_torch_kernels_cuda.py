"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: without a GPU every test skips (the kernels have
no CPU mode). This file imports no JAX, so it also runs where only PyTorch
is installed: ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.

Tolerances (max abs error): decode frames and alignments in f32 storage
1e-4 (summation order only); in bf16 storage 2e-2 on frames and 1e-3 on
alignments (a last-bit difference in an f32 sum can flip a bf16 rounding);
Griffin-Lim waveform 1e-3 of its peak; attention energy (K1) and its
three gradients (K2) 1e-5 of each one's peak (f32, summation order only);
the teacher-forced training loss through the kernels vs the plain formula
rtol 1e-5, every parameter gradient within 1e-4 of its peak plus 1e-7.
"""

import dataclasses

import pytest
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.dsp.dft import gl_spectrum_mm, istft_mm, stft_mm
from tacotron_tpu_torch.dsp.fused_gl import griffin_lim_spectrum
from tacotron_tpu_torch.models.tacotron import Tacotron, length_mask
from tacotron_tpu_torch.ops.attn_energy import attention_energy, attention_energy_reference
from tacotron_tpu_torch.ops.decode_loop import (decode_loop, decode_loop_reference,
                                                pack_decoder_weights)
from tacotron_tpu_torch.train.loss import tacotron_loss
from tacotron_tpu_torch.weights import init_params


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_griffin_lim_kernel_matches_plain(dev, momentum):
    kw = dict(n_fft=256, hop_length=48, win_length=190)
    y = torch.cumsum(torch.randn(2, 4096, generator=torch.Generator().manual_seed(6)), -1)
    re, im = stft_mm((0.1 * y).to(dev), **kw)
    mag = torch.sqrt(re * re + im * im + 1e-12)
    before = runtime.LAUNCHES["griffin_lim"]
    got = istft_mm(*griffin_lim_spectrum(mag, **kw, n_iter=8, momentum=momentum), **kw)
    want = istft_mm(*gl_spectrum_mm(mag, **kw, n_iter=8, momentum=momentum), **kw)
    assert runtime.LAUNCHES["griffin_lim"] == before + 3 * 8
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) / peak <= 1e-3


def _energy_inputs(dev, b, t, a, seed=0):
    g = torch.Generator().manual_seed(seed)
    keys, q = torch.randn(b, t, a, generator=g), torch.randn(b, a, generator=g)
    v, de = torch.randn(a, 1, generator=g) * 0.3, torch.randn(b, t, generator=g)
    return [x.to(dev) for x in (keys, q, v, de)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,a", [(4, 37, 256), (32, 128, 256), (3, 11, 30)])
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


@pytest.mark.cuda
def test_attn_energy_refuses_what_it_does_not_take(dev):
    keys, q, v, _ = _energy_inputs(dev, 2, 5, 8)
    with pytest.raises(TypeError, match="f32"):
        attention_energy(keys.double(), q.double(), v.double())
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
