"""The port's roofline accounting (``tacotron_tpu_torch.utils.roofline``)
against the JAX package's, and its whole-step count against torch's own.

* Every FLOP model returns exactly (``==``) the JAX function's float over a
  grid of arguments, the presets' model configs among them.
* ``KernelRoofline.report()`` keeps JAX's keys and classification
  (``tests/unit/test_utils.py::TestRoofline``), on the H100 dicts; the
  default chip is ``H100_BF16``.
* ``train_step_flops`` at full_1chip widths (vocab 64, B 2, T_in 16, T_out
  20) against ``torch.utils.flop_counter.FlopCounterMode`` over the port's
  teacher-forced forward: equal, term for term. Eager torch runs every
  decoder step, so JAX's correction for a scan counted once does not
  apply. Over forward and backward with the decoder under remat, the
  counter sees less than the model's 3x (4x for the decoder), by exactly
  the products whose backward or recomputation torch skips, each counted
  below (0.16% of the step in the scan form, 0.56% in the hoisted form;
  at most 5% is allowed):
  - the biGRUs' ``h @ W_h`` gate product at the zero initial state needs
    no dL/dh (2 CBHGs x 2 directions x 2 B h 2h);
  - the decoder prenet's first layer reads ground-truth frames, which need
    no gradient (2 B S n_mels prenet[0]);
  - the r-frame projection runs once after the loop, outside the
    recomputed steps (2 B S dec r n_mels);
  - hoisted form only: the prenet and the prenet rows of the attention
    GRU's gates and candidate run once before the loop, outside the
    recomputed steps; and at step 0 the [context, h] rows of the
    attention GRU's gates read two zero states (2 B (mem + att) 2 att).
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.utils import roofline as jr
from tacotron_tpu_torch.config import PRESETS, get_config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.utils import roofline as pr
from tacotron_tpu_torch.utils.roofline import (H100, H100_BF16, H100_F32, H100_TF32,
                                               KernelRoofline)
from tacotron_tpu_torch.weights import init_params


def _models(name):
    return get_config(name).model, jax_get_config(name).model


def _decode_kw(m):
    return dict(n_mels=m.n_mels, r=m.r, prenet=tuple(m.prenet_dims), att_gru=m.attention_gru_dim,
                att_dim=m.attention_dim, mem_dim=m.memory_dim, dec_dim=m.decoder_gru_dim)


def _cbhg_args(m, which, t):
    if which == "encoder":
        return (2, t, m.prenet_dims[1], m.encoder_bank_k, m.encoder_bank_channels,
                tuple(m.encoder_proj_dims), m.highway_layers, m.highway_dim, m.gru_dim)
    return (2, t, m.n_mels, m.postnet_bank_k, m.postnet_bank_channels,
            tuple(m.postnet_proj_dims), m.highway_layers, m.highway_dim, m.gru_dim)


GL_CASES = [(1, 100, 2048, None), (8, 1000, 2048, 1102), (2, 37, 512, 400), (3, 10, 1024, 800)]
BANK_CASES = [(2, 16, 128, 16, 128, packed, g) for packed in (True, False) for g in (1, 2, 3, 4)] \
    + [(1, 10, 80, 8, 128, True, 3), (4, 7, 6, 5, 8, True, 2)]
GRU_CASES = [(2, 16, 128, 128, False), (2, 16, 128, 128, True), (3, 9, 80, 32, True)]
SHAPES = [(32, 128, 400), (2, 16, 20), (8, 120, 1000)]


@pytest.mark.parametrize("args", GL_CASES)
def test_gl_iteration_flops_equals_jax(args):
    assert pr.gl_iteration_flops(*args) == jr.gl_iteration_flops(*args)


@pytest.mark.parametrize("args", BANK_CASES)
def test_conv_bank_flops_equals_jax(args):
    *pos, packed, groups = args
    assert pr.conv_bank_flops(*pos, packed=packed, groups=groups) == \
        jr.conv_bank_flops(*pos, packed=packed, groups=groups)


@pytest.mark.parametrize("args", GRU_CASES)
def test_gru_seq_flops_equals_jax(args):
    *pos, bidi = args
    assert pr.gru_seq_flops(*pos, bidirectional=bidi) == jr.gru_seq_flops(*pos, bidirectional=bidi)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_decode_and_cbhg_flops_equal_jax(preset):
    m, jm = _models(preset)
    for b, t_in in ((1, 10), (32, 128)):
        assert pr.decode_step_flops(b, t_in, **_decode_kw(m)) == \
            jr.decode_step_flops(b, t_in, **_decode_kw(jm))
    for which in ("encoder", "postnet"):
        for groups in (1, 2):
            assert pr.cbhg_flops(*_cbhg_args(m, which, 37), groups=groups) == \
                jr.cbhg_flops(*_cbhg_args(jm, which, 37), groups=groups)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_train_step_flops_equals_jax(preset):
    m, jm = _models(preset)
    assert m.bank_groups == jm.bank_groups == 1      # the port packs one group
    for remat in (False, True):
        pm, jmm = (dataclasses.replace(x, remat_decoder=remat) for x in (m, jm))
        for shape in SHAPES:
            for fwd_only in (False, True):
                assert pr.train_step_flops(pm, *shape, fwd_only=fwd_only) == \
                    jr.train_step_flops(jmm, *shape, fwd_only=fwd_only)


def test_train_step_flops_at_the_train_shapes():
    """The count that chip_smoke.py's [train] reports: 380.9 GFLOP a step."""
    m = dataclasses.replace(get_config("full_1chip").model, remat_decoder=True)
    assert round(pr.train_step_flops(m, 32, 128, 400) / 1e9, 1) == 380.9
    assert round(pr.train_step_flops(dataclasses.replace(m, remat_decoder=False),
                                     32, 128, 400) / 1e9, 1) == 360.0


def test_h100_peaks():
    assert (H100_BF16["flops_peak"], H100_TF32["flops_peak"], H100_F32["flops_peak"]) == \
        (989e12, 495e12, 67e12)
    assert {c["hbm_gbps"] for c in H100.values()} == {3.35e12}
    assert set(H100_BF16) == set(jr.V5E)
    assert not hasattr(pr, "V5E")


class TestKernelRoofline:
    def test_memory_bound_classification(self):
        r = KernelRoofline("k", flops=1e6, bytes_accessed=1e9, seconds=1e-2).report()
        assert r["bound"] == "memory" and r["chip"] == H100_BF16["name"]

    def test_compute_bound_classification(self):
        r = KernelRoofline("k", flops=1e12, bytes_accessed=1e6, seconds=1e-2).report()
        assert r["bound"] == "compute"

    @pytest.mark.parametrize("chip", [H100_BF16, H100_TF32, H100_F32])
    def test_sol_time_is_max_of_both_limits(self, chip):
        r = KernelRoofline("k", flops=chip["flops_peak"], bytes_accessed=chip["hbm_gbps"],
                           seconds=3.0, chip=chip).report()
        # 1 s of compute, 1 s of bandwidth -> SoL 1 s; measured 3 s -> fraction 1/3
        assert r["speed_of_light_ms"] == pytest.approx(1000.0)
        assert r["sol_fraction"] == pytest.approx(1 / 3, rel=1e-3)
        assert r["chip"] == chip["name"]

    def test_report_keys_and_values_equal_jax_on_the_same_chip(self):
        for flops, byts, secs in ((1e6, 1e9, 1e-2), (1e12, 1e6, 1e-2), (3.3e9, 2.1e6, 2.5e-6)):
            for chip in H100.values():
                assert KernelRoofline("k", flops, byts, secs, chip).report() == \
                    jr.KernelRoofline("k", flops, byts, secs, chip).report()

    def test_speed_of_light_names_its_bound(self):
        s, by = pr.speed_of_light(67e12, 1.0, H100_F32)
        assert s == 1.0 and by == "operations"
        s, by = pr.speed_of_light(1.0, 3.35e12, H100_F32)
        assert s == 1.0 and by == "bytes"


def _counted(m):
    """FlopCounterMode's totals over the port's teacher-forced forward and
    over its backward, at B 2, T_in 16, T_out 20."""
    g = torch.Generator().manual_seed(0)
    text = torch.randint(1, 60, (2, 16), generator=g)
    mel = torch.rand(2, 20, m.n_mels, generator=g)
    model = init_params(Tacotron(m, device="cpu")).train()
    with FlopCounterMode(display=False) as fwd:
        out = model(text, torch.full((2,), 16), gt_mel=mel,
                    generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as bwd:
        (out.mel.sum() + out.linear.sum()).backward()
    return fwd.get_total_flops(), bwd.get_total_flops()


@pytest.mark.parametrize("form", ["scan", "hoisted"])
def test_train_step_flops_against_torch_flop_counter(form):
    m = dataclasses.replace(get_config("full_1chip").model, vocab_size=64, tf_decoder=form,
                            remat_decoder=True)
    b, t_in, t_out = 2, 16, 20
    s = t_out // m.r
    fwd, bwd = _counted(m)
    assert fwd == pr.train_step_flops(m, b, t_in, t_out, fwd_only=True)

    full = pr.train_step_flops(m, b, t_in, t_out)
    att, mem, h = m.attention_gru_dim, m.memory_dim, m.gru_dim
    skipped = (2 * 2 * (2 * b * h * 2 * h)                       # biGRU dL/dh0
               + 2 * b * s * m.n_mels * m.prenet_dims[0]          # prenet fc0 dL/dx
               + 2 * b * s * m.decoder_gru_dim * m.r * m.n_mels)  # frame projection
    if form == "hoisted":
        p0, p1 = m.prenet_dims
        skipped += (2 * b * s * (m.n_mels * p0 + p0 * p1)         # prenet
                    + 2 * b * s * p1 * 3 * att                    # its attention-GRU rows
                    + 2 * b * (mem + att) * 2 * att)              # step 0's zero states
    assert fwd + bwd == full - skipped
    assert skipped / full <= (0.002 if form == "scan" else 0.006) <= 0.05
