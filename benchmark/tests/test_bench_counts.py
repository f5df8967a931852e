"""The frozen counts equal the port's own at the cells' shapes; the one
departure is stated: the frozen training count is three times the forward,
where the port's counts the recomputed decoder once more."""

from __future__ import annotations

import dataclasses

import pytest

from benchmark import harness
from benchmark.counts import flops
from benchmark.tests.test_bench_files import BENCH


def _cfg(cell):
    return harness.port_config(harness.load_cell(cell, BENCH))


@pytest.mark.parametrize("t_in", [64, 112, 160])
def test_synthesis_counts(t_in):
    from tacotron_tpu_torch.utils import roofline
    cfg = _cfg("serve_fast.f32.b8")
    a = cfg.audio
    assert flops.gl_iteration_flops(8, 1000, a.n_fft, a.win_length) == \
        roofline.gl_iteration_flops(8, 1000, a.n_fft, a.win_length)
    assert flops.gl_iteration_flops(8, 1000, a.n_fft) == roofline.gl_iteration_flops(8, 1000, a.n_fft)
    assert flops.decode_step_flops(8, t_in) == roofline.decode_step_flops(8, t_in)
    m = cfg.model
    args = (8, t_in, m.prenet_dims[-1], m.encoder_bank_k, m.encoder_bank_channels,
            tuple(m.encoder_proj_dims), m.highway_layers, m.highway_dim, m.gru_dim)
    assert flops.cbhg_flops(*args) == roofline.cbhg_flops(*args)
    assert flops.live_span(a.n_fft, a.win_length) == roofline.live_span(a.n_fft, a.win_length)


@pytest.mark.parametrize("remat", [False, True])
def test_train_count(remat):
    from tacotron_tpu_torch.utils import roofline
    cfg = _cfg("train.bf16.b32")
    m = dataclasses.replace(cfg.model, remat_decoder=remat)
    plain = dataclasses.asdict(m)
    ours = flops.train_step_flops(plain, 32, 128, 400)
    theirs = roofline.train_step_flops(m, 32, 128, 400)
    fwd = roofline.train_step_flops(m, 32, 128, 400, fwd_only=True)
    assert flops.train_step_flops(plain, 32, 128, 400, fwd_only=True) == pytest.approx(fwd)
    assert ours == pytest.approx(3 * fwd)
    if remat:
        dec = roofline.decode_step_flops(32, 128) * 200
        assert theirs == pytest.approx(ours + dec)     # the recomputed decoder
    else:
        assert theirs == pytest.approx(ours)


def test_exact_window_count_and_bounds():
    assert flops.gl_iteration_flops_exact(8, 1000, 2048, 1102) == pytest.approx(72.3e9, rel=1e-3)
    assert flops.attn_energy_bytes(32, 128, 256, 2, False) == pytest.approx(2.13e6, rel=0.01)
    assert flops.attn_energy_bytes(32, 128, 256, 2, True) == pytest.approx(4.23e6, rel=0.01)
    assert flops.speed_of_light(989e12, 0) == pytest.approx(1.0)
