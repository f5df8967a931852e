"""The capability probes' plain versions against numpy, and the entry
point's contract. The kernels themselves (``csrc/probe.cu``) are held
against these plain versions on the card in tests/test_torch_kernels_cuda.py.

Tolerance: the ops probe is f32 with sums of at most 256 terms, held to
1e-4 of its peak against a float64 numpy evaluation [5.1e-7 measured].
"""

import numpy as np
import pytest
import torch

from tacotron_tpu_torch import probe, runtime


def _ops_numpy(spec, d, p):
    spec, d, p = (np.asarray(a, np.float64) for a in (spec, d, p))
    out = spec @ d.T
    y = np.zeros((spec.shape[0] + 8, d.shape[0]))
    y[3:3 + len(out)] += out
    y[5:5 + len(out)] += out * 0.5
    y[7] = y[5] @ p
    return y + 4 * y[0:8].sum() * 1e-9


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_probe_ops_reference_matches_numpy(seed):
    spec, d, p = probe.ops_inputs("cpu", seed)
    want = _ops_numpy(spec, d, p)
    got = probe.probe_ops_reference(spec, d, p).numpy()
    assert got.shape == (72, 275) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    # rows 0..2 hold only the loop's sum; row 7 is row 5 reversed, written
    # after both accumulations
    s = 4 * want[0:8].sum() * 1e-9
    np.testing.assert_allclose(got[:3], s, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got[7] - s, (got[5] - s)[::-1],
                               atol=1e-4 * np.abs(want).max())


def test_probe_ops_with_ones_as_the_tpu_probe_ran_it():
    got = probe.probe_ops(*probe.ops_inputs("cpu")).numpy()
    s = got[0, 0]
    np.testing.assert_allclose(got[3:5] - s, 256.0, rtol=1e-6)
    np.testing.assert_allclose(got[5:67] - s, 384.0, rtol=1e-6)
    np.testing.assert_allclose(got[67:69] - s, 128.0, rtol=1e-6)
    np.testing.assert_allclose(got[69:] - s, 0.0, atol=1e-4)


def test_probe_smem_reference_and_cpu_path():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(probe.SMEM_SHAPE)
                         .astype(np.float32))
    before = dict(runtime.LAUNCHES)
    out, limit = probe.probe_smem(x, 100)
    assert limit is None and torch.equal(out, probe.probe_smem_reference(x))
    np.testing.assert_array_equal(out.numpy(), x.numpy() * 2)
    assert dict(runtime.LAUNCHES) == before
    with pytest.raises(ValueError, match="cannot hold"):
        probe.probe_smem(x, 8)


@pytest.mark.parametrize("argv,line", [
    (["ops"], "ops: True"),
    (["smem", "227"], "smem 227KiB: True (max opt-in per block: None bytes)"),
])
def test_entry_point_prints_one_line(capsys, argv, line):
    assert probe.main(argv, device="cpu") == 0
    assert capsys.readouterr().out.strip() == line


@pytest.mark.parametrize("argv", [[], ["smem"], ["ops", "1"], ["vmem", "8"]])
def test_entry_point_usage(capsys, argv):
    assert probe.main(argv, device="cpu") == 2
    assert "usage" in capsys.readouterr().err


def test_entry_point_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["ops"])


def test_probe_source_is_built_with_the_other_kernels():
    assert "probe" in runtime.KERNEL_SOURCES
    assert (runtime.CSRC_DIR / "probe.cu").exists()


def test_cluster_barrier_probe_needs_the_card():
    before = dict(runtime.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        probe.probe_cluster_barrier(1, 2, 10, device="cpu")
    assert dict(runtime.LAUNCHES) == before
