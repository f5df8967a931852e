"""The capability probes' plain versions against numpy, and the entry
point's contract. The kernels themselves (``csrc/probe.cu``) are held
against these plain versions on the card in tests/test_torch_kernels_cuda.py.

Tolerance: the ops probe is f32 with sums of at most 256 terms, held to
1e-4 of its peak against a float64 numpy evaluation [5.1e-7 measured]. The
ops kernel's launch geometry (``probe.ops_plan``) is checked to write every
output element once, and its order of summation, emulated in numpy at each
cluster size, is held to the same 1e-4 of the peak against the plain
version.
"""

import re

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


# the built cluster size and another the geometry allows (slower on an H100)
CLUSTERS = (probe.OPS_CLUSTER, 8)


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_ops_plan_writes_every_output_once(cluster):
    plan = probe.ops_plan(cluster)
    assert plan.cluster == len(plan.cols) == cluster
    written = np.zeros((probe.OPS_F + 8, probe.OPS_H), int)
    for c0, c1 in plan.cols:              # rank r: all rows of its columns
        written[:, c0:c1] += 1
    assert (written == 1).all()
    # the permutation product's rows split the same way, each read once
    read = np.zeros(probe.OPS_H, int)
    for c0, c1 in plan.cols:
        read[c0:c1] += 1
    assert (read == 1).all()
    widest = max(c1 - c0 for c0, c1 in plan.cols)
    assert widest <= 4 * plan.col_groups < widest + 4
    for r, (c0, c1) in enumerate(plan.cols):
        assert all(probe.ops_owner(j, cluster) == r for j in range(c0, c1))
    # a thread per column of p, within a block's limits
    assert probe.OPS_H <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem_bytes <= 227 * 1024


def test_ops_plan_refuses_other_cluster_sizes():
    for c in (0, 1, 4, 17, 32):
        with pytest.raises(ValueError, match="cluster"):
            probe.ops_plan(c)


def test_ops_geometry_matches_the_source():
    src = (runtime.CSRC_DIR / "probe.cu").read_text()
    const = {k: re.search(rf"constexpr int {k} = ([^;]+);", src).group(1)
             for k in ("kOpsLd", "kOpsRowGroups", "kOpsSplit", "kOpsCluster")}
    assert const == {"kOpsLd": "PS + 4", "kOpsRowGroups": str(probe.OPS_ROW_GROUPS),
                     "kOpsSplit": str(probe.OPS_SPLIT), "kOpsCluster": str(probe.OPS_CLUSTER)}


def _fma(acc, a, b):
    """f32 fused multiply-add: the product exact in f64, one rounding."""
    return (acc.astype(np.float64) + np.float64(1) * a * b).astype(np.float32)


def _warp_sums(v):
    """Each warp's butterfly sum (tt::warp_sum, lane 0) of per-thread f32
    values, then the warps' sums in order."""
    v = np.concatenate([v, np.zeros(-len(v) % 32, np.float32)]).reshape(-1, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, lane ^ o]).astype(np.float32)
    total = np.float32(0)
    for w in v[:, 0]:
        total = np.float32(total + w)
    return total


def _ops_kernel_emulation(spec, d, p, cluster):
    """csrc/probe.cu's ops kernel in numpy, in its order of summation."""
    f32, half = np.float32, np.float32(0.5)
    spec, d, p = (np.asarray(x, f32) for x in (spec, d, p))
    plan = probe.ops_plan(cluster)
    depth = probe.OPS_S // probe.OPS_SPLIT
    prods, mine, sig = [], [], []
    for c0, c1 in plan.cols:
        b = d[c0:c1]
        parts = []
        for ks in range(probe.OPS_SPLIT):       # each thread group's FMA chain
            acc = np.zeros((probe.OPS_F, c1 - c0), f32)
            for k in range(ks * depth, (ks + 1) * depth):
                acc = _fma(acc, spec[:, k, None], b[None, :, k])
            parts.append(acc)
        prod = parts[0]
        for q in parts[1:]:                     # summed in group order
            prod = (prod + q).astype(f32)
        y5 = (prod[2] + prod[0] * half).astype(f32)
        part = np.zeros(probe.OPS_H, f32)       # thread j: its column of p
        for k in range(c1 - c0):
            part = _fma(part, y5[k], p[c0 + k])
        y6 = (prod[3] + prod[1] * half).astype(f32)
        rows = (((prod[0] + prod[1]).astype(f32) + y5).astype(f32) + y6).astype(f32)
        thread = np.zeros(plan.threads, f32)
        thread[:probe.OPS_H] = part
        thread[:c1 - c0] = (thread[:c1 - c0] + rows).astype(f32)
        prods.append(prod)
        mine.append(part)
        sig.append(_warp_sums(thread))
    total = f32(0)
    for q in sig:                               # in rank order, on every rank
        total = f32(total + q)
    s = f32(0)
    for _ in range(4):
        s = f32(s + f32(total * f32(1e-9)))
    out = np.zeros((probe.OPS_F + 8, probe.OPS_H), f32)
    for (c0, c1), prod in zip(plan.cols, prods):
        y = np.zeros((probe.OPS_F + 8, c1 - c0), f32)
        y[3:3 + probe.OPS_F] = prod
        y[5:5 + probe.OPS_F] = (y[5:5 + probe.OPS_F] + prod * half).astype(f32)
        rev = np.zeros(c1 - c0, f32)
        for part in mine:                       # the ranks' partials in rank order
            rev = (rev + part[c0:c1]).astype(f32)
        y[7] = rev
        out[:, c0:c1] = (y + s).astype(f32)
    return out


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("seed", [None, 0, 1])
def test_ops_kernel_order_matches_plain(cluster, seed):
    spec, d, p = probe.ops_inputs("cpu", seed)
    got = _ops_kernel_emulation(spec.numpy(), d.numpy(), p.numpy(), cluster)
    want = probe.probe_ops_reference(spec, d, p).numpy()
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * peak)
    np.testing.assert_allclose(got, _ops_numpy(spec, d, p), rtol=0, atol=1e-4 * peak)
