"""Port ops vs the JAX package on the CPU: GRU cells and scans, prenet,
batch norm, conv bank, conv projections, highway, CBHG, attention.

The same numpy inputs and the same parameters (JAX init, moved across with
``weights.from_flax``) go through both. Batch-norm statistics are randomised
so inference normalisation is really exercised. Tolerance: atol 1e-5 (f32;
only the summation order differs), as tests/unit/test_parity_fixtures.py
uses for forwards; the frozen fixtures are checked at that file's
tolerances too.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from tacotron_tpu import ops as jops
from tacotron_tpu.ops.gru import GRUCell as JGRUCell, _ScanGRU as JScanGRU
from tacotron_tpu_torch.ops import modules as tmod
from tacotron_tpu_torch.ops.attention import BahdanauAttention
from tacotron_tpu_torch.ops.cbhg import CBHG, max_pool_same2
from tacotron_tpu_torch.ops.gru import GRUCell, _ScanGRU, bidirectional_gru, unidirectional_gru
from tacotron_tpu_torch.weights import from_flax

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
ATOL = 1e-5


def _randomise_stats(variables, seed):
    """Random running mean/var (var > 0) so BN inference is not identity."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                          else rng.normal(0, 0.3, a.shape)).astype(np.float32),
            v["batch_stats"])
    return v


def _port(module, variables):
    params, stats = from_flax(variables)
    module.load_state_dict({**params, **stats}, strict=True)
    return module.eval()


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (name, JAX module, port module, inputs as numpy, JAX call kwargs, port call)
def _cases():
    lengths = np.array([9, 5, 7])
    return {
        "gru_cell": (JGRUCell(16), GRUCell(8, 16),
                     (_x((3, 16), 1), _x((3, 8), 2)), {}),
        "scan_fwd": (JScanGRU(16), _ScanGRU(8, 16), (_x((3, 9, 8)),), {}),
        "scan_reverse": (JScanGRU(16, reverse=True), _ScanGRU(8, 16, reverse=True),
                         (_x((3, 9, 8)),), {}),
        "scan_reverse_lengths": (JScanGRU(16, reverse=True), _ScanGRU(8, 16, reverse=True),
                                 (_x((3, 9, 8)),), {"lengths": lengths}),
        "bigru": (jops.bidirectional_gru(16), bidirectional_gru(8, 16),
                  (_x((3, 9, 8)),), {}),
        "bigru_lengths": (jops.bidirectional_gru(16), bidirectional_gru(8, 16),
                          (_x((3, 9, 8)),), {"lengths": lengths}),
        "prenet": (jops.Prenet((32, 16), dropout=0.5, deterministic=True),
                   tmod.Prenet(24, (32, 16), dropout=0.5, deterministic=True),
                   (_x((4, 24)),), {}),
        "batchnorm": (jops.BatchNorm(train=False), tmod.BatchNorm(12),
                      (_x((2, 5, 12)),), {}),
        "conv_bank_k4": (jops.ConvBank(4, 8, train=False), tmod.ConvBank(4, 6, 8),
                         (_x((2, 11, 6)),), {}),
        "conv_bank_k5": (jops.ConvBank(5, 4, train=False), tmod.ConvBank(5, 6, 4),
                         (_x((2, 11, 6)),), {}),
        "conv_projection": (jops.Conv1dProjection((12, 6), train=False),
                            tmod.Conv1dProjection(10, (12, 6)), (_x((2, 9, 10)),), {}),
        "highway": (jops.HighwayStack(3, 16), tmod.HighwayStack(16, 3, 16),
                    (_x((2, 7, 16)),), {}),
        "highway_resize": (jops.HighwayStack(2, 16), tmod.HighwayStack(10, 2, 16),
                           (_x((2, 7, 10)),), {}),
        "cbhg_lengths": (jops.CBHG(k=4, bank_channels=8, proj_dims=(16, 12),
                                   highway_layers=2, highway_dim=16, gru_dim=8,
                                   train=False),
                         CBHG(12, 4, 8, (16, 12), 2, 16, 8),
                         (_x((3, 9, 12)),), {"lengths": lengths}),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    jm, tm, inputs, kw = CASES[name]
    jin = [jnp.asarray(a) for a in inputs]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    variables = _randomise_stats(jm.init(jax.random.PRNGKey(7), *jin, **jkw), 3)
    want = jm.apply(variables, *jin, **jkw)
    want = want[0] if isinstance(want, tuple) else want
    tm = _port(tm, variables)
    with torch.no_grad():
        got = tm(*[torch.from_numpy(a) for a in inputs],
                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    got = got[0] if isinstance(got, tuple) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_attention_matches_jax():
    jm = jops.BahdanauAttention(dim=24)
    q, mem = _x((2, 12)), _x((2, 11, 20), 1)
    mask = np.arange(11)[None, :] < np.array([11, 6])[:, None]
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(mem), method=jm.full_step)
    want = jm.apply(v, jnp.asarray(q), jnp.asarray(mem), jnp.asarray(mask), method=jm.full_step)
    tm = _port(BahdanauAttention(12, 24, memory_dim=20), v)
    with torch.no_grad():
        got = tm.full_step(torch.from_numpy(q), torch.from_numpy(mem), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert float(got[1][1, 6:].max()) < 1e-6


def _fixture(name):
    data = dict(np.load(os.path.join(FIXDIR, f"{name}.npz")))
    ins = {k[4:]: v for k, v in data.items() if k.startswith("in__")}
    outs = {k[5:]: v for k, v in data.items() if k.startswith("out__")}
    return ins, outs, data


def _cbhg_from_geom(g):
    k, bc, p0, p1, hl, hd, gd = g.tolist()
    return CBHG(p1, k, bc, (p0, p1), hl, hd, gd)


# fixture -> (port module, inputs -> call, {output: tolerance}); tolerances
# as tests/unit/test_parity_fixtures.py
FIXTURES = {
    "gru": (lambda ins: unidirectional_gru(8, 16), lambda m, ins: m(ins["xs"]),
            {"ys": 1e-5, "h": 1e-5}),
    "prenet": (lambda ins: tmod.Prenet(24, (32, 16), deterministic=True),
               lambda m, ins: (m(ins["x"]),), {"y": 1e-5}),
    "highway": (lambda ins: tmod.HighwayStack(16, 4, 16),
                lambda m, ins: (m(ins["x"]),), {"y": 1e-5}),
    "attention": (lambda ins: BahdanauAttention(12, 24, memory_dim=20),
                  lambda m, ins: m.full_step(ins["q"], ins["mem"]),
                  {"ctx": 1e-5, "align": 1e-5}),
    "cbhg_encoder": (lambda ins: _cbhg_from_geom(ins["geom"]),
                     lambda m, ins: (m(ins["x"]),), {"y": 2e-5}),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_forward(name):
    make, call, tols = FIXTURES[name]
    ins, outs, data = _fixture(name)
    m = _port(make(ins), data)
    with torch.no_grad():
        got = call(m, {k: torch.from_numpy(v) for k, v in ins.items()})
    for (key, tol), g in zip(tols.items(), got):
        np.testing.assert_allclose(g.numpy(), outs[key], atol=tol)


def test_dropout_keeps_half_and_follows_the_generator():
    x = torch.ones(200_000)
    a = tmod.dropout(x, 0.5, torch.Generator().manual_seed(1))
    b = tmod.dropout(x, 0.5, torch.Generator().manual_seed(1))
    c = tmod.dropout(x, 0.5, torch.Generator().manual_seed(2))
    keep = float((a != 0).float().mean())
    assert abs(keep - 0.5) < 0.01
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tmod.dropout(x, 0.0, None) is x


def test_max_pool_tie_gradient_goes_where_xla_sends_it():
    """On a tie max(h[t], h[t+1]) sends its whole gradient to h[t], as the
    select-and-scatter behind flax's ``max_pool`` does (``torch.maximum``
    would split it; bf16 activations tie often)."""
    h = np.array([[[1.0], [1.0], [0.5], [2.0], [2.0], [2.0]]], np.float32)
    co = np.arange(1, 7, dtype=np.float32).reshape(1, 6, 1)
    want = jax.grad(lambda x: jnp.sum(
        nn.max_pool(x, window_shape=(2,), strides=(1,), padding="SAME") * co))(h)
    x = torch.tensor(h, requires_grad=True)
    y = max_pool_same2(x)
    (y * torch.from_numpy(co)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(
        nn.max_pool(h, window_shape=(2,), strides=(1,), padding="SAME")))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
