"""The port against the frozen goldens whose outputs the other port tests
leave out: the teacher-forced Tacotron forward (mel, linear, alignments),
and the CBHG encoder's input gradient and parameter-gradient norm (its
forward is held in tests/test_torch_ops.py).

Parameters come from each fixture (``weights.from_flax`` on its
``param__a/b/c`` naming); tolerances are tests/unit/test_parity_fixtures.py's:
atol 1e-5 for the forward outputs, rtol 1e-4 (atol 1e-5) for the
gradients. No JAX: the goldens are the reference.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.ops.cbhg import CBHG
from tacotron_tpu_torch.weights import from_flax

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _fixture(name):
    data = dict(np.load(os.path.join(FIXDIR, f"{name}.npz")))
    ins = {k[4:]: v for k, v in data.items() if k.startswith("in__")}
    outs = {k[5:]: v for k, v in data.items() if k.startswith("out__")}
    return ins, outs, data


def _load(module, data):
    params, stats = from_flax(data)
    module.load_state_dict({**params, **stats}, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def teacher_forced():
    ins, outs, data = _fixture("tacotron_teacher_forced")
    cfg = dataclasses.replace(get_config("tiny_cpu").model, vocab_size=32, prenet_dropout=0.0)
    model = _load(Tacotron(cfg, device="cpu"), data)
    with torch.no_grad():
        out = model(torch.from_numpy(ins["text"]).long(), torch.from_numpy(ins["lengths"]).long(),
                    gt_mel=torch.from_numpy(ins["mel_in"]),
                    generator=torch.Generator().manual_seed(25))
    return out, outs


@pytest.mark.parametrize("key", ["mel", "linear", "alignments"])
def test_teacher_forced_fixture_outputs(teacher_forced, key):
    out, outs = teacher_forced
    got = getattr(out, key).numpy()
    assert got.shape == outs[key].shape
    np.testing.assert_allclose(got, outs[key], atol=1e-5)


@pytest.fixture(scope="module")
def cbhg_grads():
    ins, outs, data = _fixture("cbhg_encoder")
    k, bc, p0, p1, hl, hd, gd = ins["geom"].tolist()
    m = _load(CBHG(p1, k, bc, (p0, p1), hl, hd, gd), data)
    x = torch.from_numpy(ins["x"]).requires_grad_(True)
    y = m(x)
    # the fixture's loss: sum(out * cos(0.01 * flat index))
    w = torch.cos(torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) * 0.01)
    params = list(m.parameters())
    grads = torch.autograd.grad((y * w).sum(), [x, *params])
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads[1:])))
    return grads[0], norm, outs


def test_cbhg_fixture_input_gradient(cbhg_grads):
    grad_x, _, outs = cbhg_grads
    assert grad_x.shape == outs["grad_x"].shape
    np.testing.assert_allclose(grad_x.numpy(), outs["grad_x"], rtol=1e-4, atol=1e-5)


def test_cbhg_fixture_param_grad_norm(cbhg_grads):
    _, norm, outs = cbhg_grads
    np.testing.assert_allclose(norm, float(outs["param_grad_norm"]), rtol=1e-4)
