"""The flax <-> port parameter bridge (``tacotron_tpu_torch.weights``).

``from_flax``/``to_flax`` must round-trip a whole JAX ``Tacotron`` variable
tree exactly, and every frozen fixture's ``param__*`` arrays must load
(strictly) into the matching port module.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.ops import modules as tmod
from tacotron_tpu_torch.ops.attention import BahdanauAttention
from tacotron_tpu_torch.ops.cbhg import CBHG
from tacotron_tpu_torch.ops.gru import unidirectional_gru
from tacotron_tpu_torch.weights import from_flax, init_params, split_state, to_flax

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def jax_variables():
    cfg = dataclasses.replace(jax_get_config("tiny_cpu").model, vocab_size=32)
    m = JaxTacotron(cfg, train=False)
    v = m.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
               jnp.ones((2, 5), jnp.int32), jnp.array([5, 3]),
               gt_mel=jnp.zeros((2, 2 * cfg.r, cfg.n_mels)))
    return cfg, jax.tree_util.tree_map(np.asarray, v)


def test_round_trip_full_tacotron(jax_variables):
    jcfg, v = jax_variables
    params, stats = from_flax(v)
    cfg = Config.from_json(dataclasses.replace(
        jax_get_config("tiny_cpu"), model=jcfg).to_json()).model
    model = Tacotron(cfg, device="cpu")
    model.load_state_dict({**params, **stats}, strict=True)
    want, got = _flat(v), _flat(to_flax(*split_state(model)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_layouts(jax_variables):
    _, v = jax_variables
    params, stats = from_flax(v)
    p = v["params"]
    k = p["decoder"]["cell"]["frame_proj"]["kernel"]             # Dense (in, out)
    np.testing.assert_array_equal(params["decoder.cell.frame_proj.weight"].numpy(), k.T)
    c = p["encoder"]["cbhg"]["proj"]["proj0"]["kernel"]          # Conv (W, in, out)
    np.testing.assert_array_equal(params["encoder.cbhg.proj.proj0.weight"].numpy(),
                                  c.transpose(2, 1, 0))
    assert params["decoder.cell.attention.v"].shape == (64, 1)
    np.testing.assert_array_equal(
        stats["encoder.cbhg.bank.bn1.running_var"].numpy(),
        v["batch_stats"]["encoder"]["cbhg"]["bank"]["bn1"]["bn"]["var"])
    np.testing.assert_array_equal(
        params["encoder.cbhg.bigru.fwd.gates_h.weight"].numpy(),
        p["encoder"]["cbhg"]["bigru"]["fwd"]["gates_h"]["kernel"].T)


def _tacotron_fixture_module(ins):
    cfg = dataclasses.replace(jax_get_config("tiny_cpu").model, vocab_size=32)
    return Tacotron(Config.from_json(dataclasses.replace(
        jax_get_config("tiny_cpu"), model=cfg).to_json()).model, device="cpu")


def _cbhg(ins):
    k, bc, p0, p1, hl, hd, gd = ins["in__geom"].tolist()
    return CBHG(p1, k, bc, (p0, p1), hl, hd, gd)


FIXTURE_MODULES = {
    "gru": lambda ins: unidirectional_gru(8, 16),
    "prenet": lambda ins: tmod.Prenet(24, (32, 16)),
    "highway": lambda ins: tmod.HighwayStack(16, 4, 16),
    "attention": lambda ins: BahdanauAttention(12, 24, memory_dim=20),
    "cbhg_encoder": _cbhg,
    "tacotron_teacher_forced": _tacotron_fixture_module,
}


@pytest.mark.parametrize("name", sorted(FIXTURE_MODULES))
def test_fixture_params_load(name):
    data = dict(np.load(os.path.join(FIXDIR, f"{name}.npz")))
    module = FIXTURE_MODULES[name](data)
    params, stats = from_flax(data)          # the param__a/b/c flat naming
    module.load_state_dict({**params, **stats}, strict=True)
    back = _flat(to_flax(*split_state(module)))
    want = {k[len("param__"):]: v for k, v in data.items() if k.startswith("param__")}
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)


def test_init_params_is_seeded_and_shaped_like_flax():
    cfg = Config.from_json(jax_get_config("tiny_cpu").to_json()).model
    a = split_state(init_params(Tacotron(cfg, device="cpu"), seed=3))[0]
    b = split_state(init_params(Tacotron(cfg, device="cpu"), seed=3))[0]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["decoder.cell.attention_gru.gates.bias"] == 1.0)
    assert torch.all(a["encoder.cbhg.highway.T0.bias"] == -1.0)
    assert torch.all(a["encoder.cbhg.bank.bn1.weight"] == 1.0)
    assert float(a["memory_proj.weight"].std()) > 0
