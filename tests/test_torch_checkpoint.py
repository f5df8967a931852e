"""The port's checkpoints (``train/checkpoint.py``) and the JAX package's,
each restored by the other, on the CPU at ``tiny_cpu``.

Following the JAX package's own checkpoint tests
(tests/unit/test_train_components.py): a save and restore is bit-identical,
``latest`` and keep-N pruning hold, a hidden temporary directory is never a
checkpoint, and a restore into a state of another shape fails naming the
leaf's path. Across the two packages: the JAX package's ``checkpoint.save``
of a trained ``TrainState`` restores into the port with every leaf equal
(parameters through ``weights.from_flax``, Adam's moments through the same
transposes) and the port's eval forward within atol 1e-5 of JAX's
(ROADMAP's rule for forwards); the port's checkpoint restores through the
JAX package's ``checkpoint.restore`` into its own template with every leaf
equal. k + m port training steps equal k steps, a save, a restore into a
fresh state and m more, bit for bit (prenet dropout on).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu.train import checkpoint as jax_checkpoint
from tacotron_tpu.train.step import create_train_state as jax_create_train_state
from tacotron_tpu.train.step import make_train_step as jax_make_train_step
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.train import checkpoint, create_train_state, train_step

LENGTHS = np.array([9, 6, 4])
T_OUT = 20
FRAME_LEN = np.array([20, 15, 10])


def _jcfg(**model):
    c = jax_get_config("tiny_cpu")
    return dataclasses.replace(c, model=dataclasses.replace(c.model, vocab_size=32, **model))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    b, t = len(LENGTHS), int(LENGTHS.max())
    text = rng.integers(1, 30, (b, t))
    text[np.arange(t)[None, :] >= LENGTHS[:, None]] = 0
    mel = rng.uniform(0, 1, (b, T_OUT, 80)).astype(np.float32)
    linear = rng.uniform(0, 1, (b, T_OUT, 1025)).astype(np.float32)
    return text, LENGTHS, mel, linear, FRAME_LEN


def _port(jcfg, seed=0):
    cfg = Config.from_json(jcfg.to_json())
    return cfg, create_train_state(cfg, seed=seed, device="cpu")


def _train(state, cfg, n, seed=0):
    for i in range(n):
        state, metrics, _ = train_step(state, *map(torch.from_numpy, _batch(seed + i)), cfg=cfg)
    return state, metrics


def _state_tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for slot, v in state.opt.state[p].items():
            out[f"opt/{name}/{slot}"] = v
    return out


def _assert_same_state(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_save_restore_bit_identical(tmp_path):
    cfg, state = _port(_jcfg())
    state, _ = _train(state, cfg, 2)
    d = str(tmp_path / "ckpt")
    path = checkpoint.save(d, state.step, state, cfg.train)
    assert sorted(os.listdir(path)) == ["leaves.npz", "torch_state.npz", "treedef.json"]
    with open(os.path.join(path, "treedef.json")) as f:
        meta = json.load(f)
    assert meta["treedef"] is None and meta["step"] == 2 and meta["n_leaves"] == 352
    assert meta["paths"][:1] == ["params/decoder/cell/attention/query/kernel"]
    assert meta["paths"][-4:] == ["opt_state/1/nu/postnet/linear_proj/kernel",
                                  "opt_state/2/count", "step", "rng"]
    _, fresh = _port(_jcfg(), seed=7)
    restored, step = checkpoint.restore(d, fresh, cfg.train)
    assert step == 2
    _assert_same_state(restored, state)


def test_latest_keep_and_no_partial_checkpoint(tmp_path):
    cfg, state = _port(_jcfg())
    d = str(tmp_path / "ckpt")
    for s in range(1, 8):
        checkpoint.save(d, s, state, cfg.train, keep=3)
    assert checkpoint.latest(d) == 7 and checkpoint.all_steps(d) == [5, 6, 7]
    os.makedirs(os.path.join(d, ".tmp_step_8"))
    assert checkpoint.all_steps(d) == [5, 6, 7]
    restored, step = checkpoint.restore(d, state, cfg.train, step=6)
    assert step == 6
    assert checkpoint.latest(str(tmp_path / "none")) is None


def test_restore_errors_name_the_leaf(tmp_path):
    cfg, state = _port(_jcfg())
    d = str(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(d, state, cfg.train)
    checkpoint.save(d, 1, state, cfg.train)
    # the same leaf count, another shape
    cfg2, other = _port(_jcfg(attention_dim=32))
    with pytest.raises(ValueError, match="params/decoder/cell/attention/query/kernel"):
        checkpoint.restore(d, other, cfg2.train)
    # another leaf count
    cfg3, fewer = _port(_jcfg(decoder_depth=1))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(d, fewer, cfg3.train)
    # the same count and shapes under other names
    meta_path = os.path.join(d, "step_1", "treedef.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["paths"][0] = "params/renamed"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="params/renamed"):
        checkpoint.restore(d, state, cfg.train)


@pytest.fixture(scope="module")
def jax_trained():
    """A JAX TrainState after one jitted step on the batch, and its config
    (prenet dropout 0, so that the two forwards can be compared)."""
    jcfg = _jcfg(prenet_dropout=0.0)
    j_state = jax_create_train_state(jcfg, jax.random.PRNGKey(0))
    j_state, _, _ = jax_make_train_step(jcfg)(j_state, *_batch())
    return jcfg, j_state


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_jax_checkpoint_restores_into_the_port(tmp_path, jax_trained):
    jcfg, j_state = jax_trained
    d = str(tmp_path / "ckpt")
    jax_checkpoint.save(d, 1, j_state)
    cfg, state = _port(jcfg, seed=3)
    state, step = checkpoint.restore(d, state, cfg.train)
    assert step == 1 and state.step == 1
    got = checkpoint.state_leaves(state, cfg.train)
    want = _jax_leaves(j_state)
    assert len(got) == len(want) == 352
    for (name, g), w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # no port file: the generator is seeded from rng
    key = np.asarray(j_state.rng)
    assert state.generator.initial_seed() == (int(key[0]) << 32) | int(key[1])
    # the eval forwards agree
    text, lengths, mel = _batch(1)[:3]
    jout = JaxTacotron(jcfg.model, train=False).apply(
        {"params": j_state.params, "batch_stats": j_state.batch_stats},
        text, lengths, gt_mel=mel)
    model = state.model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(text), torch.from_numpy(lengths),
                    gt_mel=torch.from_numpy(mel))
    for g, w, name in zip(out, jout, ("mel", "linear", "alignments")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_port_checkpoint_restores_into_jax(tmp_path, jax_trained):
    jcfg, j_state = jax_trained
    cfg, state = _port(jcfg)
    state, _ = _train(state, cfg, 1)
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, state, cfg.train)
    template = jax.tree_util.tree_map(jnp.zeros_like, j_state)
    restored, step = jax_checkpoint.restore(d, template)
    assert step == 1
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(j_state)
    for (name, g), w in zip(checkpoint.state_leaves(state, cfg.train), _jax_leaves(restored)):
        np.testing.assert_array_equal(w, g, err_msg=name)
    assert int(restored.step) == 1


def test_resume_is_bit_identical(tmp_path):
    jcfg = _jcfg()
    assert jcfg.model.prenet_dropout > 0          # the generator matters
    cfg, straight = _port(jcfg)
    straight, m_straight = _train(straight, cfg, 3)
    _, first = _port(jcfg)
    first, _ = _train(first, cfg, 2)
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, first.step, first, cfg.train)
    _, resumed = _port(jcfg, seed=11)
    resumed, _ = checkpoint.restore(d, resumed, cfg.train)
    resumed, m_resumed = _train(resumed, cfg, 1, seed=2)
    _assert_same_state(resumed, straight)
    for k in ("total_loss", "grad_norm"):
        assert torch.equal(m_resumed[k], m_straight[k]), k
