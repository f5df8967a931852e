"""The compiled training step's CPU side: ``make_train_step`` against JAX's
jitted step, the device-LR schedule, the graphed step's shape key and cap,
and Adam's restored step count on the parameters' device.

``make_train_step(cfg)`` runs the eager ``train_step`` for a state on the
CPU; it is held over three steps of ``tiny_cpu`` (prenet dropout 0: JAX's PRNG cannot
be reproduced) with LR boundaries after the first and second update, so
each step runs at its own rate, against JAX's ``make_train_step`` from one
JAX initialisation. Tolerances are ``tests/test_torch_train.py``'s: losses
and ``grad_norm`` rtol 1e-4, alignments atol 1e-5, batch statistics atol
1e-6, parameters atol 2e-6 per step taken (one step's 2e-6 adds up over
the three: 241 entries pass 2e-6 after three steps, 39 after one, 41 pass
6e-6 after three) except entries whose clipped gradient is near 0 at some
step, where Adam's step turns rounding noise into up to that step's LR
(such entries must be under 1 in 10^4 and move less than the sum of the
LRs). The graphed step itself runs only on the card
(``tests/test_torch_graph_cuda.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron_tpu.config import TrainConfig as JaxTrainConfig
from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.train.schedule import lr_schedule as jax_lr_schedule
from tacotron_tpu.train.step import (create_train_state as jax_create_train_state,
                                     make_train_step as jax_make_train_step)
from tacotron_tpu_torch.config import Config, TrainConfig
from tacotron_tpu_torch.parallel import make_mesh
from tacotron_tpu_torch.train import checkpoint, create_train_state, make_train_step, train_step
from tacotron_tpu_torch.train.schedule import learning_rate, make_optimizer, set_learning_rate
from tacotron_tpu_torch.train.step import GraphedTrainStep
from tacotron_tpu_torch.weights import from_flax, to_flax

LENGTHS = np.array([9, 6, 4])
T_OUT = 20
FRAME_LEN = np.array([20, 15, 10])
# a boundary after the first and after the second update
SCHEDULE = dict(learning_rate=1e-3, lr_boundaries=(1, 2), lr_values=(1e-3, 5e-4, 2.5e-4))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _jcfg(**model):
    c = jax_get_config("tiny_cpu")
    return dataclasses.replace(
        c, model=dataclasses.replace(c.model, vocab_size=32, prenet_dropout=0.0, **model),
        train=dataclasses.replace(c.train, **SCHEDULE))


def _batch(seed):
    rng = np.random.default_rng(seed)
    b, t = len(LENGTHS), int(LENGTHS.max())
    text = rng.integers(1, 30, (b, t))
    text[np.arange(t)[None, :] >= LENGTHS[:, None]] = 0
    mel = rng.uniform(0, 1, (b, T_OUT, 80)).astype(np.float32)
    linear = rng.uniform(0, 1, (b, T_OUT, 1025)).astype(np.float32)
    return text, LENGTHS, mel, linear, FRAME_LEN


FORMS = {"scan": {}, "hoisted_fused_remat": dict(tf_decoder="hoisted",
                                                 attention_energy="fused", remat_decoder=True)}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_make_train_step_matches_jax_across_lr_boundaries(form):
    jcfg = _jcfg(**FORMS[form])
    j_state = jax_create_train_state(jcfg, jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.asarray, {"params": j_state.params,
                                            "batch_stats": j_state.batch_stats})
    cfg = Config.from_json(jcfg.to_json())
    state = create_train_state(cfg, seed=0, device="cpu")
    params, stats = from_flax(v)
    state.model.load_state_dict({**params, **stats}, strict=True)
    step = make_train_step(cfg)
    j_step = jax_make_train_step(jcfg)
    j_state = jax.tree_util.tree_map(jnp.array, j_state)     # the step donates it
    old = _flat({"params": v["params"]})
    rates = [learning_rate(cfg.train, c) for c in range(3)]
    assert len(set(rates)) == 3
    for i in range(3):
        batch = _batch(i)
        j_state, j_metrics, j_align = j_step(j_state, *batch)
        state, metrics, align = step(state, *map(torch.from_numpy, batch))
        assert state.step == i + 1
        for k in ("mel_loss", "linear_loss", "total_loss", "grad_norm"):
            assert float(metrics[k]) == pytest.approx(float(j_metrics[k]), rel=1e-4), (i, k)
        np.testing.assert_allclose(align.numpy(), np.asarray(j_align), atol=1e-5)
    got = _flat(to_flax(*map(dict, (state.model.named_parameters(),
                                    state.model.named_buffers()))))
    want = _flat(jax.tree_util.tree_map(np.asarray, {"params": j_state.params,
                                                     "batch_stats": j_state.batch_stats}))
    assert sorted(got) == sorted(want)
    n_off = n_all = 0
    for k, w in want.items():
        if not k.startswith("params"):
            np.testing.assert_allclose(got[k], w, atol=1e-6, err_msg=k)
            continue
        # Adam's steps move a weight by about the LR each; where a clipped
        # gradient is near 0 they turn its rounding noise into up to the LR
        # (those entries move less than the LRs' sum): only there may an
        # entry miss 2e-6 a step, and such entries must be rare
        off = np.abs(got[k] - w) > 2e-6 * len(rates)
        n_off, n_all = n_off + int(off.sum()), n_all + w.size
        assert (np.abs(w - old[k])[off] < 0.99 * sum(rates)).all(), k
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


@pytest.mark.parametrize("on_mesh", [False, True])
def test_make_train_step_is_the_eager_step_on_the_cpu(on_mesh):
    """In one process ``make_train_step`` is a ``GraphedTrainStep``; for a
    state on the CPU it runs ``train_step`` itself, bit for bit, and
    records no shape."""
    cfg = Config.from_json(_jcfg().to_json())
    mesh = make_mesh(cfg.mesh, "cpu") if on_mesh else None
    step = make_train_step(cfg, mesh)
    assert isinstance(step, GraphedTrainStep)
    batch = [torch.from_numpy(x) for x in _batch(0)]
    got, g_metrics, g_align = step(create_train_state(cfg, seed=0, device="cpu", mesh=mesh),
                                   *batch)
    want, w_metrics, w_align = train_step(create_train_state(cfg, seed=0, device="cpu",
                                                             mesh=mesh), *batch, cfg=cfg,
                                          mesh=mesh)
    assert got.step == want.step == 1 and not step.graphs
    assert all(torch.equal(g_metrics[k], w_metrics[k]) for k in w_metrics)
    assert torch.equal(g_align, w_align)
    for (k, a), (_, b) in zip(got.model.state_dict().items(), want.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def test_device_lr_follows_optax_schedule():
    """A tensor LR (a capturable Adam's on the card; here on the CPU with
    foreach off, which torch allows) is filled in place with each update's
    rate, and those rates are optax's. On the CPU ``make_optimizer`` keeps
    a float LR and capturable off."""
    train = TrainConfig(**SCHEDULE)
    want = jax_lr_schedule(JaxTrainConfig(**SCHEDULE))
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p], lr=torch.tensor(1.0), foreach=False)
    lr = opt.param_groups[0]["lr"]
    for count in range(5):
        set_learning_rate(opt, train, count)
        assert opt.param_groups[0]["lr"] is lr                   # filled, not replaced
        assert float(lr) == pytest.approx(float(want(count)), rel=1e-6), count
        assert float(lr) == np.float32(learning_rate(train, count))
    cpu = make_optimizer([p], train)
    assert not cpu.param_groups[0]["capturable"]
    set_learning_rate(cpu, train, 2)
    assert cpu.param_groups[0]["lr"] == learning_rate(train, 2)


def _tensors(b, t_in, t_out, dtype=torch.float32, frame_len=True):
    return (torch.zeros(b, t_in, dtype=torch.int64), torch.zeros(b, dtype=torch.int64),
            torch.zeros(b, t_out, 80, dtype=dtype), torch.zeros(b, t_out, 1025, dtype=dtype),
            torch.zeros(b, dtype=torch.int64) if frame_len else None)


def test_shape_key():
    cfg = Config.from_json(_jcfg().to_json())
    key = functools.partial(GraphedTrainStep(cfg).shape_key, "cpu")
    assert key(*_tensors(3, 9, 20)) == key(*_tensors(3, 9, 20))
    distinct = [key(*_tensors(3, 9, 20)), key(*_tensors(3, 9, 30)), key(*_tensors(3, 8, 20)),
                key(*_tensors(4, 9, 20)), key(*_tensors(3, 9, 20, torch.float16)),
                key(*_tensors(3, 9, 20, frame_len=False)),
                GraphedTrainStep(cfg).shape_key("cuda", *_tensors(3, 9, 20))]
    assert len(set(distinct)) == len(distinct)
    # frame_len None is its own key, not a tensor of any shape
    assert key(*_tensors(3, 9, 20, frame_len=False))[-1] is None


def test_graphed_step_caps_its_shapes():
    """A graphed step serves at most ``cfg.data.num_buckets`` shapes: a
    further one raises before any device work, a shape it serves does not.
    A state on the CPU records no shape, so the cap never stops it."""
    jcfg = _jcfg()
    cfg = Config.from_json(jcfg.to_json())
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_buckets=2))
    step = GraphedTrainStep(cfg)
    assert step.max_shapes == 2
    for t_out in (20, 30):
        step.graphs[step.shape_key("cpu", *_tensors(3, 9, t_out))] = None
    with pytest.raises(ValueError, match="at most cfg.data.num_buckets = 2"):
        step.shape_key("cpu", *_tensors(3, 9, 40))
    assert step.shape_key("cpu", *_tensors(3, 9, 30)) in step.graphs
    state = create_train_state(cfg, seed=0, device="cpu")
    state, _, _ = step(state, *map(torch.from_numpy, _batch(0)))
    assert state.step == 1 and len(step.graphs) == 2


def test_restore_puts_adam_step_on_the_parameters_device(tmp_path):
    cfg = Config.from_json(_jcfg().to_json())
    state = create_train_state(cfg, seed=0, device="cpu")
    state, _, _ = train_step(state, *map(torch.from_numpy, _batch(0)), cfg=cfg)
    checkpoint.save(str(tmp_path), 1, state, cfg.train)
    fresh, _ = checkpoint.restore(str(tmp_path), create_train_state(cfg, seed=1, device="cpu"),
                                  cfg.train)
    for p in fresh.model.parameters():
        st = fresh.opt.state[p]["step"]
        assert st.device == p.device and st.dtype == torch.float32 and float(st) == 1.0
