"""The training slice: the port's train-mode ``Tacotron``, losses, schedule and
``train_step`` vs the JAX package on the CPU.

Both sides start from one JAX initialisation (``tiny_cpu``, prenet dropout
0: JAX's PRNG cannot be reproduced), moved across with
``weights.from_flax``; the batch is made with numpy from a seed (random ids
padded after each length, uniform mel and linear targets). The port runs
each teacher-forced form (``scan``, ``hoisted``) with each energy form
(``xla``, ``fused``; on CPU tensors ``fused`` is the plain formula) and with
``remat_decoder``; JAX's ``fused`` falls back to its formula on the CPU, so
one JAX run per decoder form is the reference for both energy forms.

Tolerances (max abs error measured on this setup in brackets): train-mode
mel, linear and alignments atol 1e-5, ROADMAP's rule for forwards
[1.8e-6]; gradients of the loss rtol 1e-4 plus atol 1e-6 for entries near
0 [at most 0.25 of 1e-6 + 1e-4 |want|]; updated batch statistics atol 1e-6
[6.0e-8]; one whole ``train_step`` against JAX's jitted step: losses and
``grad_norm`` rtol 1e-4 [4.7e-7 relative], alignments atol 1e-5 [5.2e-8],
batch statistics atol 1e-6 [6.0e-8], updated parameters atol 2e-6 (the
first Adam step moves a weight by lr * g / (|g| + eps), about lr * sign(g))
except where the clipped gradient is within ~100 eps of 0: there the step
amplifies rounding noise in g up to lr, so such entries may miss 2e-6 but
must be under 1 in 10^4 [39 and 33 of 582,673 entries, worst 3.4e-4]; the
LR schedule rtol 1e-6; clipping rtol 1e-6; Adam over four updates atol
1e-6.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron_tpu import ops as jops
from tacotron_tpu.config import TrainConfig as JaxTrainConfig
from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu.train.loss import tacotron_loss as jax_loss
from tacotron_tpu.train.schedule import lr_schedule as jax_lr_schedule
from tacotron_tpu.train.schedule import make_optimizer as jax_make_optimizer
from tacotron_tpu.train.step import (create_train_state as jax_create_train_state,
                                     make_train_step as jax_make_train_step)
from tacotron_tpu_torch.config import Config, TrainConfig
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.ops import modules as tmod
from tacotron_tpu_torch.train import create_train_state, train_step
from tacotron_tpu_torch.train.loss import tacotron_loss
from tacotron_tpu_torch.train.schedule import (apply_gradients, clip_by_global_norm_,
                                               global_norm, learning_rate, make_optimizer)
from tacotron_tpu_torch.weights import from_flax, to_flax

LENGTHS = np.array([9, 6, 4])
T_OUT = 20                                    # 4 decoder steps at r 5
FRAME_LEN = np.array([20, 15, 10])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _jcfg(**model):
    c = jax_get_config("tiny_cpu")
    return dataclasses.replace(c, model=dataclasses.replace(
        c.model, vocab_size=32, prenet_dropout=0.0, **model))


def _port_cfg(jcfg) -> Config:
    return Config.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def setup():
    jcfg = _jcfg()
    rng = np.random.default_rng(0)
    b, t = len(LENGTHS), int(LENGTHS.max())
    text = rng.integers(1, 30, (b, t))
    text[np.arange(t)[None, :] >= LENGTHS[:, None]] = 0
    mel = rng.uniform(0, 1, (b, T_OUT, 80)).astype(np.float32)
    linear = rng.uniform(0, 1, (b, T_OUT, jcfg.model.n_freq)).astype(np.float32)
    state = jax_create_train_state(jcfg, jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                            "batch_stats": state.batch_stats})
    s = dict(jcfg=jcfg, jstate=state, v=v, text=text, mel=mel, linear=linear)
    s["jax"] = {form: _jax_forward_grads(s, form) for form in ("scan", "hoisted")}
    return s


def _jax_forward_grads(s, form):
    model = JaxTacotron(_jcfg(tf_decoder=form).model, train=True)

    def loss_fn(params):
        out, upd = model.apply({"params": params, "batch_stats": s["v"]["batch_stats"]},
                               s["text"], LENGTHS, gt_mel=s["mel"],
                               rngs={"dropout": jax.random.PRNGKey(1)},
                               mutable=["batch_stats"])
        total, _ = jax_loss(out.mel, out.linear, s["mel"], s["linear"])
        return total, (out, upd["batch_stats"])

    (total, (out, bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        s["v"]["params"])
    return dict(total=float(total), out=[np.asarray(x) for x in out],
                grads=_flat(grads), batch_stats=_flat(bs))


def _port_model(s, **model):
    m = Tacotron(_port_cfg(_jcfg(**model)).model, device="cpu")
    params, stats = from_flax(s["v"])
    m.load_state_dict({**params, **stats}, strict=True)
    return m.train()


CASES = [("scan", "xla", False), ("scan", "fused", False), ("hoisted", "xla", False),
         ("hoisted", "fused", False), ("scan", "fused", True), ("hoisted", "fused", True)]


@pytest.mark.parametrize("form,energy,remat", CASES)
def test_train_forward_grads_and_stats_match_jax(setup, form, energy, remat):
    s, want = setup, setup["jax"][form]
    m = _port_model(s, tf_decoder=form, attention_energy=energy, remat_decoder=remat)
    out = m(torch.from_numpy(s["text"]), torch.from_numpy(LENGTHS),
            gt_mel=torch.from_numpy(s["mel"]))
    for g, w, name in zip(out, want["out"], ("mel", "linear", "alignments")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5, err_msg=name)
    total, _ = tacotron_loss(out.mel, out.linear, torch.from_numpy(s["mel"]),
                             torch.from_numpy(s["linear"]))
    assert total.item() == pytest.approx(want["total"], rel=1e-5)
    total.backward()
    grads = _flat(to_flax({k: p.grad for k, p in m.named_parameters()})["params"])
    assert sorted(grads) == sorted(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    stats = _flat(to_flax(*map(dict, (m.named_parameters(), m.named_buffers())))
                  ["batch_stats"])
    assert sorted(stats) == sorted(want["batch_stats"])
    for k, w in want["batch_stats"].items():
        np.testing.assert_allclose(stats[k], w, atol=1e-6, err_msg=k)


TRAIN_STEP_CASES = {
    "scan": dict(model={}, train={}),
    # the training main path's form, with the masked loss and a linear weight
    "hoisted_fused_remat_masked": dict(
        model=dict(tf_decoder="hoisted", attention_energy="fused", remat_decoder=True),
        train=dict(mask_padding=True, loss_linear_weight=0.5)),
}


@pytest.mark.parametrize("case", sorted(TRAIN_STEP_CASES))
def test_train_step_matches_jax(setup, case):
    s, over = setup, TRAIN_STEP_CASES[case]
    jcfg = _jcfg(**over["model"])
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **over["train"]))
    batch = (s["text"], LENGTHS, s["mel"], s["linear"], FRAME_LEN)
    j_state0 = jax.tree_util.tree_map(jnp.array, s["jstate"])   # the step donates it
    j_state, j_metrics, j_align = jax_make_train_step(jcfg)(j_state0, *batch)

    cfg = _port_cfg(jcfg)
    state = create_train_state(cfg, seed=0, device="cpu")
    params, stats = from_flax(s["v"])
    state.model.load_state_dict({**params, **stats}, strict=True)
    state, metrics, align = train_step(state, *map(torch.from_numpy, batch), cfg=cfg)
    assert state.step == 1
    for k in ("mel_loss", "linear_loss", "total_loss", "grad_norm"):
        assert float(metrics[k]) == pytest.approx(float(j_metrics[k]), rel=1e-4), k
    np.testing.assert_allclose(align.numpy(), np.asarray(j_align), atol=1e-5)
    got = _flat(to_flax(*map(dict, (state.model.named_parameters(),
                                    state.model.named_buffers()))))
    want = _flat(jax.tree_util.tree_map(np.asarray, {"params": j_state.params,
                                                     "batch_stats": j_state.batch_stats}))
    assert sorted(got) == sorted(want)
    old = _flat({"params": s["v"]["params"]})
    lr, n_off, n_all = learning_rate(cfg.train, 0), 0, 0
    for k, w in want.items():
        if not k.startswith("params"):
            np.testing.assert_allclose(got[k], w, atol=1e-6, err_msg=k)
            continue
        # Adam's first step is -lr g / (|g| + eps) of the clipped gradient g.
        # Where g is within ~100 eps of 0 (|step| < 0.99 lr) the step turns
        # rounding noise in g into up to lr; only there may an entry miss
        # 2e-6, and such entries must be rare. Every step is at most lr.
        off = np.abs(got[k] - w) > 2e-6
        n_off, n_all = n_off + int(off.sum()), n_all + w.size
        assert (np.abs(w - old[k])[off] < 0.99 * lr).all(), k
        assert np.abs(got[k] - old[k]).max() <= lr + 1e-6, k
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics over (B, T), biased variance, running update with
    momentum 0.99, from non-trivial running statistics."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 7, 12)) * 2 + 0.5).astype(np.float32)
    jm = jops.BatchNorm(train=True)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    v["params"]["bn"] = {"scale": rng.uniform(0.5, 1.5, 12).astype(np.float32),
                         "bias": rng.normal(0, 0.3, 12).astype(np.float32)}
    v["batch_stats"]["bn"] = {"mean": rng.normal(0, 0.3, 12).astype(np.float32),
                              "var": rng.uniform(0.5, 1.5, 12).astype(np.float32)}
    want, upd = jm.apply(v, x, mutable=["batch_stats"])
    bn = tmod.BatchNorm(12)
    params, stats = from_flax(v)
    bn.load_state_dict({**params, **stats})
    got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"]["bn"][key]), atol=1e-6)
    # evaluation mode uses the (updated) running statistics and changes nothing
    before = bn.running_var.clone()
    want_eval = jops.BatchNorm(train=False).apply(
        {"params": v["params"], "batch_stats": upd["batch_stats"]}, x)
    np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want_eval), atol=1e-5)
    assert torch.equal(bn.running_var, before)


@pytest.mark.parametrize("mask_padding,linear_weight", [(False, 1.0), (True, 1.0), (True, 0.5)])
def test_loss_matches_jax(mask_padding, linear_weight):
    rng = np.random.default_rng(4)
    arrs = [rng.uniform(0, 1, (3, 10, d)).astype(np.float32) for d in (8, 8, 33, 33)]
    frame_len = np.array([10, 7, 0])
    t = [torch.from_numpy(a) for a in arrs]
    total, parts = tacotron_loss(t[0], t[2], t[1], t[3], torch.from_numpy(frame_len),
                                 mask_padding=mask_padding, linear_weight=linear_weight)
    j_total, j_parts = jax_loss(arrs[0], arrs[2], arrs[1], arrs[3], frame_len,
                                mask_padding=mask_padding, linear_weight=linear_weight)
    assert float(total) == pytest.approx(float(j_total), rel=1e-6)
    for k in ("mel_loss", "linear_loss", "total_loss"):
        assert float(parts[k]) == pytest.approx(float(j_parts[k]), rel=1e-6), k


SMALL = dict(learning_rate=2e-3, lr_boundaries=(1, 3), lr_values=(1e-3, 5e-4, 2e-4))


def test_lr_schedule_matches_optax():
    """Counts straddling each boundary: the scale applies when count >=
    boundary, and the base rate scales the whole schedule."""
    port, jax_s = TrainConfig(**SMALL), jax_lr_schedule(JaxTrainConfig(**SMALL))
    for count in range(6):
        assert learning_rate(port, count) == pytest.approx(float(jax_s(count)), rel=1e-6)
    assert learning_rate(port, 0) == pytest.approx(2e-3)
    assert learning_rate(port, 1) == pytest.approx(1e-3)
    assert learning_rate(port, 3) == pytest.approx(4e-4)
    with pytest.raises(ValueError, match="lr_values"):
        learning_rate(TrainConfig(lr_boundaries=(1,), lr_values=(1e-3,)), 0)


@pytest.mark.parametrize("scale", [0.1, 1.0, 10.0])
def test_clipping_matches_optax(scale):
    rng = np.random.default_rng(int(scale * 10))
    arrs = [(rng.standard_normal(s) * scale).astype(np.float32) for s in ((5, 3), (7,))]
    norm = float(np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in arrs)))
    max_norm = 1.0 if scale != 1.0 else norm        # at exactly the norm, too
    want, _ = optax.clip_by_global_norm(max_norm).update(arrs, None)
    grads = [torch.from_numpy(a.copy()) for a in arrs]
    assert float(global_norm(grads)) == pytest.approx(norm, rel=1e-6)
    clip_by_global_norm_(grads, max_norm)
    for g, w, a in zip(grads, want, arrs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        if scale < 1.0:
            np.testing.assert_array_equal(g.numpy(), a)     # below the limit: untouched


def test_optimizer_matches_optax_chain():
    """Clip + Adam + stepped LR over four updates with boundaries at
    updates 1 and 3, on random gradients, one of them large enough to clip."""
    cfg = dict(SMALL, grad_clip_norm=1.0)
    tx = jax_make_optimizer(JaxTrainConfig(**cfg))
    rng = np.random.default_rng(6)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    j_params, j_state = list(p0), tx.init(list(p0))
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = make_optimizer(params, TrainConfig(**cfg))
    for count, scale in enumerate((0.3, 5.0, 0.01, 2.0)):
        grads = [(rng.standard_normal(a.shape) * scale).astype(np.float32) for a in p0]
        upd, j_state = tx.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = apply_gradients(opt, TrainConfig(**cfg), count)
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        for p, w in zip(params, j_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-6)


def test_train_state_defaults_to_gpu():
    cfg = _port_cfg(_jcfg())
    if torch.cuda.is_available():
        state = create_train_state(cfg)
        assert next(state.model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            create_train_state(cfg)


def test_refusals():
    cfg = _port_cfg(_jcfg(remat_decoder=True, remat_policy="save_attn"))
    state = create_train_state(cfg, device="cpu")
    batch = (np.ones((2, 5), np.int64), np.array([5, 3]),
             np.zeros((2, 10, 80), np.float32), np.zeros((2, 10, 1025), np.float32), None)
    batch = [torch.from_numpy(x) if x is not None else None for x in batch]
    # remat_policy="save_attn" is ported (tests/test_torch_remat.py holds it
    # against JAX): the same batch trains
    state, metrics, _ = train_step(state, *batch, cfg=cfg)
    assert state.step == 1 and np.isfinite(float(metrics["total_loss"]))
    # bf16 compute is ported (tests/test_torch_mixed_precision.py holds it
    # against JAX): the same batch trains, the parameters stay f32
    bf16 = _port_cfg(_jcfg(compute_dtype="bfloat16"))
    state16, metrics, _ = train_step(create_train_state(bf16, device="cpu"), *batch, cfg=bf16)
    assert state16.step == 1 and np.isfinite(float(metrics["total_loss"]))
    assert all(p.dtype == torch.float32 for p in state16.model.parameters())
    with pytest.raises(ValueError, match="cfg.model differs"):
        train_step(state, *batch, cfg=bf16)
    with pytest.raises(ValueError, match="multiple of r"):
        train_step(state, batch[0], batch[1], batch[2][:, :7], batch[3][:, :7], None, cfg=cfg)
    with pytest.raises(ValueError, match="tf_decoder"):
        Tacotron(dataclasses.replace(cfg.model, tf_decoder="unrolled"), device="cpu")
