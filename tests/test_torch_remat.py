"""``remat_policy="save_attn"`` against the JAX package on the CPU.

JAX runs the policy in three cases (``tacotron_tpu/models/decoder.py``): the
``scan`` form ignores it, the hoisted form with the ``fused`` energy names
nothing and so saves nothing, and the hoisted form with the ``xla`` energy
saves each step's (B, T_in, attention_dim) tanh. In every case the values
are ``"all"``'s. Both sides start from one JAX initialisation (``tiny_cpu``,
prenet dropout 0) moved across with ``weights.from_flax``, on a batch made
with numpy from a seed, with ``remat_decoder`` on.

Tolerances: the loss rtol 1e-5 and every parameter gradient rtol 1e-4 plus
atol 1e-6 against JAX's jitted ``save_attn`` step (the repository's rule for
gradients; tests/test_torch_train.py holds ``"all"`` the same way); against
the port's own ``"all"`` the loss and every gradient are the same bits. The
kept tensors are counted with ``torch.autograd.graph.saved_tensors_hooks``:
the recomputed regions pack nothing into the outer hooks, so a tensor
counted there is one autograd keeps until the backward pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu.train.loss import tacotron_loss as jax_loss
from tacotron_tpu.train.step import create_train_state as jax_create_train_state
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.train.loss import tacotron_loss
from tacotron_tpu_torch.weights import from_flax, to_flax

LENGTHS = np.array([9, 6, 4])
T_OUT = 20                                    # 4 decoder steps at r 5
CASES = [("scan", "xla"), ("hoisted", "fused"), ("hoisted", "xla")]


def _jcfg(**model):
    c = jax_get_config("tiny_cpu")
    return dataclasses.replace(c, model=dataclasses.replace(
        c.model, vocab_size=32, prenet_dropout=0.0, **model))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


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
    return dict(v=v, text=text, mel=mel, linear=linear)


def _jax_loss_grads(s, **model):
    jm = JaxTacotron(_jcfg(**model).model, train=True)

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": s["v"]["batch_stats"]},
                          s["text"], LENGTHS, gt_mel=s["mel"],
                          rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        return jax_loss(out.mel, out.linear, s["mel"], s["linear"])[0]

    total, grads = jax.jit(jax.value_and_grad(loss_fn))(s["v"]["params"])
    return float(total), _flat(grads)


def _port_model(s, dtype="float32", **model):
    cfg = Config.from_json(_jcfg(compute_dtype=dtype, **model).to_json())
    m = Tacotron(cfg.model, device="cpu")
    params, stats = from_flax(s["v"])
    m.load_state_dict({**params, **stats}, strict=True)
    return m.train()


def _port_loss_grads(s, dtype="float32", hook=None, **model):
    """(loss, {flax path: gradient}); ``hook`` sees every tensor autograd
    keeps outside the recomputed regions during the forward."""
    m = _port_model(s, dtype, **model)
    with torch.autograd.graph.saved_tensors_hooks(hook or (lambda x: x), lambda x: x):
        out = m(torch.from_numpy(s["text"]), torch.from_numpy(LENGTHS),
                gt_mel=torch.from_numpy(s["mel"]))
        total, _ = tacotron_loss(out.mel, out.linear, torch.from_numpy(s["mel"]),
                                 torch.from_numpy(s["linear"]))
    total.backward()
    return total.detach(), _flat(to_flax({k: p.grad for k, p in m.named_parameters()})["params"])


@pytest.mark.parametrize("form,energy", CASES)
def test_save_attn_matches_jax_and_all(setup, form, energy):
    kw = dict(tf_decoder=form, attention_energy=energy, remat_decoder=True)
    want_total, want = _jax_loss_grads(setup, remat_policy="save_attn", **kw)
    total, grads = _port_loss_grads(setup, remat_policy="save_attn", **kw)
    assert total.item() == pytest.approx(want_total, rel=1e-5)
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    total_all, grads_all = _port_loss_grads(setup, remat_policy="all", **kw)
    assert torch.equal(total, total_all)
    for k, g in grads.items():
        np.testing.assert_array_equal(g, grads_all[k], err_msg=k)


def _kept_energy_shaped(s, dtype="float32", **model):
    """The distinct (B, T_in, attention_dim) tensors autograd keeps in one
    forward (one tensor packed twice, as the tanh's output and as the
    second region's input, is kept once)."""
    a = _jcfg().model.attention_dim
    shape = (len(LENGTHS), int(LENGTHS.max()), a)
    kept = {}

    def pack(x):
        if tuple(x.shape) == shape:
            kept[x.untyped_storage().data_ptr()] = x
        return x

    _port_loss_grads(s, dtype, hook=pack, **model)
    return list(kept.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form,energy", CASES)
def test_save_attn_keeps_the_tanh_only_where_jax_does(setup, form, energy, dtype):
    """Hoisted + xla keeps one (B, T_in, A) tanh per step beyond "all";
    the other cases keep what "all" keeps."""
    kw = dict(tf_decoder=form, attention_energy=energy, remat_decoder=True)
    base = _kept_energy_shaped(setup, dtype, remat_policy="all", **kw)
    kept = _kept_energy_shaped(setup, dtype, remat_policy="save_attn", **kw)
    steps = T_OUT // _jcfg().model.r
    if (form, energy) == ("hoisted", "xla"):
        assert len(kept) == len(base) + steps
        cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        tanh_like = [x for x in kept if x.dtype == cd and float(x.detach().abs().max()) <= 1.0]
        assert len(tanh_like) >= steps
    else:
        assert len(kept) == len(base)


def test_save_attn_without_remat_is_no_remat(setup):
    """JAX reads the policy only under ``remat_decoder``."""
    kw = dict(tf_decoder="hoisted", attention_energy="xla", remat_decoder=False)
    total, grads = _port_loss_grads(setup, remat_policy="save_attn", **kw)
    total_off, grads_off = _port_loss_grads(setup, remat_policy="all", **kw)
    assert torch.equal(total, total_off)
    for k, g in grads.items():
        np.testing.assert_array_equal(g, grads_off[k], err_msg=k)


def test_save_attn_bf16_is_all_bf16(setup):
    """In bf16 compute the kept tanh is bf16 and the values are "all"'s."""
    kw = dict(tf_decoder="hoisted", attention_energy="xla", remat_decoder=True)
    total, grads = _port_loss_grads(setup, "bfloat16", remat_policy="save_attn", **kw)
    total_all, grads_all = _port_loss_grads(setup, "bfloat16", remat_policy="all", **kw)
    assert torch.equal(total, total_all)
    for k, g in grads.items():
        np.testing.assert_array_equal(g, grads_all[k], err_msg=k)
