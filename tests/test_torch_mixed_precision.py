"""bf16 compute (``compute_dtype="bfloat16"``) in the port vs the JAX package
on the CPU: each module with flax ``dtype=jnp.bfloat16``, the teacher-forced
``Tacotron`` forward and its loss gradients for both decoder forms with and
without remat, one ``train_step``, and the contract of JAX's own
``tests/unit/test_mixed_precision.py`` (outputs, parameters, gradients and
Adam moments f32; the loss falls; bf16 stays close to f32).

The same numpy inputs and JAX-initialised f32 parameters (moved across with
``weights.from_flax``) go through both; batch-norm statistics are
randomised so inference normalisation is exercised. Prenet dropout is 0:
JAX's PRNG cannot be reproduced.

JAX is compiled with ``xla_allow_excess_precision`` off (``strict``): by
default XLA:CPU keeps a fusion's bf16 intermediates in f32, so it would
round where it happens to fuse, not where the JAX code says (measured
here: the bf16 ``tanh(keys + q)`` comes out unrounded), and the port rounds
where the code says.

Tolerances: a single module's output within 2 bf16 ulps of its peak
(2 * 2^-8 * max|y|): both sides round at the same points, so only a bf16
rounding that an f32 sum's last bit flips can differ (measured: none; every
module within 1.5e-7 of its peak, Dense and Prenet bit-identical). The
whole model and its gradients carry such flips along; their tolerances are
the errors measured here with 2x headroom, stated per check, with the
``memory_proj`` gradient (the attention keys' weight, whose gradient is the
bf16 sum of every decoder step's) on its own.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from tacotron_tpu import ops as jops
from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu.models.encoder import Encoder as JaxEncoder
from tacotron_tpu.models.postnet import PostNet as JaxPostNet
from tacotron_tpu.ops.gru import GRUCell as JGRUCell, _ScanGRU as JScanGRU
from tacotron_tpu.train.loss import tacotron_loss as jax_loss
from tacotron_tpu.train.step import (create_train_state as jax_create_train_state,
                                     make_train_step as jax_make_train_step)
from tacotron_tpu_torch.config import Config, ModelConfig
from tacotron_tpu_torch.models.encoder import Encoder
from tacotron_tpu_torch.models.postnet import PostNet
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.ops import modules as tmod
from tacotron_tpu_torch.ops.attention import BahdanauAttention
from tacotron_tpu_torch.ops.cbhg import CBHG
from tacotron_tpu_torch.ops.gru import GRUCell, _ScanGRU, bidirectional_gru
from tacotron_tpu_torch.train import create_train_state, train_step
from tacotron_tpu_torch.train.loss import tacotron_loss
from tacotron_tpu_torch.train.schedule import learning_rate
from tacotron_tpu_torch.weights import from_flax, init_params, split_state, to_flax

BF16 = jnp.bfloat16
CD = torch.bfloat16
ULP2 = 2 * 2.0 ** -8                 # two bf16 ulps, relative to the peak
LENGTHS = np.array([9, 6, 4])
T_OUT = 20                           # 4 decoder steps at r 5
FRAME_LEN = np.array([20, 15, 10])


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _randomise_stats(variables, seed):
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


def strict(fn, *args):
    """``fn(*args)`` jitted with every bf16 rounding the JAX code writes: by
    default XLA:CPU keeps a fusion's bf16 intermediates in f32
    (``xla_allow_excess_precision``), so where it rounds depends on how it
    fuses; the port rounds where the code says, as eager JAX does."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _rel_err(got, want):
    """max |got - want| over max |want|, both taken in f32."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tiny_model(**over):
    c = jax_get_config("tiny_cpu")
    return dataclasses.replace(c.model, **{**dict(vocab_size=32, prenet_dropout=0.0,
                                                  compute_dtype="bfloat16"), **over})


# (JAX module, port module, inputs, call kwargs, tolerance over the peak,
# output dtype of both); tolerances above 2 ulps: measured error x 2
def _cases():
    lengths = np.array([9, 5, 7])
    cbhg = dict(k=4, bank_channels=8, proj_dims=(16, 12), highway_layers=2,
                highway_dim=16, gru_dim=8, train=False)
    return {
        "dense": (nn.Dense(12, dtype=BF16), tmod.Dense(8, 12, compute_dtype=CD),
                  (_x((4, 8)),), {}, ULP2),
        "prenet": (jops.Prenet((32, 16), dropout=0.5, deterministic=True, dtype=BF16),
                   tmod.Prenet(24, (32, 16), dropout=0.5, deterministic=True,
                               compute_dtype=CD), (_x((4, 24)),), {}, ULP2),
        "conv_bank_packed": (jops.ConvBank(4, 8, train=False, dtype=BF16),
                             tmod.ConvBank(4, 6, 8, compute_dtype=CD),
                             (_x((2, 11, 6)),), {}, ULP2),
        "conv_projection": (jops.Conv1dProjection((12, 6), train=False, dtype=BF16),
                            tmod.Conv1dProjection(10, (12, 6), compute_dtype=CD),
                            (_x((2, 9, 10)),), {}, ULP2),
        "highway": (jops.HighwayStack(3, 16, dtype=BF16),
                    tmod.HighwayStack(16, 3, 16, compute_dtype=CD),
                    (_x((2, 7, 16)),), {}, ULP2),
        "highway_resize": (jops.HighwayStack(2, 16, dtype=BF16),
                           tmod.HighwayStack(10, 2, 16, compute_dtype=CD),
                           (_x((2, 7, 10)),), {}, ULP2),
        "gru_cell": (JGRUCell(16, dtype=BF16), GRUCell(8, 16, compute_dtype=CD),
                     (_x((3, 16), 1), _x((3, 8), 2)), {}, ULP2),
        "scan_fwd": (JScanGRU(16, dtype=BF16), _ScanGRU(8, 16, compute_dtype=CD),
                     (_x((3, 9, 8)),), {}, ULP2),
        "scan_reverse_lengths": (JScanGRU(16, reverse=True, dtype=BF16),
                                 _ScanGRU(8, 16, reverse=True, compute_dtype=CD),
                                 (_x((3, 9, 8)),), {"lengths": lengths}, ULP2),
        "bigru_stacked_lengths": (jops.bidirectional_gru(16, dtype=BF16),
                                  bidirectional_gru(8, 16, compute_dtype=CD),
                                  (_x((3, 9, 8)),), {"lengths": lengths}, ULP2),
        "cbhg_lengths": (jops.CBHG(**cbhg, dtype=BF16),
                         CBHG(12, 4, 8, (16, 12), 2, 16, 8, compute_dtype=CD),
                         (_x((3, 9, 12)),), {"lengths": lengths}, ULP2),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax_bf16(name):
    jm, tm, inputs, kw, tol = CASES[name]
    jin = [jnp.asarray(a) for a in inputs]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    variables = _randomise_stats(jax.jit(jm.init)(jax.random.PRNGKey(7), *jin, **jkw), 3)
    want = strict(lambda v, *xs: jm.apply(v, *xs, **jkw), variables, *jin)
    want = want[0] if isinstance(want, tuple) else want
    tm = _port(tm, variables)
    with torch.no_grad():
        got = tm(*[torch.from_numpy(a) for a in inputs],
                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    got = got[0] if isinstance(got, tuple) else got
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    err = _rel_err(got, want)
    assert err <= tol, f"{name}: max abs err {err:.3e} of the peak, tolerance {tol:.3e}"


@pytest.mark.parametrize("energy", ["xla", "fused"])
def test_attention_matches_jax_bf16(energy):
    jm = jops.BahdanauAttention(dim=24, dtype=BF16, energy=energy)
    q, mem = _x((2, 12)), _x((2, 11, 20), 1)
    mask = np.arange(11)[None, :] < np.array([11, 6])[:, None]
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(mem), method=jm.full_step)
    want = strict(lambda *a: jm.apply(*a, method=jm.full_step), v, jnp.asarray(q),
                  jnp.asarray(mem), jnp.asarray(mask))
    tm = _port(BahdanauAttention(12, 24, memory_dim=20, energy=energy, compute_dtype=CD), v)
    with torch.no_grad():
        keys = tm.process_memory(torch.from_numpy(mem))
        got = tm.full_step(torch.from_numpy(q), torch.from_numpy(mem), torch.from_numpy(mask))
    assert keys.dtype == CD
    for g, w, name in zip(got, want, ("context", "alignment")):
        assert g.dtype == torch.float32
        err = _rel_err(g, w)
        assert err <= ULP2, f"{name}: {err:.3e} of the peak"
    assert float(got[1][1, 6:].max()) < 1e-6


@pytest.mark.parametrize("part", ["encoder", "postnet"])
def test_encoder_and_postnet_match_jax_bf16(part):
    jcfg = _tiny_model()
    pcfg = Config.from_json(_jcfg().to_json()).model
    if part == "encoder":
        jm, tm = JaxEncoder(jcfg, train=False), Encoder(pcfg, device="cpu")
        text = np.array([[3, 5, 7, 2, 9, 4, 1, 8, 6], [8, 1, 6, 2, 0, 0, 0, 0, 0]])
        args, lengths = (text,), np.array([9, 4])
    else:
        jm, tm = JaxPostNet(jcfg, train=False), PostNet(pcfg, device="cpu")
        args, lengths = (np.abs(_x((2, 12, 80), 4)),), np.array([12, 7])
    variables = _randomise_stats(
        jax.jit(jm.init)({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                         *args, lengths), 5)
    want = strict(lambda *a: jm.apply(*a, rngs={"dropout": jax.random.PRNGKey(3)}),
                  variables, *args, lengths)
    with torch.no_grad():
        got = _port(tm, variables)(*map(torch.from_numpy, args), torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    err = _rel_err(got, want)
    assert err <= ULP2, f"{part}: max abs err {err:.3e} of the peak"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _jcfg(**model):
    c = jax_get_config("tiny_cpu")
    return dataclasses.replace(c, model=_tiny_model(**model))


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
    s = dict(jstate=state, v=v, text=text, mel=mel, linear=linear)
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
        return total, out

    (total, out), grads = strict(jax.value_and_grad(loss_fn, has_aux=True), s["v"]["params"])
    return dict(total=float(total), out=[np.asarray(x) for x in out], grads=_flat(grads))


def _port_model(s, **model):
    cfg = Config.from_json(_jcfg(**model).to_json())
    m = Tacotron(cfg.model, device="cpu")
    params, stats = from_flax(s["v"])
    m.load_state_dict({**params, **stats}, strict=True)
    return m.train()


def _port_grads(m, s):
    out = m(torch.from_numpy(s["text"]), torch.from_numpy(LENGTHS),
            gt_mel=torch.from_numpy(s["mel"]))
    total, _ = tacotron_loss(out.mel, out.linear, torch.from_numpy(s["mel"]),
                             torch.from_numpy(s["linear"]))
    total.backward()
    grads = {k: p.grad for k, p in m.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    return out, total, _flat(to_flax(grads)["params"])


# Measured on this setup (scan / hoisted, remat alike), each over its peak,
# x 2: mel [2.8e-4 / 0], linear [8.9e-3 / 3.0e-3], alignments [1.1e-7 /
# 1.1e-7], the loss (relative) [2.1e-5 / 3.4e-7]; the whole gradient
# (relative L2) [2.5e-2 / 8.5e-3], its worst parameter [7.8e-2 / 6.6e-2]:
# a bf16 rounding that an f32 sum's last bit flips moves the train-mode
# batch norms' statistics and the signs of the L1 terms. The memory_proj
# gradient, the bf16 sum of every decoder step's keys gradient, on its
# own: [1.9e-2 / 7.5e-3].
FWD_TOL = {"mel": 6e-4, "linear": 2e-2, "alignments": 3e-7}
LOSS_RTOL = 5e-5
GRAD_TOL = {"whole": 5e-2, "worst_parameter": 0.16, "memory_proj": 4e-2}


@pytest.mark.parametrize("form,remat", [("scan", False), ("scan", True),
                                        ("hoisted", False), ("hoisted", True)])
def test_tacotron_forward_and_grads_match_jax_bf16(setup, form, remat):
    s, want = setup, setup["jax"][form]
    m = _port_model(s, tf_decoder=form, remat_decoder=remat, attention_energy="fused")
    out, total, grads = _port_grads(m, s)
    for g, w, name in zip(out, want["out"], ("mel", "linear", "alignments")):
        assert g.dtype == torch.float32, name
        err = _rel_err(g, w)
        assert err <= FWD_TOL[name], f"{name}: {err:.3e} of the peak"
    assert total.item() == pytest.approx(want["total"], rel=LOSS_RTOL)
    assert sorted(grads) == sorted(want["grads"])
    ks = sorted(grads)
    g, w = (np.concatenate([x[k].ravel() for k in ks]) for x in (grads, want["grads"]))
    whole = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    assert whole <= GRAD_TOL["whole"], f"whole gradient: {whole:.3e} (relative L2)"
    errs = {k: _rel_err(grads[k], want["grads"][k]) for k in ks}
    mp = errs.pop("memory_proj/kernel")
    assert mp <= GRAD_TOL["memory_proj"], f"memory_proj gradient: {mp:.3e} of its peak"
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL["worst_parameter"], f"{worst}: {errs[worst]:.3e} of its peak"


def test_train_step_matches_jax_bf16(setup):
    """One whole step of the training main path's form (hoisted, fused,
    remat, masked loss) against JAX's jitted step. Measured x 2: losses
    [1.1e-6 relative], grad_norm [1.1e-3], alignments [1.1e-7 of the peak],
    batch statistics [9.5e-8 of each one's peak]. Adam's first step moves a
    weight by lr g / (|g| + eps): by lr sign(g) where JAX's step is well
    conditioned (|g| >> eps, a step of at least 0.999 lr). There the port's
    weight equals JAX's within 2e-6, or the two gradients differ in sign
    (a move of 2 lr; [23 of 379,838 entries], a gradient within the bf16
    noise of 0) or the port's |g| is near eps ([13])."""
    s = setup
    jcfg = _jcfg(tf_decoder="hoisted", attention_energy="fused", remat_decoder=True)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, mask_padding=True))
    batch = (s["text"], LENGTHS, s["mel"], s["linear"], FRAME_LEN)
    j_state0 = jax.tree_util.tree_map(jnp.array, s["jstate"])   # the step donates it
    j_state, j_metrics, j_align = jax_make_train_step(jcfg).lower(j_state0, *batch).compile(
        compiler_options={"xla_allow_excess_precision": False})(j_state0, *batch)

    cfg = Config.from_json(jcfg.to_json())
    state = create_train_state(cfg, seed=0, device="cpu")
    params, stats = from_flax(s["v"])
    state.model.load_state_dict({**params, **stats}, strict=True)
    state, metrics, align = train_step(state, *map(torch.from_numpy, batch), cfg=cfg)
    for k in ("mel_loss", "linear_loss", "total_loss"):
        assert float(metrics[k]) == pytest.approx(float(j_metrics[k]), rel=5e-6), k
    assert float(metrics["grad_norm"]) == pytest.approx(float(j_metrics["grad_norm"]), rel=2.5e-3)
    assert _rel_err(align, j_align) <= FWD_TOL["alignments"]
    got = _flat(to_flax(*map(dict, (state.model.named_parameters(),
                                    state.model.named_buffers()))))
    want = _flat(jax.tree_util.tree_map(np.asarray, {"params": j_state.params,
                                                     "batch_stats": j_state.batch_stats}))
    assert sorted(got) == sorted(want)
    old = _flat({"params": s["v"]["params"]})
    lr, n_well, n_flip, n_near_eps = learning_rate(cfg.train, 0), 0, 0, 0
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        if not k.startswith("params"):
            assert _rel_err(got[k], w) <= 2e-7, k
            continue
        assert np.abs(got[k] - old[k]).max() <= lr + 1e-6, k
        well = np.abs(w - old[k]) >= 0.999 * lr
        diff = np.abs(got[k] - w)[well]
        flip = diff >= 1.9 * lr
        n_well += diff.size
        n_flip += int(flip.sum())
        n_near_eps += int(((diff > 2e-6) & ~flip).sum())
    assert n_flip <= 1.2e-4 * n_well and n_near_eps <= 7e-5 * n_well, (n_flip, n_near_eps, n_well)


def _batch(cfg, b=2, t_in=10):
    rng = np.random.default_rng(0)
    t_out = 4 * cfg.model.r
    arrs = (rng.integers(1, 30, (b, t_in)), np.full((b,), t_in),
            rng.uniform(0, 1, (b, t_out, cfg.model.n_mels)).astype(np.float32),
            rng.uniform(0, 1, (b, t_out, cfg.model.n_freq)).astype(np.float32),
            np.full((b,), t_out))
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("form", ["scan", "hoisted"])
def test_bf16_train_step_runs_and_stays_f32(form):
    """JAX's contract (tests/unit/test_mixed_precision.py): four bf16 steps
    with finite, falling losses; parameters, gradients and Adam moments
    f32."""
    cfg = Config.from_json(_jcfg(tf_decoder=form, remat_decoder=True,
                                 attention_energy="fused").to_json())
    assert cfg.model.cdtype == torch.bfloat16
    state = create_train_state(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    losses = []
    for _ in range(4):
        state, m, align = train_step(state, *batch, cfg=cfg)
        losses.append(float(m["total_loss"]))
        assert align.dtype == torch.float32
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for p in state.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    moments = [v for st in state.opt.state.values() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(v.dtype == torch.float32 for v in moments)


def test_bf16_close_to_f32():
    """The drift rule of JAX's test: on the same weights and batch the bf16
    teacher-forced mel is within 0.1 of the f32 mel's mean magnitude plus
    0.05, in mean absolute difference; outputs f32 and finite; the float32
    default inserts no cast."""
    assert ModelConfig().compute_dtype == "float32" and ModelConfig().cdtype is None
    cfg32 = Config.from_json(_jcfg(compute_dtype="float32").to_json())
    cfg16 = Config.from_json(_jcfg().to_json())
    m32 = init_params(Tacotron(cfg32.model, device="cpu"), seed=0)
    m16 = init_params(Tacotron(cfg16.model, device="cpu"), seed=0)
    # bf16 compute changes no parameter: the same seeded f32 weights
    params16, params32 = split_state(m16)[0], split_state(m32)[0]
    assert sorted(params16) == sorted(params32)
    assert all(p.dtype == torch.float32 and torch.equal(p, params32[k])
               for k, p in params16.items())
    text, lengths, mel = _batch(cfg16)[:3]
    with torch.no_grad():
        o32 = m32.train()(text, lengths, gt_mel=mel)
        o16 = m16.train()(text, lengths, gt_mel=mel)
    assert o16.mel.dtype == torch.float32 and o16.linear.dtype == torch.float32
    assert bool(torch.isfinite(o16.linear).all())
    scale = float(o32.mel.abs().mean()) + 1e-3
    err = float((o16.mel - o32.mel).abs().mean())
    assert err < 0.1 * scale + 0.05, (err, scale)
