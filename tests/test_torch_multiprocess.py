"""The parallel layer on several processes (``torch.distributed``, gloo on
the CPU) against the JAX package's mesh step and the port's one process.

One world of 2 ranks (``torch_launch``: a ``file://`` rendezvous under
``tmp_path``, a collective timeout of 60 s, and a parent that kills its
ranks after a hard wall) runs every task of ``ranks_main`` once; the tests
hold its results. The ranks import this module, so JAX is imported only
inside the tests. Config: ``tiny_cpu`` with vocab 32 and n_freq 260 (the
JAX TP test's, 260 dividing by 2), a global batch of 4 (2 rows a rank).

Tolerances, as ``tests/test_torch_train.py`` holds the one-process step:
against JAX's ``make_train_step(cfg, mesh)`` on a 2-device mesh (dropout
0): losses and ``grad_norm`` within 1e-5 (forwards), alignments atol
1e-5, gradients rtol 1e-4 + atol 1e-6, batch statistics atol 1e-6, updated
parameters atol 2e-6 except where Adam's first step turns rounding noise
in a near-zero gradient into up to lr (at most 1 in 10^4 entries, each
still a step of at most lr). 2 ranks against 1 with dropout 0.5 (the masks
drawn for the global batch), and a model-parallel step (model 2) against
1 rank: losses rel 1e-5, batch statistics atol 1e-6, parameters by the
same rule after the first step. Checkpoints: bit-identical.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from tacotron_tpu_torch.config import Config, MeshConfig, get_config
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.infer import Synthesizer
from tacotron_tpu_torch.parallel import make_mesh, multihost, shard_batch
from tacotron_tpu_torch.parallel.sharding import full_tensor, local_slice
from tacotron_tpu_torch.train import checkpoint, create_train_state, make_train_step
from tacotron_tpu_torch.train.schedule import learning_rate
from tacotron_tpu_torch.weights import from_flax, to_flax

import torch_launch

HERE = os.path.dirname(os.path.abspath(__file__))
B, T_IN, T_OUT = 4, 9, 20
PROMPTS = ["hello world", "abc", "synthesis on a mesh"]      # 3 -> pads to 4
SYNTH_KW = dict(n_steps=6, gl_iters=3, peak_normalize=False)
# an STFT whose n_freq is the model's 260
SYNTH_AUDIO = dataclasses.replace(get_config("tiny_cpu").audio, n_fft=518, win_length=400,
                                  hop_length=100, griffin_lim_iters=3)


def config(dropout=0.5, model_parallel=1, **train) -> Config:
    c = get_config("tiny_cpu")
    return dataclasses.replace(
        c, model=dataclasses.replace(c.model, vocab_size=32, n_freq=260,
                                     prenet_dropout=dropout),
        mesh=MeshConfig(model_parallel_size=model_parallel),
        train=dataclasses.replace(c.train, batch_size=B, **train))


def batch():
    """The global batch: ids padded after each length, frame lengths for
    the masked loss."""
    rng = np.random.default_rng(7)
    lens = np.array([9, 6, 4, 7])
    text = rng.integers(1, 30, (B, T_IN))
    text[np.arange(T_IN)[None, :] >= lens[:, None]] = 0
    mel = rng.uniform(0, 1, (B, T_OUT, 80)).astype(np.float32)
    linear = rng.uniform(0, 1, (B, T_OUT, 260)).astype(np.float32)
    return text, lens, mel, linear, np.array([20, 15, 10, 18])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.array(v)})
    return out


def _load_full(state, params, stats):
    """Full parameters into a (possibly sharded) state's model."""
    m = state.model
    m.load_state_dict({**{k: local_slice(m, k, v) for k, v in params.items()}, **stats})


def _snapshot(state):
    """Full parameters and statistics in flax's layout, flattened."""
    m = state.model
    params = {k: full_tensor(m, k, p.detach()) for k, p in m.named_parameters()}
    return _flat(to_flax(params, dict(m.named_buffers())))


def _grads(state):
    m = state.model
    return _flat(to_flax({k: full_tensor(m, k, p.grad)
                          for k, p in m.named_parameters()})["params"])


def _run_steps(state, cfg, mesh, n_steps):
    """n_steps on this rank's rows of ``batch()``: metrics per step, the
    alignments, gradients and full parameters after the first."""
    rows = slice(None) if mesh is None else slice(
        mesh.data_index * B // mesh.data_size, (mesh.data_index + 1) * B // mesh.data_size)
    arrays = [torch.from_numpy(np.ascontiguousarray(a[rows])) for a in batch()]
    step = make_train_step(cfg, mesh)
    out = {"metrics": []}
    for i in range(n_steps):
        state, metrics, align = step(state, *arrays)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out.update(align=align.numpy(), grads=_grads(state), first=_snapshot(state))
    out["last"] = _snapshot(state)
    return state, out


# ---- what each rank runs ----------------------------------------------------

def _asserts(rank):
    """Each check with agreeing inputs, then with disagreeing ones: the
    message raised on this rank, or None."""
    same = (np.zeros((2, 3), np.int32), np.ones(2, np.float16))
    multihost.assert_same_step(5)
    multihost.assert_same_shapes(same)
    out = {}
    cases = {
        "step": lambda: multihost.assert_same_step(rank),
        "shapes": lambda: multihost.assert_same_shapes((np.zeros((2, 3 + rank), np.int32),)),
        "shard_shapes": lambda: multihost.assert_shard_consistency(
            (np.zeros((2, 3 + rank), np.int32),)),
        "shard_duplicate": lambda: multihost.assert_shard_consistency(same),
    }
    for name, check in cases.items():
        try:
            check()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    # distinct contents of one shape pass
    multihost.assert_shard_consistency((np.full((2, 3), rank, np.int32),))
    return out


def ranks_main(rank, world, flax, ckpt_dir):
    torch.manual_seed(0)
    res = {"asserts": _asserts(rank)}
    params, stats = from_flax(flax)
    for mask in (False, True):                       # against JAX's mesh step
        cfg = config(dropout=0.0, mask_padding=mask, loss_linear_weight=0.5)
        mesh = make_mesh(cfg.mesh, platform="cpu")
        state = create_train_state(cfg, mesh=mesh)
        _load_full(state, params, stats)
        res[f"jax_mask{int(mask)}"] = _run_steps(state, cfg, mesh, 1)[1]
    cfg = config()                                    # dropout 0.5: against 1 rank
    mesh = make_mesh(cfg.mesh, platform="cpu")
    res["dropout"] = _run_steps(create_train_state(cfg, seed=3, mesh=mesh), cfg, mesh, 2)[1]
    cfg = config(model_parallel=2)                    # tensor parallel
    mesh = make_mesh(cfg.mesh, platform="cpu")
    state, res["tp"] = _run_steps(create_train_state(cfg, seed=3, mesh=mesh), cfg, mesh, 2)
    res["tp"]["shapes"] = {k: tuple(p.shape) for k, p in state.model.named_parameters()
                           if k in state.model.tp_shards}
    res["tp"]["mesh"] = (mesh.data_size, mesh.model_size)
    # a collective save of the sharded state; restored into a fresh one
    res["saved"] = checkpoint.save(ckpt_dir, 2, state, cfg.train)
    want = checkpoint.state_leaves(state, cfg.train)
    fresh = create_train_state(cfg, seed=11, mesh=mesh)
    fresh, step = checkpoint.restore(ckpt_dir, fresh, cfg.train)
    got = checkpoint.state_leaves(fresh, cfg.train)
    res["restore"] = {"step": step, "paths_equal": [p for p, _ in got] == [p for p, _ in want],
                      "bit_equal": all(np.array_equal(a, b) and a.dtype == b.dtype
                                       for (_, a), (_, b) in zip(got, want))}
    # data-parallel synthesis, and its refusals
    cfg = config(dropout=0.0)
    cfg = dataclasses.replace(cfg, audio=SYNTH_AUDIO)
    mesh = make_mesh(cfg.mesh, platform="cpu")
    vocab = Vocab.build(["the quick brown fox jumps over a lazy dog"])
    synth = Synthesizer(cfg, params, stats, vocab, mesh=mesh)
    res["synth"] = synth(PROMPTS, **SYNTH_KW)
    ee = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, early_exit=True))
    res["synth_refusals"] = {}
    for name, (c, kw) in {"fused": (cfg, dict(fused=True)), "early_exit": (ee, {})}.items():
        try:
            Synthesizer(c, params, stats, vocab, mesh=mesh, **kw)
            res["synth_refusals"][name] = None
        except ValueError as e:
            res["synth_refusals"][name] = str(e)
    return res


# ---- the tests ------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    from tacotron_tpu.train.step import create_train_state as jax_create_train_state

    root = tmp_path_factory.mktemp("world2")
    jcfg = _jax_cfg(config(dropout=0.0))
    jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(0))
    flax = jax.tree_util.tree_map(np.asarray, {"params": jstate.params,
                                               "batch_stats": jstate.batch_stats})
    ranks = torch_launch.run("test_torch_multiprocess:ranks_main", 2,
                             {"flax": flax, "ckpt_dir": str(root / "ckpt")},
                             workdir=root / "run", timeout_s=240, extra_path=[HERE])
    return dict(ranks=ranks, flax=flax, jstate=jstate, ckpt=str(root / "ckpt"))


def _jax_cfg(cfg):
    from tacotron_tpu.config import Config as JaxConfig

    return JaxConfig.from_json(cfg.to_json())


def _hold_params(got, want, old, lr, n_steps=1):
    """Updated parameters within 2e-6, except entries where the first Adam
    step turned noise in a near-zero gradient into up to lr: those must
    have moved less than 0.99 lr per step in ``want`` and be rare."""
    n_off = n_all = 0
    for k, w in want.items():
        if not k.startswith("params"):
            np.testing.assert_allclose(got[k], w, atol=1e-6, err_msg=k)
            continue
        off = np.abs(got[k] - w) > 2e-6
        n_off, n_all = n_off + int(off.sum()), n_all + w.size
        assert (np.abs(w - old[k])[off] < 0.99 * lr * n_steps).all(), k
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def test_asserts_raise_on_every_rank(setup):
    want = {"step": "step divergence across hosts",
            "shapes": "hosts disagree on batch shapes (bucket divergence)",
            "shard_shapes": "hosts disagree on batch shapes (bucket divergence)",
            "shard_duplicate": "duplicate batch content across hosts (per-host data "
                               "sharding broken)"}
    for rank in setup["ranks"]:
        for name, msg in want.items():
            assert rank["asserts"][name] is not None and msg in rank["asserts"][name], name


@pytest.mark.parametrize("mask", [False, True], ids=["mean", "mask_padding"])
def test_dp_step_matches_jax_mesh_step(setup, mask):
    import jax
    import jax.numpy as jnp
    import optax

    from tacotron_tpu.models import Tacotron as JaxTacotron
    from tacotron_tpu.parallel import make_mesh as jax_make_mesh, shard_batch
    from tacotron_tpu.train.loss import tacotron_loss as jax_loss
    from tacotron_tpu.train.step import make_train_step as jax_make_train_step

    cfg = config(dropout=0.0, mask_padding=mask, loss_linear_weight=0.5)
    jcfg = _jax_cfg(cfg)
    arrays = batch()
    mesh = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:2])
    state0 = jax.tree_util.tree_map(jnp.array, setup["jstate"])   # the step donates it
    with mesh:
        j_state, j_metrics, j_align = jax_make_train_step(jcfg, mesh)(
            state0, *shard_batch(tuple(map(jnp.asarray, arrays)), mesh, jcfg.mesh))
    model = JaxTacotron(jcfg.model, train=True)
    v = setup["flax"]

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                             arrays[0], arrays[1], gt_mel=arrays[2],
                             rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        return jax_loss(out.mel, out.linear, arrays[2], arrays[3], arrays[4],
                        mask_padding=mask, linear_weight=0.5)[0]

    grads = jax.jit(jax.grad(loss_fn))(v["params"])
    grads, _ = optax.clip_by_global_norm(cfg.train.grad_clip_norm).update(grads, None)
    want_grads = _flat(jax.tree_util.tree_map(np.asarray, grads))

    ranks = [r[f"jax_mask{int(mask)}"] for r in setup["ranks"]]
    for r in ranks:
        for k in ("mel_loss", "linear_loss", "total_loss", "grad_norm"):
            assert r["metrics"][0][k] == pytest.approx(float(j_metrics[k]), abs=1e-5), k
        assert sorted(r["grads"]) == sorted(want_grads)
        for k, w in want_grads.items():
            np.testing.assert_allclose(r["grads"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
        want = _flat(jax.tree_util.tree_map(np.asarray, {"params": j_state.params,
                                                         "batch_stats": j_state.batch_stats}))
        _hold_params(r["first"], want, _flat({"params": v["params"]}),
                     learning_rate(cfg.train, 0))
    align = np.concatenate([r["align"] for r in ranks])          # each rank's rows
    np.testing.assert_allclose(align, np.asarray(j_align), atol=1e-5)


def _one_rank(cfg, n_steps):
    state = create_train_state(cfg, seed=3, device="cpu")
    return _run_steps(state, cfg, None, n_steps)[1]


@pytest.mark.parametrize("case", ["dropout", "tp"])
def test_two_ranks_equal_one(setup, case):
    """Dropout 0.5 on a (2, 1) mesh, and the model-parallel (1, 2) mesh,
    against one process on the same rows, batch statistics included."""
    cfg = config()
    want = _one_rank(cfg, 2)
    lr = learning_rate(cfg.train, 0)
    old = _snapshot(create_train_state(cfg, seed=3, device="cpu"))
    for r in setup["ranks"]:
        got = r[case]
        for g, w in zip(got["metrics"], want["metrics"]):
            for k in ("mel_loss", "linear_loss", "total_loss", "grad_norm"):
                assert g[k] == pytest.approx(w[k], rel=1e-5), k
        _hold_params(got["first"], want["first"], old, lr)
        for k in want["last"]:
            if not k.startswith("params"):
                np.testing.assert_allclose(got["last"][k], want["last"][k], atol=1e-6,
                                           err_msg=k)
    if case == "tp":
        r0 = setup["ranks"][0]["tp"]
        assert r0["mesh"] == (1, 2)
        # the wide projection and the embedding really are split
        assert r0["shapes"] == {"postnet.linear_proj.weight": (130, 64),
                                "postnet.linear_proj.bias": (130,),
                                "encoder.embed.embedding": (16, 64)}


def test_tp_checkpoint_round_trip_and_jax_restore(setup):
    """Only rank 0 writes; the sharded state reads back bit for bit on the
    ranks, and the JAX package restores the file into its own state."""
    import jax

    from tacotron_tpu.train import checkpoint as jax_checkpoint
    from tacotron_tpu.train.step import create_train_state as jax_create_train_state

    r0, r1 = setup["ranks"]
    assert r0["saved"] is not None and r1["saved"] is None
    assert os.listdir(setup["ckpt"]) == ["step_2"]
    for r in (r0, r1):
        assert r["restore"] == {"step": 2, "paths_equal": True, "bit_equal": True}
    jcfg = _jax_cfg(config(model_parallel=2))
    template = jax_create_train_state(jcfg, jax.random.PRNGKey(5))
    restored, step = jax_checkpoint.restore(setup["ckpt"], template)
    assert step == 2
    got = _flat(jax.tree_util.tree_map(np.asarray, {"params": restored.params,
                                                    "batch_stats": restored.batch_stats}))
    for k, w in r0["tp"]["last"].items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_mesh_synthesis_matches_one_process(setup):
    cfg = config(dropout=0.0)
    cfg = dataclasses.replace(cfg, audio=SYNTH_AUDIO)
    vocab = Vocab.build(["the quick brown fox jumps over a lazy dog"])
    params, stats = from_flax(setup["flax"])
    ref = Synthesizer(cfg, params, stats, vocab, device="cpu")(PROMPTS, **SYNTH_KW)
    for r in setup["ranks"]:
        got = r["synth"]
        assert got["wavs"].shape == ref["wavs"].shape        # pad row cut off
        np.testing.assert_allclose(got["mel"], ref["mel"], atol=1e-5)
        np.testing.assert_allclose(got["linear"], ref["linear"], atol=1e-5)
        np.testing.assert_allclose(got["wavs"], ref["wavs"], atol=1e-4)
        np.testing.assert_array_equal(got["end_frames"], ref["end_frames"])
        assert "drop fused=True" in r["synth_refusals"]["fused"]
        assert "early-exit/trim" in r["synth_refusals"]["early_exit"]


def test_one_process_mesh_is_the_plain_step():
    """Without a process group the mesh has size 1 and no groups, and its
    step is the plain step, bit for bit."""
    cfg = config()
    mesh = make_mesh(cfg.mesh, platform="cpu")
    assert (mesh.size, mesh.data_group, mesh.model_group) == (1, None, None)
    a = _run_steps(create_train_state(cfg, seed=3, mesh=mesh), cfg, mesh, 2)[1]
    b = _one_rank(cfg, 2)
    assert a["metrics"] == b["metrics"]
    for k in b["last"]:
        np.testing.assert_array_equal(a["last"][k], b["last"][k], err_msg=k)
    # the loader's shard goes to the rank's device as it is
    moved = shard_batch(batch(), mesh)
    assert all(isinstance(t, torch.Tensor) and t.device == mesh.device for t in moved)
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(moved, batch()))
    with pytest.raises(ValueError, match="not divisible by model_parallel_size=2"):
        make_mesh(MeshConfig(model_parallel_size=2), platform="cpu")
    with pytest.raises(ValueError, match="not created for this mesh"):
        make_train_step(cfg, mesh)(create_train_state(cfg, device="cpu"),
                                   *map(torch.from_numpy, batch()))
