"""The port's TF1 converter (``tacotron_tpu_torch.utils.tf1_converter``)
against the JAX package's, on the CPU.

No TF1 checkpoint is in the repository, so the input is synthetic: a tiny
JAX model's own leaves renamed to TF1 names (``_tf1_names``, a copy of
``tests/unit/test_tf1_converter.py``'s helper), covering every NAME_TABLE
pattern. Both converters map it onto target trees whose every leaf is off
by 1 (so a leaf that is not overwritten shows): JAX's onto the flax tree,
the port's onto ``weights.to_flax`` of a port model holding the same
weights. They must give the same ``matched``, ``unmatched_tf``,
``unmatched_ours`` and ``errors`` and bit-equal leaves; the port model
loaded from the port's result (``weights.from_flax``) runs a teacher-forced
forward within atol 1e-5 (the project's forward tolerance) of JAX's model
loaded from JAX's. JAX's edge cases run through both converters, which
must agree on each.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_tpu.config import get_config as jax_get_config
from tacotron_tpu.models import Tacotron as JaxTacotron
from tacotron_tpu.utils import tf1_converter as jax_tf1
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.utils import tf1_converter as tf1
from tacotron_tpu_torch.weights import from_flax, split_state, to_flax

CONVERTERS = {"jax": jax_tf1, "port": tf1}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("tiny_cpu")
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, vocab_size=32, prenet_dropout=0.0))
    jm = JaxTacotron(jcfg.model, train=False)
    b, t_in, t_out = 2, 12, 4 * jcfg.model.r
    g = np.random.default_rng(0)
    text = g.integers(1, 32, (b, t_in)).astype(np.int32)
    lens = np.array([t_in, t_in - 3], np.int32)
    mel = g.random((b, t_out, jcfg.model.n_mels), dtype=np.float32)
    # jitted: an eager flax init of the whole model takes 3x as long
    variables = jax.jit(lambda t_, l_, m_: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, t_, l_, gt_mel=m_))(
        jnp.asarray(text), jnp.asarray(lens), jnp.asarray(mel))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # moved batch statistics, so that the moving mean and variance are checked too
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + g.random(a.shape, dtype=np.float32), variables["batch_stats"])
    cfg = Config.from_json(jcfg.to_json())
    model = Tacotron(cfg.model, device="cpu")
    p, s = from_flax(variables)
    model.load_state_dict({**p, **s}, strict=True)
    return jm, variables, model, (text, lens, mel)


def _plus_one(tree):
    return jax.tree_util.tree_map(lambda a: a + 1.0, tree)


def _tf1_names(params, batch_stats):
    """Invert the expected mapping: our leaves -> plausible TF1 names."""
    g = lambda t, p: np.asarray(_walk(t, p))
    tf = {}
    P = "model/inference"

    tf[f"{P}/embedding"] = g(params, "encoder/embed/embedding")
    for i in range(2):
        sfx = "" if i == 0 else f"_{i}"
        tf[f"{P}/prenet/dense{sfx}/kernel"] = g(params, f"encoder/prenet/fc{i}/kernel")
        tf[f"{P}/prenet/dense{sfx}/bias"] = g(params, f"encoder/prenet/fc{i}/bias")
        tf[f"{P}/decoder/prenet/dense{sfx}/kernel"] = g(params, f"decoder/cell/prenet/fc{i}/kernel")
        tf[f"{P}/decoder/prenet/dense{sfx}/bias"] = g(params, f"decoder/cell/prenet/fc{i}/bias")

    for scope, ours in (("encoder_cbhg", "encoder/cbhg"), ("post_cbhg", "postnet/cbhg")):
        bank = _walk(params, f"{ours}/bank")
        ks = sorted(int(k[4:]) for k in bank if k.startswith("conv"))
        for k in ks:
            tf[f"{P}/{scope}/conv1d_banks/num_{k}/conv1d/kernel"] = g(params, f"{ours}/bank/conv{k}/kernel")
            for field, (tree, leaf) in {
                "gamma": (params, "scale"), "beta": (params, "bias"),
                "moving_mean": (batch_stats, "mean"),
                "moving_variance": (batch_stats, "var"),
            }.items():
                tf[f"{P}/{scope}/conv1d_banks/num_{k}/batch_normalization/{field}"] = \
                    g(tree, f"{ours}/bank/bn{k}/bn/{leaf}")
        proj = _walk(params, f"{ours}/proj")
        n_proj = sum(1 for k in proj if k.startswith("proj"))
        for i in range(n_proj):
            tf[f"{P}/{scope}/conv1d_proj_{i}/conv1d/kernel"] = g(params, f"{ours}/proj/proj{i}/kernel")
            for field, (tree, leaf) in {
                "gamma": (params, "scale"), "beta": (params, "bias"),
                "moving_mean": (batch_stats, "mean"),
                "moving_variance": (batch_stats, "var"),
            }.items():
                tf[f"{P}/{scope}/conv1d_proj_{i}/batch_normalization/{field}"] = \
                    g(tree, f"{ours}/proj/bn{i}/bn/{leaf}")
        hw = _walk(params, f"{ours}/highway")
        n_hw = sum(1 for k in hw if k.startswith("H"))
        for i in range(n_hw):
            tf[f"{P}/{scope}/highwaynet_{i}/dense/kernel"] = g(params, f"{ours}/highway/H{i}/kernel")
            tf[f"{P}/{scope}/highwaynet_{i}/dense/bias"] = g(params, f"{ours}/highway/H{i}/bias")
            tf[f"{P}/{scope}/highwaynet_{i}/dense_1/kernel"] = g(params, f"{ours}/highway/T{i}/kernel")
            tf[f"{P}/{scope}/highwaynet_{i}/dense_1/bias"] = g(params, f"{ours}/highway/T{i}/bias")
        if "resize" in hw:
            tf[f"{P}/{scope}/highway_resize/kernel"] = g(params, f"{ours}/highway/resize/kernel")
            tf[f"{P}/{scope}/highway_resize/bias"] = g(params, f"{ours}/highway/resize/bias")
        # biGRU: fuse our hoisted split back into TF's [x, h] layout
        for d, tfd in (("fwd", "fw"), ("bwd", "bw")):
            gx = g(params, f"{ours}/bigru/{d}/gates_x/kernel")
            gh = g(params, f"{ours}/bigru/{d}/gates_h/kernel")
            tf[f"{P}/{scope}/bidirectional_rnn/{tfd}/gru_cell/gates/kernel"] = \
                np.concatenate([gx, gh], axis=0)
            tf[f"{P}/{scope}/bidirectional_rnn/{tfd}/gru_cell/gates/bias"] = \
                g(params, f"{ours}/bigru/{d}/gates_x/bias")
            cx = g(params, f"{ours}/bigru/{d}/cand_x/kernel")
            ch = g(params, f"{ours}/bigru/{d}/cand_h/kernel")
            tf[f"{P}/{scope}/bidirectional_rnn/{tfd}/gru_cell/candidate/kernel"] = \
                np.concatenate([cx, ch], axis=0)
            tf[f"{P}/{scope}/bidirectional_rnn/{tfd}/gru_cell/candidate/bias"] = \
                g(params, f"{ours}/bigru/{d}/cand_x/bias")

    tf[f"{P}/memory_layer/kernel"] = g(params, "memory_proj/kernel")
    tf[f"{P}/decoder/bahdanau_attention/query_layer/kernel"] = \
        g(params, "decoder/cell/attention/query/kernel")
    tf[f"{P}/decoder/bahdanau_attention/attention_v"] = \
        g(params, "decoder/cell/attention/v").reshape(-1)

    for tf_cell, ours_cell in (("attention_wrapper/gru_cell", "attention_gru"),
                               ("multi_rnn_cell/cell_0/gru_cell", "decoder_gru0"),
                               ("multi_rnn_cell/cell_1/gru_cell", "decoder_gru1")):
        for part in ("gates", "candidate"):
            for leaf in ("kernel", "bias"):
                tf[f"{P}/decoder/{tf_cell}/{part}/{leaf}"] = \
                    g(params, f"decoder/cell/{ours_cell}/{part}/{leaf}")

    tf[f"{P}/decoder/output_projection_wrapper/kernel"] = \
        g(params, "decoder/cell/decoder_input_proj/kernel")
    tf[f"{P}/decoder/output_projection_wrapper/bias"] = \
        g(params, "decoder/cell/decoder_input_proj/bias")
    # generic denses, resolved by shape: frame proj + postnet linear proj
    tf[f"{P}/decoder/dense/kernel"] = g(params, "decoder/cell/frame_proj/kernel")
    tf[f"{P}/decoder/dense/bias"] = g(params, "decoder/cell/frame_proj/bias")
    tf[f"{P}/dense_2/kernel"] = g(params, "postnet/linear_proj/kernel")
    tf[f"{P}/dense_2/bias"] = g(params, "postnet/linear_proj/bias")
    return tf


def _walk(tree, path):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_target(model):
    tree = to_flax(*split_state(model))
    return _plus_one(tree["params"]), _plus_one(tree["batch_stats"])


@pytest.fixture(scope="module")
def converted(models):
    jm, variables, model, _ = models
    tf_vars = _tf1_names(variables["params"], variables["batch_stats"])
    return tf_vars, {
        "jax": jax_tf1.convert(tf_vars, _plus_one(variables["params"]),
                               _plus_one(variables["batch_stats"])),
        "port": tf1.convert(tf_vars, *_port_target(model)),
    }


def test_convert_equals_jax_full_coverage(models, converted):
    _, variables, _, _ = models
    tf_vars, out = converted
    port, ref = out["port"], out["jax"]
    assert port["errors"] == ref["errors"] == {}
    assert port["unmatched_tf"] == ref["unmatched_tf"] == []
    assert port["unmatched_ours"] == ref["unmatched_ours"] == []
    assert port["matched"] == ref["matched"] and sorted(port["matched"]) == sorted(tf_vars)
    for coll in ("params", "batch_stats"):
        got, want, orig = _flat(port[coll]), _flat(ref[coll]), _flat(variables[coll])
        assert sorted(got) == sorted(want) == sorted(orig)
        for k in orig:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], orig[k], err_msg=k)


def test_converted_forward_equals_jax(models, converted):
    jm, _, model, (text, lens, mel) = models
    _, out = converted
    p, s = from_flax({"params": out["port"]["params"], "batch_stats": out["port"]["batch_stats"]})
    loaded = Tacotron(model.cfg, device="cpu")
    loaded.load_state_dict({**p, **s}, strict=True)
    with torch.no_grad():
        got = loaded.eval()(torch.from_numpy(text), torch.from_numpy(lens),
                            gt_mel=torch.from_numpy(mel))
    want = jm.apply({"params": out["jax"]["params"], "batch_stats": out["jax"]["batch_stats"]},
                    jnp.asarray(text), jnp.asarray(lens), gt_mel=jnp.asarray(mel))
    for g, w, name in zip(got, want, ("mel", "linear", "alignments")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)


def _both(convert_args):
    """The same conversion through both converters, which must agree; ->
    the port's result."""
    outs = {k: m.convert(*convert_args()) for k, m in CONVERTERS.items()}
    port, ref = outs["port"], outs["jax"]
    for key in ("matched", "unmatched_tf", "unmatched_ours", "errors"):
        assert port[key] == ref[key], key
    for coll in ("params", "batch_stats"):
        got, want = _flat(port[coll]), _flat(ref[coll])
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return port


def test_shape_mismatch_is_error_not_misassign(models):
    params = models[1]["params"]
    bad = {"model/inference/embedding": np.zeros((7, 7), np.float32)}
    out = _both(lambda: (bad, params))
    assert "model/inference/embedding" in out["errors"]
    np.testing.assert_array_equal(out["params"]["encoder"]["embed"]["embedding"],
                                  params["encoder"]["embed"]["embedding"])


@pytest.mark.parametrize("cells", [2, 3])
def test_decoder_cell_conventions(models, cells):
    """MultiRNNCell([attention cell, res-GRU, res-GRU]) scopes the cells as
    cell_0..cell_2, cell_0 the attention GRU; with the attention cell under
    attention_wrapper the residual GRUs are cell_0/cell_1. Decided from the
    whole name set, not per variable."""
    params = models[1]["params"]
    ours = (("attention_gru", "decoder_gru0", "decoder_gru1") if cells == 3
            else ("decoder_gru0", "decoder_gru1"))
    tf = {}
    for i, cell in enumerate(ours):
        for part in ("gates", "candidate"):
            for leaf in ("kernel", "bias"):
                tf[f"model/decoder/multi_rnn_cell/cell_{i}/gru_cell/{part}/{leaf}"] = \
                    _walk(params, f"decoder/cell/{cell}/{part}/{leaf}") * 2.0
    out = _both(lambda: (tf, params))
    assert not out["errors"] and not out["unmatched_tf"]
    for i, cell in enumerate(ours):
        np.testing.assert_array_equal(
            _walk(out["params"], f"decoder/cell/{cell}/gates/kernel"),
            tf[f"model/decoder/multi_rnn_cell/cell_{i}/gru_cell/gates/kernel"])


def test_unmatched_names_are_listed_not_guessed(models):
    params = models[1]["params"]
    names = {"model/decoder/multi_rnn_cell/cell_7/gru_cell/gates/kernel":
             np.zeros((4, 4), np.float32),
             "model/inference/some_new_scope/weights": np.zeros((3,), np.float32)}
    out = _both(lambda: (names, params))
    assert out["unmatched_tf"] == sorted(names) and not out["matched"] and not out["errors"]
    assert len(out["unmatched_ours"]) == len(_flat(params))


def test_multi_target_mismatch_commits_nothing(models):
    """gru_split emits two assignments; if the second one's shape
    mismatches, the first must not be committed."""
    params = models[1]["params"]
    gx = _walk(params, "encoder/cbhg/bigru/fwd/gates_x/kernel")
    bad = np.zeros((gx.shape[0] + 3, gx.shape[1]), np.float32)
    name = "model/inference/encoder_cbhg/bidirectional_rnn/fw/gru_cell/gates/kernel"
    out = _both(lambda: ({name: bad}, params))
    assert name in out["errors"]
    np.testing.assert_array_equal(_walk(out["params"], "encoder/cbhg/bigru/fwd/gates_x/kernel"), gx)
    assert "params:encoder/cbhg/bigru/fwd/gates_x/kernel" in out["unmatched_ours"]


def test_split_tf_gru_kernel():
    k = np.arange(7 * 6, dtype=np.float32).reshape(7, 6)
    for d_in in (0, 3, 7):
        got, want = tf1.split_tf_gru_kernel(k, d_in), jax_tf1.split_tf_gru_kernel(k, d_in)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.concatenate(got, axis=0), k)


def test_name_table_is_jax_s():
    assert [p for p, _ in tf1.NAME_TABLE] == [p for p, _ in jax_tf1.NAME_TABLE]


def test_module_imports_no_jax():
    code = ("import sys; import tacotron_tpu_torch.utils.tf1_converter; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tacotron_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
