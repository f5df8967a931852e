"""The rule by which the mesh paths are graphed, on the CPU.

``parallel.collectives.capturable`` says whether a mesh's collectives can
go into a CUDA graph: no process group can, NCCL can, gloo cannot (its
collectives go through host copies). ``make_train_step(cfg, mesh)`` and
``Synthesizer(mesh=...)`` decide by it. Here, in one process, a 1-rank
gloo group on a ``file://`` rendezvous and a mesh with no group:

* the predicate, and which step ``make_train_step`` returns for each mesh;
* ``GraphedTrainStep(cfg, mesh)`` on a state on the CPU (its eager path)
  bit-equal to ``train_step(..., mesh=mesh)`` over two steps, dropout on;
  its shape key holds the mesh;
* ``Synthesizer(mesh=...)`` bit-equal to the Synthesizer without a mesh
  (a 1-rank gather is a copy, and the global batch's dropout masks are
  this rank's), ``graphed`` False.

The graphs themselves, over a 1-rank NCCL group, run only on the card
(``tests/test_torch_graph_cuda.py``, ``chip_smoke.py`` [dp]); the mesh
step's and mesh synthesis's parity with JAX on two ranks is
``tests/test_torch_multiprocess.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.infer import Synthesizer
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.parallel import make_mesh
from tacotron_tpu_torch.parallel.collectives import capturable
from tacotron_tpu_torch.train import create_train_state, make_train_step, train_step
from tacotron_tpu_torch.train.step import GraphedTrainStep
from tacotron_tpu_torch.weights import init_params, split_state

PROMPTS = ["hello world", "a lazy dog", "hello"]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """{kind: mesh}: "no_group", made before any process group exists (one
    process, as ``cli.train`` makes it), and "gloo", over a 1-rank gloo
    group on a ``file://`` rendezvous, open for the module's tests."""
    cfg = get_config("tiny_cpu")
    out = {"no_group": make_mesh(cfg.mesh, platform="cpu")}
    rdv = tmp_path_factory.mktemp("mesh_graph") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=1, rank=0)
    out["gloo"] = make_mesh(cfg.mesh, platform="cpu")
    yield out
    dist.destroy_process_group()


def _train_cfg():
    c = get_config("tiny_cpu")
    return dataclasses.replace(c, model=dataclasses.replace(c.model, vocab_size=32))


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([9, 6, 4])
    text = torch.randint(1, 30, (3, 9), generator=g) * (torch.arange(9) < lengths[:, None])
    return (text, lengths, torch.rand(3, 20, 80, generator=g), torch.rand(3, 20, 1025, generator=g),
            torch.tensor([20, 15, 10]))


@pytest.mark.parametrize("kind, groups, graphed", [("no_group", False, True),
                                                   ("gloo", True, False)])
def test_capturable_decides_the_step(meshes, kind, groups, graphed):
    mesh = meshes[kind]
    assert (mesh.data_group is not None, mesh.model_group is not None) == (groups, groups)
    assert capturable() and capturable(None, None)
    assert capturable(mesh.data_group, mesh.model_group) is graphed
    assert mesh.capturable is graphed
    step = make_train_step(_train_cfg(), mesh)
    assert isinstance(step, GraphedTrainStep) is graphed
    if not graphed:
        assert step.func is train_step and step.keywords["mesh"] is mesh
    assert isinstance(make_train_step(_train_cfg()), GraphedTrainStep)


def test_shape_key_holds_the_mesh(meshes):
    cfg = _train_cfg()
    keys = [GraphedTrainStep(cfg, m).shape_key("cpu", *_batch())
            for m in (None, meshes["no_group"], meshes["gloo"])]
    assert len(set(keys)) == 3
    assert keys[1] == GraphedTrainStep(cfg, meshes["no_group"]).shape_key("cpu", *_batch(1))


@pytest.mark.parametrize("kind", ["no_group", "gloo"])
def test_graphed_step_on_the_cpu_is_the_mesh_step(meshes, kind):
    """Prenet dropout 0.5 (tiny_cpu's), batch norm over the data group, the
    gradients' all-reduce: two steps, every tensor bit-equal."""
    cfg, mesh = _train_cfg(), meshes[kind]
    runs = []
    for step in (GraphedTrainStep(cfg, mesh), functools.partial(train_step, cfg=cfg, mesh=mesh)):
        state = create_train_state(cfg, seed=0, device="cpu", mesh=mesh)
        metrics = []
        for i in range(2):
            state, m, align = step(state, *_batch(i))
            metrics.append({k: v.item() for k, v in m.items()} | {"align": align})
        runs.append((state, metrics))
    (got, m_got), (want, m_want) = runs
    assert got.step == want.step == 2
    for a, b in zip(m_got, m_want):
        assert torch.equal(a.pop("align"), b.pop("align")) and a == b
    for (k, p), q in zip(got.model.named_parameters(), want.model.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), k
    for (k, b), c in zip(got.model.named_buffers(), want.model.buffers()):
        assert torch.equal(b, c), k
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


@pytest.mark.parametrize("kind", ["no_group", "gloo"])
def test_mesh_synthesis_equals_one_process(meshes, kind):
    """Tiny widths, a small STFT, prenet dropout on: the mesh call (the pad
    and slice, the global batch's masks, the gather) equals the call
    without a mesh, bit for bit, and ran eagerly."""
    cfg = get_config("tiny_cpu")
    cfg = cfg.replace(audio=dataclasses.replace(cfg.audio, n_fft=512, win_length=400,
                                                hop_length=128, griffin_lim_iters=2),
                      model=dataclasses.replace(cfg.model, vocab_size=40, n_freq=257,
                                                max_decode_steps=6))
    state = split_state(init_params(Tacotron(cfg.model, device="cpu"), seed=0))
    vocab = Vocab.build(PROMPTS)
    outs = [Synthesizer(cfg, *state, vocab, mesh=m, device="cpu")(PROMPTS, seed=3)
            for m in (meshes[kind], None)]
    assert outs[0]["graphed"] is False and outs[1]["graphed"] is False
    for k in ("mel", "linear", "alignments", "wavs", "end_frames", "wav_lengths"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    assert outs[0]["audio_seconds"] == outs[1]["audio_seconds"]
