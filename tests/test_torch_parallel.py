"""The parallel layer's pieces against the JAX package's, and the CLIs on
two processes (gloo on the CPU).

In one process: ``multihost.batch_hash`` against JAX's, the sharding rules
against JAX's ``tree_shardings`` (the JAX TP test's config: vocab 32,
n_freq 260, model 2, on a 4 x 2 mesh of the conftest's fake devices), and
the loader's per-process schedule against JAX's loader for 2 and 3
processes, item for item. Then ``cli.train`` on two processes, the
counterpart of ``tests/distributed/test_cli_multiprocess.py``: a
``file://`` rendezvous under ``tmp_path`` and a parent that kills every
process as soon as one fails or at a hard wall of ``WALL_S``; then the
resume and ``cli.synthesize --data-parallel`` on the same run directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.data.loader import DataLoader, Dataset
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.parallel import multihost
from tacotron_tpu_torch.parallel.sharding import tree_shardings

from torch_launch import run_commands

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WALL_S = 120


def test_batch_hash_equals_jax():
    from tacotron_tpu.parallel import multihost as jax_multihost

    rng = np.random.default_rng(0)
    arrays = (rng.integers(0, 30, (3, 7)).astype(np.int32), np.array([7, 5, 2], np.int32),
              rng.uniform(0, 1, (3, 10, 8)).astype(np.float16),
              rng.uniform(0, 1, (3, 10, 5)).astype(np.float32))
    want = jax_multihost.batch_hash(arrays)
    assert len(want) == 16
    assert multihost.batch_hash(arrays) == want
    assert multihost.batch_hash(tuple(map(torch.from_numpy, arrays))) == want
    assert multihost.batch_hash(arrays[:3]) != want


class _Mesh:
    def __init__(self, model_size):
        self.model_size = model_size


@pytest.mark.parametrize("n_freq", [260, 259])
def test_sharding_rules_pick_jax_parameters(n_freq):
    """The parameters (and Adam moments) that JAX shards over the model
    axis are the ones the port splits, on the same dimension; a width that
    does not divide stays replicated on both sides."""
    import jax
    from jax.sharding import PartitionSpec as P

    from tacotron_tpu.config import get_config as jax_get_config
    from tacotron_tpu.parallel import make_mesh as jax_make_mesh
    from tacotron_tpu.parallel.sharding import tree_shardings as jax_tree_shardings
    from tacotron_tpu.train.step import create_train_state as jax_create_train_state

    c = jax_get_config("tiny_cpu")
    jcfg = dataclasses.replace(c, model=dataclasses.replace(c.model, vocab_size=32,
                                                            n_freq=n_freq),
                               mesh=dataclasses.replace(c.mesh, model_parallel_size=2))
    mesh = jax_make_mesh(jcfg.mesh)
    state = jax.eval_shape(lambda: jax_create_train_state(jcfg, jax.random.PRNGKey(0)))
    sh = jax_tree_shardings(state, mesh, jcfg.mesh)
    want = {}
    for tree in (sh.params, sh.opt_state[1].mu, sh.opt_state[1].nu):
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            if s.spec != P():
                keys = [k.key for k in path]
                # a flax (in, out) kernel split on out is the port's
                # (out, in) weight split on dim 0
                name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]])
                dim = s.spec.index("model")
                want[name] = 1 - dim if keys[-1] == "kernel" else dim

    from tacotron_tpu_torch.config import Config
    cfg = Config.from_json(jcfg.to_json())
    model = Tacotron(cfg.model, device="meta")
    shapes = {k: p.shape for k, p in model.named_parameters()}
    got = {k: d for k, d in tree_shardings(shapes, _Mesh(2)).items() if d is not None}
    assert got == want
    if n_freq == 260:
        assert set(got) == {"postnet.linear_proj.weight", "postnet.linear_proj.bias",
                            "encoder.embed.embedding"}
    assert not any(d is not None for d in tree_shardings(shapes, _Mesh(1)).values())


def _fake_data(root, n=23, seed=0):
    """A packed data directory of n utterances with random features (the
    layout ``ljspeech.preprocess`` writes), lengths spread over three
    buckets."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    vocab = Vocab.build(["the quick brown fox jumps over a lazy dog"])
    vocab.save(os.path.join(root, "vocab.json"))
    index, texts, frames = [], [], 0
    for i in range(n):
        t, f = int(rng.integers(3, 12)), int(rng.integers(8, 40))
        index.append({"id": f"u{i}", "text_offset": sum(len(x) for x in texts),
                      "text_len": t, "frame_offset": frames, "n_frames": f})
        texts.append(rng.integers(1, len(vocab), t).astype(np.int32))
        frames += f
    np.save(os.path.join(root, "texts.npy"), np.concatenate(texts))
    np.save(os.path.join(root, "mels.npy"),
            rng.uniform(0, 1, (frames, 80)).astype(np.float16))
    np.save(os.path.join(root, "linears.npy"),
            rng.uniform(0, 1, (frames, 1025)).astype(np.float16))
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump(index, f)
    return root


@pytest.mark.parametrize("url,env,cards,want", [
    ("file:///tmp/rdv", {}, 1, (2, "gloo")),
    ("tcp://127.0.0.1:1234", {}, 2, (2, "nccl")),
    ("tcp://localhost:1234", {}, 1, (2, "gloo")),
    ("tcp://10.1.2.3:1234", {"LOCAL_WORLD_SIZE": "1"}, 1, (1, "nccl")),
    ("tcp://10.1.2.3:1234", {}, 1, None),
], ids=["file", "loopback_cards", "loopback_one_card", "remote_env", "remote_refused"])
def test_backend_follows_the_processes_on_this_host(monkeypatch, url, env, cards, want):
    """NCCL only where this host has a card for each of its processes; a
    coordinator on another host needs LOCAL_WORLD_SIZE to tell."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is None:
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            multihost.local_process_count(url, 2)
        return
    n = multihost.local_process_count(url, 2)
    assert (n, multihost.pick_backend(n)) == want
    assert multihost.pick_backend(n, platform="cpu") == "gloo"


def test_shard_model_swaps_in_the_mesh_layers(tmp_path):
    """On a one-rank gloo world every batch norm becomes its global-batch
    form, the state-dict names stay, and the training forward gives the
    plain model's bits; the plain model keeps its own layers."""
    import torch.distributed as dist

    from tacotron_tpu_torch.config import MeshConfig
    from tacotron_tpu_torch.ops.modules import BatchNorm
    from tacotron_tpu_torch.parallel import make_mesh
    from tacotron_tpu_torch.parallel.layers import SyncBatchNorm
    from tacotron_tpu_torch.parallel.sharding import shard_model
    from tacotron_tpu_torch.weights import init_params

    cfg = get_config("tiny_cpu")
    plain = init_params(Tacotron(cfg.model, device="cpu"), seed=0).train()
    sharded = init_params(Tacotron(cfg.model, device="cpu"), seed=0).train()
    g = torch.Generator().manual_seed(1)
    text = torch.randint(1, cfg.model.vocab_size, (2, 7), generator=g)
    lengths, mel = torch.tensor([7, 5]), torch.rand(2, 10, cfg.model.n_mels, generator=g)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        shard_model(sharded, make_mesh(MeshConfig(), platform="cpu"))
        kinds = {type(m) for m in sharded.modules() if isinstance(m, BatchNorm)}
        assert kinds == {SyncBatchNorm}
        assert not any(isinstance(m, SyncBatchNorm) for m in plain.modules())
        assert list(sharded.state_dict()) == list(plain.state_dict())
        outs = [m(text, lengths, gt_mel=mel, generator=torch.Generator().manual_seed(2))
                for m in (plain, sharded)]
    finally:
        dist.destroy_process_group()
    assert torch.equal(outs[0].mel, outs[1].mel) and torch.equal(outs[0].linear, outs[1].linear)
    for (k, a), b in zip(plain.named_buffers(), sharded.buffers()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("count", [2, 3])
def test_loader_shards_the_schedule_as_jax(tmp_path, count):
    """Two epochs: every process's buckets, items (wrap fill from its own
    generator included) and batches equal JAX's loader for that process;
    every process takes the same bucket at each step."""
    from tacotron_tpu.data.loader import DataLoader as JaxDataLoader
    from tacotron_tpu.data.loader import Dataset as JaxDataset

    data = _fake_data(str(tmp_path / "d"))
    kw = dict(batch_size=3, num_buckets=3, r=5, seed=4, process_count=count)
    buckets = []
    for i in range(count):
        want_dl = JaxDataLoader(JaxDataset(data), use_native=False, process_index=i, **kw)
        dl = DataLoader(Dataset(data), use_native=False, process_index=i, **kw)
        seen = []
        for _ in range(2):
            got, want = list(dl.epoch()), list(want_dl.epoch())
            assert [(b.bucket, tuple(map(int, b.items))) for b in got] == \
                [(b.bucket, tuple(map(int, b.items))) for b in want]
            for g, w in zip(got, want):
                for a, b in zip(g.arrays(), (w.text, w.text_len, w.mel, w.linear,
                                             w.frame_len)):
                    np.testing.assert_array_equal(a, b)
            seen += [b.bucket for b in got]
        buckets.append(seen)
    assert all(b == buckets[0] for b in buckets)
    with pytest.raises(ValueError, match="process_index"):
        DataLoader(Dataset(data), use_native=False, process_index=count, **kw)


def _procs(cmds, log_dir):
    return run_commands(cmds, log_dir, WALL_S, dict(os.environ, PYTHONPATH=REPO,
                                                    OMP_NUM_THREADS="1"))


def _cli(module, rdv, n, *args):
    return [[sys.executable, "-m", f"tacotron_tpu_torch.cli.{module}", *args,
             "--platform", "cpu", "--coordinator", f"file://{rdv}",
             "--num-processes", str(n), "--process-id", str(i)] for i in range(n)]


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_train_cli_on_two_processes(tmp_path):
    """Per-process batch from the per-chip one, --debug-sync, a collective
    checkpoint written by process 0 only, the same global loss printed by
    both, the resume on both, --device-cache refused, and
    ``cli.synthesize --data-parallel`` on the run."""
    data, run = _fake_data(str(tmp_path / "data"), n=16), tmp_path / "run"
    train = ["--data-dir", data, "--run-dir", str(run), "--preset", "tiny_cpu",
             "--set", "train.per_chip_batch_size=2", "--num-buckets", "3",
             "--summary-every", "3", "--checkpoint-every", "6", "--debug-sync",
             "--set", "model.max_decode_steps=4", "--eval-every", "4", "--eval-text", "ab"]
    outs, codes = _procs(_cli("train", tmp_path / "rdv1", 2, *train, "--steps", "6"), tmp_path)
    assert codes == [0, 0], outs
    assert all("torch.distributed backend gloo" in o for o in outs)
    finals = [_json_lines(o)[-1] for o in outs]
    assert finals[0] == finals[1] == {"done": True, "step": 6}
    losses = [[ln["total_loss"] for ln in _json_lines(o) if "total_loss" in ln] for o in outs]
    assert len(losses[0]) == len(losses[1]) == 2 and losses[0] == losses[1]
    with open(run / "config.json") as f:
        assert json.load(f)["train"]["batch_size"] == 4        # 2 per process x 2
    assert sorted(os.listdir(run / "ckpt")) == ["step_6"]
    # only process 0 wrote summaries: one writer's records, once per summary
    assert "summary writer" in outs[0] and "summary writer" not in outs[1]
    with open(run / "tb" / "scalars.jsonl") if (run / "tb" / "scalars.jsonl").exists() \
            else open(os.devnull) as f:
        steps = [json.loads(ln)["step"] for ln in f if '"train/total_loss"' in ln]
    assert steps in ([3, 6], [])          # [] when tensorboardX writes events instead

    outs, codes = _procs(_cli("train", tmp_path / "rdv2", 2, *train, "--steps", "8"), tmp_path)
    assert codes == [0, 0], outs
    assert all("resumed from step 6" in o for o in outs)
    assert [_json_lines(o)[-1] for o in outs] == [{"done": True, "step": 8}] * 2

    outs, codes = _procs(_cli("train", tmp_path / "rdv3", 2, *train, "--steps", "9",
                              "--device-cache"), tmp_path)
    # each process refuses; the first to exit stops the other
    assert 0 not in codes and any("--device-cache is single-process only" in o for o in outs)

    out_dir = tmp_path / "wavs"
    outs, codes = _procs(_cli("synthesize", tmp_path / "rdv4", 2, "--run-dir", str(run),
                              "--data-dir", data, "--out-dir", str(out_dir),
                              "--text", "abc", "--text", "the fox", "--text", "a dog",
                              "--steps", "4", "--gl-iters", "2", "--data-parallel"), tmp_path)
    assert codes == [0, 0], outs
    assert _json_lines(outs[0])[-1]["n"] == 3 and not _json_lines(outs[1])
    assert sorted(os.listdir(out_dir)) == [f"utt_{i:03d}.wav" for i in range(3)]


def test_cli_refuses_one_process_on_several_cards(tmp_path, monkeypatch, capsys):
    """--data-parallel in one process that sees two cards would use one:
    refused, saying to start a process per card."""
    from tacotron_tpu_torch.cli import synthesize as cli

    import tacotron_tpu_torch.runtime as runtime

    (tmp_path / "config.json").write_text(get_config("tiny_cpu").to_json())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(runtime, "resolve_device", lambda d=None: torch.device("cpu"))
    with pytest.raises(SystemExit) as e:
        cli.main(["--run-dir", str(tmp_path), "--data-dir", str(tmp_path), "--out-dir",
                  str(tmp_path / "o"), "--text", "a", "--data-parallel"])
    assert e.value.code == 2
    assert "start one process per card" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
