"""Checkpoint / resume in the JAX package's on-disk layout.

Port of the JAX package's ``train/checkpoint.py``. A checkpoint is the
directory ``<ckpt_dir>/step_<N>/`` holding

* ``leaves.npz``: ``leaf_i``, the leaves of the JAX package's ``TrainState``
  in its flatten order: the parameters in flax's layout (``weights.to_flax``:
  kernels (in, out), nested dicts taken depth-first in sorted key order),
  the batch statistics, the optimizer state of optax's chain (the clip's
  state has no leaf; Adam's ``count``, ``mu`` and ``nu``; the learning-rate
  schedule's ``count``), the update count ``step`` (int32) and the
  dropout key ``rng`` ((2,) uint32);
* ``treedef.json``: ``n_leaves``, ``step``, ``"treedef": null`` and
  ``paths``, each leaf's path. With no treedef string the JAX package's
  ``restore`` checks every leaf's shape and dtype against its template, so
  it restores a checkpoint the port wrote;
* ``torch_state.npz``, the port's own: the dropout generator's state, so
  that a resume on the same kind of device is bit-identical. A checkpoint
  without it (the JAX package's) seeds the generator from ``rng`` as a JAX
  key holds its seed: ``rng[0] << 32 | rng[1]``. The port writes into
  ``rng`` its generator's initial seed the same way.

Adam's ``mu``/``nu`` are ``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``,
carried through the same transposes as the parameters; both counts are the
state's update count. Writes are atomic (a hidden temporary directory,
fsync, ``os.replace``) and keep the newest ``keep``.

On a mesh (``parallel/``) ``save`` and ``restore`` are collective: every
rank calls them. The tensor-parallel shards of the parameters and their
Adam moments are gathered into full arrays, so the files are the layout
above whatever the mesh; only the primary process writes. ``restore`` reads
the full arrays on every rank and hands each its shards.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from tacotron_tpu_torch.config import TrainConfig
from tacotron_tpu_torch.parallel import multihost
from tacotron_tpu_torch.parallel.sharding import full_tensor, local_slice
from tacotron_tpu_torch.train.step import TrainState
from tacotron_tpu_torch.weights import from_flax, split_state, to_flax

_STEP_RE = re.compile(r"^step_(\d+)$")
TORCH_STATE = "torch_state.npz"


def _sorted_leaves(tree: dict, prefix: str):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _sorted_leaves(v, path)
        else:
            yield path, np.asarray(v)


def _moments(state: TrainState, slot: str) -> dict:
    """Adam's ``slot`` of every parameter, by state-dict key, full (zeros
    before the first update)."""
    out = {}
    for name, p in state.model.named_parameters():
        st = state.opt.state.get(p, {})
        m = st[slot].detach() if slot in st else torch.zeros_like(p)
        out[name] = full_tensor(state.model, name, m)
    return out


def full_state(model) -> tuple[dict, dict]:
    """``weights.split_state`` of a model, its split parameters gathered
    into full tensors (collective on a tensor-parallel mesh)."""
    params, stats = split_state(model)
    return {k: full_tensor(model, k, v) for k, v in params.items()}, stats


def _key_of_seed(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _seed_of_key(key: np.ndarray) -> int:
    return (int(key[0]) << 32) | int(key[1])


def state_leaves(state: TrainState, train_cfg: TrainConfig) -> list[tuple[str, np.ndarray]]:
    """``[(path, array)]``: the JAX package's ``TrainState`` leaves of
    ``state``, in its flatten order."""
    flax = to_flax(*full_state(state.model))
    count = np.asarray(state.step, np.int32)
    adam = 1 if train_cfg.grad_clip_norm is not None else 0
    leaves = [*_sorted_leaves(flax["params"], "params"),
              *_sorted_leaves(flax["batch_stats"], "batch_stats"),
              (f"opt_state/{adam}/count", count)]
    for name, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        leaves += _sorted_leaves(to_flax(_moments(state, slot))["params"],
                                 f"opt_state/{adam}/{name}")
    leaves += [(f"opt_state/{adam + 1}/count", count), ("step", count),
               ("rng", _key_of_seed(state.generator.initial_seed()))]
    return leaves


def save(ckpt_dir: str, step: int, state: TrainState, train_cfg: TrainConfig,
         keep: int = 5) -> str | None:
    """Atomically write checkpoint ``step_<step>`` under ``ckpt_dir`` and
    keep the newest ``keep``. Returns its path; on a mesh every rank calls
    it and the others return None."""
    leaves = state_leaves(state, train_cfg)
    if not multihost.is_primary():
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step}"
    tmp = os.path.join(ckpt_dir, f".tmp_{name}")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    gen = state.generator
    files = {
        "leaves.npz": lambda f: np.savez(f, **{f"leaf_{i}": a for i, (_, a) in enumerate(leaves)}),
        "treedef.json": lambda f: f.write(json.dumps(
            {"treedef": None, "n_leaves": len(leaves), "step": step,
             "paths": [p for p, _ in leaves]}).encode()),
        TORCH_STATE: lambda f: np.savez(f, generator=gen.get_state().numpy(),
                                        generator_device=np.array(gen.device.type)),
    }
    for fname, write in files.items():
        with open(os.path.join(tmp, fname), "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "treedef.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _nested(leaves) -> dict:
    out: dict = {}
    for path, a in leaves:
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def restore(ckpt_dir: str, state: TrainState, train_cfg: TrainConfig,
            step: int | None = None) -> tuple[TrainState, int]:
    """Load checkpoint ``step`` (the latest if None) into ``state``'s model,
    optimizer and generator, in place. Returns (state with its update
    count, step). Raises FileNotFoundError if there is none, ValueError on
    a leaf count, shape or dtype that ``state`` does not have, naming the
    leaf's path. Collective on a tensor-parallel mesh."""
    if step is None:
        step = latest(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    data = np.load(os.path.join(path, "leaves.npz"))
    with open(os.path.join(path, "treedef.json")) as f:
        meta = json.load(f)
    want = state_leaves(state, train_cfg)
    if meta["n_leaves"] != len(want):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, the state expects "
                         f"{len(want)} (the model or optimizer config differs) ({path})")
    # the port's checkpoints name their leaves; the JAX package's carry a
    # treedef string instead, and are held by shape and dtype alone
    for i, (got, (name, _)) in enumerate(zip(meta.get("paths") or [], want)):
        if got != name:
            raise ValueError(f"checkpoint leaf {i} is {got}, the state expects {name} ({path})")
    leaves = []
    for i, (name, tgt) in enumerate(want):
        leaf = data[f"leaf_{i}"]
        if leaf.shape != tgt.shape or leaf.dtype != tgt.dtype:
            raise ValueError(f"checkpoint leaf {name} has shape/dtype {leaf.shape}/{leaf.dtype}, "
                             f"the state expects {tgt.shape}/{tgt.dtype} ({path})")
        leaves.append((name, leaf))
    tree = _nested(leaves)

    model, opt = state.model, state.opt
    params, stats = from_flax({"params": tree["params"], "batch_stats": tree["batch_stats"]})
    params = {k: local_slice(model, k, v) for k, v in params.items()}
    model.load_state_dict({**params, **stats}, strict=True)
    adam = tree["opt_state"][str(1 if train_cfg.grad_clip_norm is not None else 0)]
    count = int(adam["count"])
    mu, nu = from_flax(adam["mu"])[0], from_flax(adam["nu"])[0]
    opt.state.clear()
    if count > 0:
        for name, p in model.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                            "exp_avg": local_slice(model, name, mu[name]).to(p.device),
                            "exp_avg_sq": local_slice(model, name, nu[name]).to(p.device)}

    gen = state.generator
    extra = os.path.join(path, TORCH_STATE)
    saved = np.load(extra) if os.path.exists(extra) else None
    if saved is not None and str(saved["generator_device"]) == gen.device.type:
        gen.set_state(torch.from_numpy(saved["generator"].copy()))
    else:
        gen.manual_seed(_seed_of_key(tree["rng"]))
    return state._replace(step=int(tree["step"])), step
