"""Parameters carried between the JAX package and the port.

``from_flax`` maps a flax variable tree (nested dicts of numpy arrays,
``{"params": ..., "batch_stats": ...}`` or any sub-tree of ``params``) to
the port's state-dict entries; ``to_flax`` is its inverse. The port's
module names follow the flax scopes, so a flax path maps to a state-dict
key by a rule on its last segments alone:

* ``.../kernel`` (in, out)     -> ``.../weight`` (out, in)        Dense
* ``.../kernel`` (W, in, out)  -> ``.../weight`` (out, in, W)     Conv
* ``.../bnX/bn/scale|bias``    -> ``.../bnX/weight|bias``         BatchNorm
* ``.../bnX/bn/mean|var``      -> ``.../bnX/running_mean|running_var``
* everything else (``bias``, ``embedding``, attention ``v`` (dim, 1)) as is.

``_ScanGRU``'s ``gates_h``/``cand_h`` hold a bare ``kernel`` and map like
any bias-free Dense. Flat names joined with ``/`` (optionally prefixed
``param__``, the naming of ``tests/fixtures/*.npz``) are read as well.

``init_params`` fills a module with seeded random weights of flax's
initial form (lecun-normal kernels, zero biases, GRU gate biases 1, highway
transform-gate biases -1, unit batch-norm scale).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _split_flat(flat: dict) -> dict:
    """``{"param__params/a/b": x}`` or ``{"params/a/b": x}`` -> nested."""
    nested: dict = {}
    for key, v in flat.items():
        if key.startswith("param__"):
            key = key[len("param__"):]
        elif "/" not in key:
            continue
        node = nested
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return nested


def _as_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float16:   # f16-stored fixtures: exact in f32
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True))


def from_flax(variables) -> tuple[dict, dict]:
    """flax variables -> (params, batch_stats), each ``{state-dict key:
    tensor}``; ``module.load_state_dict({**params, **batch_stats})``."""
    if any("/" in k for k in variables):
        variables = _split_flat(variables)
    if "params" in variables or "batch_stats" in variables:
        p_tree = variables.get("params", {})
        bs_tree = variables.get("batch_stats", {})
    else:
        p_tree, bs_tree = variables, {}

    params = {}
    for path, leaf in _flatten(p_tree):
        t = _as_tensor(leaf)
        *mods, name = path
        if len(mods) >= 1 and mods[-1] == "bn" and name in _BN_PARAM:
            mods, name = mods[:-1], _BN_PARAM[name]
        elif name == "kernel":
            name = "weight"
            t = t.t() if t.ndim == 2 else t.permute(2, 1, 0)
        params[".".join(mods + [name])] = t.contiguous()

    batch_stats = {}
    for path, leaf in _flatten(bs_tree):
        *mods, name = path
        if not (mods and mods[-1] == "bn" and name in _BN_STAT):
            raise ValueError(f"unexpected batch_stats entry {'/'.join(path)}")
        batch_stats[".".join(mods[:-1] + [_BN_STAT[name]])] = _as_tensor(leaf)
    return params, batch_stats


def to_flax(params: dict, batch_stats: dict | None = None) -> dict:
    """Inverse of ``from_flax``: -> ``{"params": ..., "batch_stats": ...}``
    nested dicts of numpy arrays (``batch_stats`` omitted when empty)."""
    batch_stats = batch_stats or {}
    # a BatchNorm is the only module with a 1-D ``weight``
    bn_mods = {k.rsplit(".", 1)[0] for k, v in params.items()
               if k.endswith(".weight") and v.ndim == 1}
    out: dict = {}

    def put(section, path, value):
        node = out.setdefault(section, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value.detach().cpu().numpy()

    for key, t in params.items():
        mods = key.split(".")
        *mods, name = mods
        mod = ".".join(mods)
        if mod in bn_mods and name in ("weight", "bias"):
            put("params", mods + ["bn", "scale" if name == "weight" else "bias"], t)
        elif name == "weight":
            put("params", mods + ["kernel"], t.t() if t.ndim == 2 else t.permute(2, 1, 0))
        else:
            put("params", mods + [name], t)
    for key, t in batch_stats.items():
        *mods, name = key.split(".")
        inv = {v: k for k, v in _BN_STAT.items()}
        put("batch_stats", mods + ["bn", inv[name]], t)
    return out


def split_state(module: nn.Module) -> tuple[dict, dict]:
    """A module's state as (params, batch_stats), the form ``from_flax``
    returns and ``Synthesizer`` takes."""
    params = {k: v.detach() for k, v in module.named_parameters()}
    stats = {k: v.detach() for k, v in module.named_buffers()}
    return params, stats


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill ``module`` in place with seeded random weights (drawn on the
    CPU from one ``torch.Generator``, so every device gets the same ones)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
            if leaf == "bias":
                fill = (1.0 if owner in ("gates", "gates_x")
                        else -1.0 if owner.startswith("T") and owner[1:].isdigit()
                        else 0.0)
                p.fill_(fill)
            elif leaf == "weight" and p.ndim == 1:      # BatchNorm scale
                p.fill_(1.0)
            else:
                fan_in = p.shape[0] if leaf in ("v", "embedding") else int(np.prod(p.shape[1:]))
                w = torch.randn(p.shape, generator=g) / np.sqrt(fan_in)
                p.copy_(w.to(p.dtype))
        for name, b in module.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return module
