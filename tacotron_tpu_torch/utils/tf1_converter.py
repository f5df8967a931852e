"""TF1 reference checkpoint -> parameter trees of the port.

The port of the JAX package's ``utils/tf1_converter.py``, in numpy and
``re`` only. It maps the variable names of a TF1 checkpoint of the
reference implementation (barronalex/Tacotron) onto flax-layout parameter
trees, so that weights trained there can be loaded without retraining.

The target trees come from the port's own modules, and the result loads
back through the parameter bridge::

    tree = weights.to_flax(*weights.split_state(model))
    out = convert(tf_vars, tree["params"], tree.get("batch_stats"))
    p, s = weights.from_flax({"params": out["params"],
                              "batch_stats": out["batch_stats"]})
    model.load_state_dict({**p, **s})

Every NAME_TABLE entry is a (regex, resolver) pair where the resolver
returns concrete ``(collection, path, array)`` assignments into the trees.
``convert()`` produces loaded params/batch_stats trees; anything it cannot
place is listed, never guessed.

Name model: the tf.contrib-era scoping the reference's graph builders
produce (BahdanauAttention + AttentionWrapper + OutputProjectionWrapper +
ResidualWrapper under dynamic_rnn; conv banks / highway nets built in loops
with enumerated scopes). No reference checkpoint is in the repository, so
the exact scopes are unverified: the patterns accept any prefix and key on
the distinguishing scope tail, and a synthetic round trip
(``tests/test_torch_tf1_converter.py``) pins each pattern.

Weight-layout facts the transforms rely on:
  * TF1 ``GRUCell`` stores fused ``[x, h] @ W`` kernels, the decoder GRUs'
    ("gates"/"candidate") layout, so decoder-side GRUs copy verbatim; the
    encoder/postnet biGRUs use the hoisted-scan layout (``ops/gru._ScanGRU``:
    gates_x/gates_h split at d_in), so those kernels are row-split.
  * TF dense kernels are (in, out), as the flax-layout trees hold them.
  * TF conv1d kernels are (width, in, out), likewise.
  * TF batch_normalization: gamma/beta -> bn scale/bias (params);
    moving_mean/moving_variance -> batch_stats mean/var.

No TensorFlow is needed: ``convert()`` takes any {name: ndarray} dict
(e.g. written offline by ``tf.train.load_checkpoint`` + ``np.savez``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# tree plumbing (plain nested dicts of arrays)

def _get(tree, path: str):
    node = tree
    for k in path.split("/"):
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def _set(tree, path: str, value) -> bool:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    if not isinstance(node, dict) or keys[-1] not in node:
        return False
    node[keys[-1]] = value
    return True


# ---------------------------------------------------------------------------
# resolvers: (match, array, ctx) -> list[(collection, path, array)]
# collection is "params" or "batch_stats".

@dataclass
class _Ctx:
    params: dict
    batch_stats: dict
    assigned: set = field(default_factory=set)
    tf_names: frozenset = frozenset()
    _cell_map: dict | None = None

    def decoder_cell(self, cell_id: str) -> str | None:
        """Map a TF1 ``cell_<N>`` index onto our decoder GRU names.

        Two scoping conventions exist in the wild: MultiRNNCell over
        [attention cell, res-GRU, res-GRU] numbers them cell_0..cell_2;
        when the attention cell is scoped under attention_wrapper instead,
        the residual GRUs appear as cell_0/cell_1. Decided ONCE from the
        full variable-name set (how many distinct numbered cells exist),
        never guessed per variable; out-of-range cells return None
        (-> unmatched_tf, not a crash)."""
        if self._cell_map is None:
            pat = re.compile(r"(?:.*/)?(?:multi_rnn_cell/)?cell_(\d+)/")
            ids = sorted({int(m.group(1)) for n in self.tf_names
                          if (m := pat.match(n))})
            if ids == [0, 1]:
                self._cell_map = {"0": "decoder_gru0", "1": "decoder_gru1"}
            elif ids == [0, 1, 2]:
                self._cell_map = {"0": "attention_gru",
                                  "1": "decoder_gru0", "2": "decoder_gru1"}
            else:               # unknown topology: match nothing
                self._cell_map = {}
        return self._cell_map.get(cell_id)

    def gru_split(self, base: str, kind: str, arr: np.ndarray):
        """Row-split a fused TF [x, h] kernel into the _ScanGRU hoisted layout
        (gates_x/gates_h or cand_x/cand_h) at d_in inferred from our shapes."""
        x_leaf = _get(self.params, f"{base}/{kind}_x/kernel")
        if x_leaf is None:
            return None
        d_in = x_leaf.shape[0]
        return [("params", f"{base}/{kind}_x/kernel", arr[:d_in]),
                ("params", f"{base}/{kind}_h/kernel", arr[d_in:])]


def _scope(m: re.Match) -> str:
    """'enc'|'post' from the pattern's scope group (encoder CBHG vs post-CBHG)."""
    return "postnet" if "post" in (m.group("scope") or "") else "encoder"


def _direct(path_fmt):
    def r(m, arr, ctx):
        return [("params", path_fmt.format(**m.groupdict()), arr)]
    return r


def _cbhg(path_fmt):
    """CBHG-scoped direct assign: {cbhg} expands to encoder/cbhg | postnet/cbhg."""
    def r(m, arr, ctx):
        d = {k: v for k, v in m.groupdict().items() if v is not None}
        return [("params", path_fmt.format(cbhg=f"{_scope(m)}/cbhg", **d), arr)]
    return r


def _bn(m, arr, ctx):
    field_map = {"gamma": ("params", "scale"), "beta": ("params", "bias"),
                 "moving_mean": ("batch_stats", "mean"),
                 "moving_variance": ("batch_stats", "var")}
    coll, leaf = field_map[m.group("field")]
    where = m.group("where")          # bank conv index or proj index
    if m.group("kind") == "bank":
        path = f"{_scope(m)}/cbhg/bank/bn{where}/bn/{leaf}"
    else:
        path = f"{_scope(m)}/cbhg/proj/bn{where}/bn/{leaf}"
    return [(coll, path, arr)]


def _bigru(m, arr, ctx):
    d = "fwd" if m.group("dir") == "fw" else "bwd"
    base = f"{_scope(m)}/cbhg/bigru/{d}"
    kind = "gates" if m.group("part") == "gates" else "cand"
    if m.group("leaf") == "kernel":
        return ctx.gru_split(base, kind, arr)
    return [("params", f"{base}/{kind}_x/bias", arr)]   # biases ride the x half


def _dec_gru(m, arr, ctx):
    cid = m.group("cell")
    cell = ("attention_gru" if cid == "attention"
            else ctx.decoder_cell(cid))
    if cell is None:           # cell index outside the known topologies
        return None            # -> unmatched_tf, never a KeyError
    part = "gates" if m.group("part") == "gates" else "candidate"
    return [("params",
             f"decoder/cell/{cell}/{part}/{m.group('leaf')}", arr)]


def _by_shape(candidates):
    """Disambiguate generic dense names by matching our leaf's shape."""
    def r(m, arr, ctx):
        for path in candidates:
            leaf = _get(ctx.params, path.format(**m.groupdict()))
            if leaf is not None and tuple(leaf.shape) == tuple(arr.shape) \
                    and path.format(**m.groupdict()) not in ctx.assigned:
                return [("params", path.format(**m.groupdict()), arr)]
        return None
    return r


# Each entry: (compiled regex on the TF1 variable name, resolver).
# Order matters: first match wins, most specific first.
NAME_TABLE = [
    # --- embedding ------------------------------------------------------
    (r"(?:.*/)?embedding(?:/weights|/embedding)?$",
     _direct("encoder/embed/embedding")),

    # --- prenets (decoder scope first — its pattern is the specific one) -
    (r"(?:.*/)?decoder.*prenet/dense(?:_(?P<i>\d+))?/(?P<leaf>kernel|bias)$",
     lambda m, a, c: [("params",
                       f"decoder/cell/prenet/fc{int(m.group('i') or 0)}/{m.group('leaf')}", a)]),
    (r"(?!.*decoder).*prenet/dense(?:_(?P<i>\d+))?/(?P<leaf>kernel|bias)$",
     lambda m, a, c: [("params",
                       f"encoder/prenet/fc{int(m.group('i') or 0)}/{m.group('leaf')}", a)]),

    # --- conv banks (scope group distinguishes encoder vs post CBHG) ----
    (r"(?:.*/)?(?P<scope>\w*(?:post)?\w*cbhg[^/]*)/conv1d_banks/(?:num_|conv1d_)(?P<k>\d+)/(?:conv1d/)?kernel$",
     _cbhg("{cbhg}/bank/conv{k}/kernel")),
    (r"(?:.*/)?(?P<scope>\w*(?:post)?\w*cbhg[^/]*)/conv1d_banks/(?:num_|conv1d_)(?P<where>\d+)/batch_normalization/(?P<field>gamma|beta|moving_mean|moving_variance)$",
     lambda m, a, c: _bn(_FakeBN(m, "bank"), a, c)),
    # conv projections + their BN
    (r"(?:.*/)?(?P<scope>\w*(?:post)?\w*cbhg[^/]*)/conv1d_proj(?:ections)?_?(?P<k>\d+)/(?:conv1d/)?kernel$",
     _cbhg("{cbhg}/proj/proj{k}/kernel")),
    (r"(?:.*/)?(?P<scope>\w*(?:post)?\w*cbhg[^/]*)/conv1d_proj(?:ections)?_?(?P<where>\d+)/batch_normalization/(?P<field>gamma|beta|moving_mean|moving_variance)$",
     lambda m, a, c: _bn(_FakeBN(m, "proj"), a, c)),

    # --- highway stack (dense = H, dense_1 = T; optional resize) --------
    (r"(?:.*/)?(?P<scope>\w*(?:post)?\w*cbhg[^/]*)/highwaynet_(?P<i>\d+)/dense/(?P<leaf>kernel|bias)$",
     _cbhg("{cbhg}/highway/H{i}/{leaf}")),
    (r"(?:.*/)?(?P<scope>\w*(?:post)?\w*cbhg[^/]*)/highwaynet_(?P<i>\d+)/dense_1/(?P<leaf>kernel|bias)$",
     _cbhg("{cbhg}/highway/T{i}/{leaf}")),
    (r"(?:.*/)?(?P<scope>\w*(?:post)?\w*cbhg[^/]*)/highway_resize/(?P<leaf>kernel|bias)$",
     _cbhg("{cbhg}/highway/resize/{leaf}")),

    # --- CBHG biGRU (hoisted split layout on our side) ------------------
    (r"(?:.*/)?(?P<scope>\w*(?:post)?\w*cbhg[^/]*)/bidirectional_rnn/(?P<dir>fw|bw)/gru_cell/(?P<part>gates|candidate)/(?P<leaf>kernel|bias)$",
     _bigru),

    # --- attention ------------------------------------------------------
    (r"(?:.*/)?memory_layer/kernel$", _direct("memory_proj/kernel")),
    (r"(?:.*/)?bahdanau_attention/query_layer/kernel$",
     _direct("decoder/cell/attention/query/kernel")),
    (r"(?:.*/)?(?:bahdanau_attention/)?attention_v$",
     lambda m, a, c: [("params", "decoder/cell/attention/v",
                       a.reshape(-1, 1))]),   # TF stores (dim,); ours (dim, 1)

    # --- decoder cells (fused TF kernels copy verbatim) -----------------
    (r"(?:.*/)?attention_wrapper/(?:cell/)?gru_cell/(?P<part>gates|candidate)/(?P<leaf>kernel|bias)$",
     lambda m, a, c: _dec_gru(_FakeCell(m, "attention"), a, c)),
    (r"(?:.*/)?(?:multi_rnn_cell/)?cell_(?P<cell>\d+)/(?:residual_wrapper/)?gru_cell/(?P<part>gates|candidate)/(?P<leaf>kernel|bias)$",
     _dec_gru),
    (r"(?:.*/)?decoder.*(?:input|output)_projection[^/]*/(?P<leaf>kernel|bias)$",
     _direct("decoder/cell/decoder_input_proj/{leaf}")),

    # --- output denses, disambiguated by shape --------------------------
    (r"(?:.*/)?dense(?:_\d+)?/(?P<leaf>kernel|bias)$",
     _by_shape(["decoder/cell/frame_proj/{leaf}", "postnet/linear_proj/{leaf}"])),
]


class _FakeBN:
    """Adapter: reuses _bn for both bank and proj patterns by injecting the
    'kind' group the shared resolver expects."""

    def __init__(self, m: re.Match, kind: str):
        self._m, self._kind = m, kind

    def group(self, name):
        if name == "kind":
            return self._kind
        return self._m.group(name)


class _FakeCell:
    def __init__(self, m: re.Match, cell: str):
        self._m, self._cell = m, cell

    def group(self, name):
        if name == "cell":
            return self._cell
        return self._m.group(name)


def split_tf_gru_kernel(kernel: np.ndarray, d_in: int):
    """TF fused [x, h] @ W kernel -> (x-part, h-part) matching ops/gru layout."""
    return kernel[:d_in], kernel[d_in:]


def convert(tf_vars: dict[str, np.ndarray], target_params,
            target_batch_stats=None) -> dict:
    """Map a {tf1_name: ndarray} dict onto our pytrees.

    Returns {params, batch_stats, matched: {tf_name: [paths]},
    unmatched_tf: [names], unmatched_ours: [paths], errors: {tf_name: msg}}.
    params/batch_stats are deep copies of the targets with every matched
    leaf replaced; shapes are validated before assignment — a shape mismatch
    is an error entry, never a silent mis-assign.
    """
    def to_plain(t):
        if t is None:
            return {}
        return {k: to_plain(v) if isinstance(v, dict) else np.array(v, copy=True)
                for k, v in t.items()}

    params = to_plain(target_params)
    batch_stats = to_plain(target_batch_stats)
    trees = {"params": params, "batch_stats": batch_stats}
    ctx = _Ctx(params=params, batch_stats=batch_stats,
               tf_names=frozenset(tf_vars))

    compiled = [(re.compile(pat), res) for pat, res in NAME_TABLE]
    matched: dict[str, list[str]] = {}
    unmatched_tf: list[str] = []
    errors: dict[str, str] = {}

    for name in sorted(tf_vars):
        arr = np.asarray(tf_vars[name])
        out = None
        for pat, resolver in compiled:
            m = pat.match(name)
            if m is None:
                continue
            out = resolver(m, arr, ctx)
            if out is not None:
                break
        if not out:
            unmatched_tf.append(name)
            continue
        # validate EVERY target first, assign only if all pass: a multi-
        # target resolver (e.g. gru_split) must never leave a half-written
        # kernel behind on a late shape mismatch
        staged = []
        err = None
        for coll, path, value in out:
            tgt = _get(trees[coll], path)
            if tgt is None:
                err = f"no such leaf: {coll}:{path}"
                break
            if tuple(np.shape(tgt)) != tuple(value.shape):
                err = (f"shape mismatch at {coll}:{path}: "
                       f"ours {np.shape(tgt)} vs tf {value.shape}")
                break
            staged.append((coll, path, value.astype(np.asarray(tgt).dtype)))
        if err is not None:
            errors[name] = err
            continue
        paths = []
        for coll, path, value in staged:
            _set(trees[coll], path, value)
            ctx.assigned.add(path)
            paths.append(f"{coll}:{path}")
        matched[name] = paths

    def all_paths(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
            if isinstance(v, dict):
                yield from all_paths(v, p)
            else:
                yield p

    covered = ctx.assigned
    unmatched_ours = [f"params:{p}" for p in all_paths(params) if p not in covered]
    unmatched_ours += [f"batch_stats:{p}" for p in all_paths(batch_stats)
                       if p not in covered]

    return {
        "params": params,
        "batch_stats": batch_stats,
        "matched": matched,
        "unmatched_tf": unmatched_tf,
        "unmatched_ours": unmatched_ours,
        "errors": errors,
    }
