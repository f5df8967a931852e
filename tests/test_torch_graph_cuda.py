"""The graphed training step (``train.step.GraphedTrainStep``) against the
eager ``train_step`` on the card, at tiny width. Marked ``cuda``: without a
GPU every test skips (a CUDA graph has no CPU mode). This file imports no
JAX: ``python -m pytest tests/test_torch_graph_cuda.py -m cuda``.

Held bit for bit, dropout on: every step's metrics and alignments, and the
parameters, gradients, batch statistics, Adam's moments and step counts
and the dropout generator's state after the run, over two batch shapes
interleaved (A, B, A, A, B: three of the five steps replay a graph), in f32
and in bf16 compute. Convolutions and index reductions run their
deterministic algorithms here: without them two eager f32 steps already
differ (cuDNN's f32 convolution weight gradients of the CBHG banks), and
nothing could be held bit for bit. Each graph holds one K1 node per
launch of the eager step (2 S with remat, S decoder steps) and one K2 node
per decoder step, and each replay adds those to ``runtime.LAUNCHES``.
A resume from the port's checkpoint after graphed steps continues the
uninterrupted graphed run bit for bit, whether the step restored into is
a new one or the one that captured graphs before the restore.
"""

import collections
import dataclasses

import pytest
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.ops.attn_energy import energy_bwd
from tacotron_tpu_torch.train import checkpoint, create_train_state, make_train_step, train_step
from tacotron_tpu_torch.train.step import GraphedTrainStep
from tacotron_tpu_torch.utils.profiling import graph_nodes

pytestmark = pytest.mark.cuda

SHAPES = {"A": (4, 11, 20), "B": (4, 9, 30)}     # B, T_in, T_out; r 5: 4 and 6 decoder steps
ORDER = "ABAAB"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    flags = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    runtime.build(("attn_energy",))
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = flags[0]
    torch.use_deterministic_algorithms(flags[1])


def _cfg(compute_dtype="float32"):
    base = get_config("tiny_cpu")
    return base.replace(
        model=dataclasses.replace(base.model, vocab_size=32, tf_decoder="hoisted",
                                  attention_energy="fused", remat_decoder=True,
                                  compute_dtype=compute_dtype),
        data=dataclasses.replace(base.data, num_buckets=2))


def _batch(cfg, dev, b, t_in, t_out, seed=0):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(t_in // 2, t_in + 1, (b,), generator=g)
    text = torch.randint(1, 30, (b, t_in), generator=g) * (torch.arange(t_in) < lengths[:, None])
    frames = torch.randint(t_out // 2, t_out + 1, (b,), generator=g)
    return [x.to(dev) for x in (text, lengths, torch.rand(b, t_out, cfg.model.n_mels, generator=g),
                                torch.rand(b, t_out, cfg.model.n_freq, generator=g), frames)]


def _state_of(state):
    """Copies of every tensor a step updates, by name, and the generator's
    state."""
    m, opt = state.model, state.opt
    out = {f"param {k}": p.detach() for k, p in m.named_parameters()}
    out.update({f"grad {k}": p.grad for k, p in m.named_parameters()})
    out.update({f"buffer {k}": b for k, b in m.named_buffers()})
    for k, p in m.named_parameters():
        out.update({f"adam {s} {k}": t for s, t in opt.state[p].items()})
    out = {k: v.clone() for k, v in out.items()}
    out["generator"] = state.generator.get_state()
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def interleaved(dev, request):
    """The graphed and the eager step over ORDER from one seeded state:
    (cfg, per call (shape, graphed, eager, launches), graphed state, eager
    state, the graphed step)."""
    cfg = _cfg(request.param)
    batches = {k: _batch(cfg, dev, *s, seed=i) for i, (k, s) in enumerate(SHAPES.items())}
    graphed, eager = create_train_state(cfg, seed=0), create_train_state(cfg, seed=0)
    step = make_train_step(cfg)
    assert isinstance(step, GraphedTrainStep)
    calls = []
    for k in ORDER:
        before = collections.Counter(runtime.LAUNCHES)
        graphed, m_g, a_g = step(graphed, *batches[k])
        launches = collections.Counter(runtime.LAUNCHES)
        launches.subtract(before)
        eager, m_e, a_e = train_step(eager, *batches[k], cfg=cfg)
        calls.append((k, (m_g, a_g), (m_e, a_e), +launches))
    torch.cuda.synchronize()
    return cfg, calls, graphed, eager, step


def test_graphed_step_is_bit_equal_to_eager(interleaved):
    cfg, calls, graphed, eager, step = interleaved
    assert graphed.step == eager.step == len(ORDER)
    for i, (k, (m_g, a_g), (m_e, a_e), _) in enumerate(calls):
        assert sorted(m_g) == sorted(m_e)
        for name in m_e:
            assert torch.equal(m_g[name], m_e[name]), (i, k, name)
        assert torch.equal(a_g, a_e), (i, k)
    _assert_same(_state_of(graphed), _state_of(eager))
    # both shapes captured: A at its second step, B at its second
    assert sorted(v is not None for v in step.graphs.values()) == [True, True]


def test_graph_holds_k1_k2_nodes_and_counts_them_per_replay(interleaved):
    cfg, calls, _, _, step = interleaved
    r = cfg.model.r
    for k, *_, launches in calls:
        s = SHAPES[k][2] // r
        assert launches == {"attn_energy_fwd": 2 * s, "attn_energy_bwd": s}, (k, launches)
    for entry in step.graphs.values():
        s = entry.inputs[2].shape[1] // r
        nodes = graph_nodes(entry.graph)
        got = {kern: sum(n for name, n in nodes.items() if kern in name)
               for kern in ("energy_fwd", "energy_bwd")}
        assert got == {"energy_fwd": 2 * s, "energy_bwd": s}, got
        assert entry.launches == {"attn_energy_fwd": 2 * s, "attn_energy_bwd": s}
        assert entry.capture_s > 0 and entry.instantiate_s > 0 and entry.pool_bytes > 0


def test_resume_after_graphed_steps_is_bit_identical(dev, tmp_path):
    """Five graphed steps, a checkpoint after the third; the last two again
    from a restore into a new state with a new step, and into the old
    state with the step that captured its graphs before the restore
    (which must drop them: the restore replaced Adam's state)."""
    cfg = _cfg()
    batch = _batch(cfg, dev, *SHAPES["A"])
    state, step = create_train_state(cfg, seed=0), make_train_step(cfg)
    ckpt = str(tmp_path / "ckpt")
    tail = []
    for i in range(5):
        state, m, a = step(state, *batch)
        if i == 2:
            checkpoint.save(ckpt, 3, state, cfg.train)
        if i >= 3:
            tail.append((m, a))
    want = _state_of(state)

    fresh, _ = checkpoint.restore(ckpt, create_train_state(cfg, seed=1), cfg.train)
    state, _ = checkpoint.restore(ckpt, state, cfg.train)
    assert fresh.step == state.step == 3
    assert step.graphs[next(iter(step.graphs))] is not None
    for st, fn in ((fresh, make_train_step(cfg)), (state, step)):
        for i in range(2):
            st, m, a = fn(st, *batch)
            if i == 0:      # the restore's new tensors: an eager step, no graph yet
                assert list(fn.graphs.values()) == [None]
            assert all(torch.equal(m[k], tail[i][0][k]) for k in m) and torch.equal(a, tail[i][1])
        _assert_same(_state_of(st), want)


def test_capture_does_not_fill_the_energy_caches(dev):
    """K2's counter for a stream is made by an eager call on that stream,
    never inside a capture, where it would live in the graph's pool."""
    g = torch.Generator().manual_seed(0)
    keys, de = torch.randn(2, 5, 64, generator=g).to(dev), torch.randn(2, 5, generator=g).to(dev)
    q, v = torch.randn(2, 64, generator=g).to(dev), torch.randn(64, 1, generator=g).to(dev)
    energy_bwd(keys, q, v, de)            # the library and the residency table
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="not inside a CUDA graph capture"):
        with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            energy_bwd(keys, q, v, de)
