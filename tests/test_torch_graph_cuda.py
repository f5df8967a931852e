"""The graphed training step (``train.step.GraphedTrainStep``) and the
graphed synthesis (``infer.synthesize.Synthesizer``) against their eager
runs on the card, at tiny width. Marked ``cuda``: without a
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

Synthesis, dropout on, on the fixed-length path (fused: K3; step by step)
and the split path (early exit after step 20, inside the third of five
chunks; early exit that never trips, the last chunk partly past
``n_steps``; trimming alone; early exit with trimming; a silence
threshold above every peak, so that the exit and the trim do not depend
on the dropout masks): four calls of one shape (eager,
capture, replay, replay; seeds 1, 2, 1, 3) each bit-equal to an eager
call with its seed, the fixed path's one graph holding K3's one node and
K4's 3 per iteration, the step decode's kernel one node in the fixed decode
and in the chunk graph (whose other nodes are the chunk's 16 dropout draws',
as a capture of the draws alone holds them),
the split path's Griffin-Lim eager (no K4 node in
its graphs, K4's launches on every call); the graphs kept through an
in-place ``load_state_dict`` (the replay then equal to an eager call on
the new weights) and dropped when a weight's tensor moves. The split
path over six Griffin-Lim lengths, each seen again: each call within
GRAPH_SYNTH_ATOL of an eager call at the same seed and length, the shape
holding its model graphs and no other, and the memory the allocator
holds for graph pools the model graphs' pools, the same after every call.

The mesh paths over a 1-rank NCCL group in this process (the one group
that one card can hold): ``make_train_step(cfg, mesh)`` is graphed, and
over ORDER its steps are bit-equal to the one-process graphed step and
to the eager mesh step, in f32 and bf16, each graph holding the K1/K2
nodes of the one-process graph of its shape; ``Synthesizer(mesh=...)``
replays a model graph and a Griffin-Lim graph (K4's 3 nodes per
iteration) per shape, each call bit-equal to an eager call without a
mesh.
"""

import collections
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.config import get_config
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.infer import Synthesizer
from tacotron_tpu_torch.infer.early_exit import DECODE_CHUNK
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.ops.attn_energy import energy_bwd
from tacotron_tpu_torch.train import checkpoint, create_train_state, make_train_step, train_step
from tacotron_tpu_torch.train.step import GraphedTrainStep
from tacotron_tpu_torch.utils.profiling import graph_nodes
from tacotron_tpu_torch.weights import init_params, split_state

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


# ------------------------------------------------------------------ synthesis

PROMPTS = ["hello world", "a test of the graphs", "graphs"]
SYNTH_STEPS, SYNTH_GL = 40, 3          # 40 decoder steps: 5 chunks of 8
SEEDS = (1, 2, 1, 3)                   # eager, capture + replay, replay, replay
# every frame silent: the exit comes after min_silence_frames / r = 20 steps
# and every end frame is 0, whatever the masks
SILENT = {"silence_threshold": 1e9, "min_silence_frames": 100, "gl_length_quantum": 8}
SYNTH_PATHS = {
    "fused": (True, {}),
    "step": (False, {}),
    "exit": (False, {"early_exit": True, **SILENT}),
    "exit_never": (False, {"early_exit": True, "silence_threshold": -1.0}),
    "trim": (False, {"trim_before_gl": True, **SILENT}),
    "exit_trim": (False, {"early_exit": True, "trim_before_gl": True, **SILENT}),
}


def _synth_cfg(**infer):
    base = get_config("tiny_cpu")
    return base.replace(
        audio=dataclasses.replace(base.audio, n_fft=512, win_length=400, hop_length=128,
                                  griffin_lim_iters=SYNTH_GL),
        model=dataclasses.replace(base.model, vocab_size=40, n_freq=257,
                                  max_decode_steps=SYNTH_STEPS),
        infer=dataclasses.replace(base.infer, **infer))


def _outputs(out):
    return {k: out[k] for k in ("mel", "linear", "alignments", "wavs", "end_frames")}


@pytest.fixture(scope="module")
def synth_state(dev):
    runtime.build(("decode_chunk", "decode_loop", "griffin_lim"))
    model = init_params(Tacotron(_synth_cfg().model, device=dev), seed=0)
    return split_state(model), Vocab.build(PROMPTS)


@pytest.fixture(scope="module", params=list(SYNTH_PATHS))
def synth_calls(synth_state, request):
    """One path's Synthesizer over SEEDS (graphed) and an eager Synthesizer
    (``stage_ms=True``) on the same seeds: (name, synthesizer, per call
    (graphed outputs, eager outputs, launches of the graphed call))."""
    (p, bs), vocab = synth_state
    fused, infer = SYNTH_PATHS[request.param]
    cfg = _synth_cfg(**infer)
    synth = Synthesizer(cfg, p, bs, vocab, fused=fused)
    eager = Synthesizer(cfg, p, bs, vocab, fused=fused)
    calls = []
    for seed in SEEDS:
        before = collections.Counter(runtime.LAUNCHES)
        got = synth(PROMPTS, seed=seed)
        launches = collections.Counter(runtime.LAUNCHES)
        launches.subtract(before)
        want = eager(PROMPTS, seed=seed, stage_ms=True)
        calls.append((got, want, +launches))
    return request.param, synth, calls


def test_graphed_synthesis_is_bit_equal_to_eager(synth_calls):
    name, synth, calls = synth_calls
    assert [got["graphed"] for got, _, _ in calls] == [False, True, True, True]
    for i, (got, want, _) in enumerate(calls):
        assert want["graphed"] is False
        for k, v in _outputs(want).items():
            assert np.array_equal(got[k], v), (name, i, k)
    r = calls[0][0]["mel"].shape[1] // SYNTH_STEPS
    for got, *_ in calls:
        live = np.abs(got["mel"]).max(axis=(0, 2)) > 0
        t_gl = got["wavs"].shape[1] // synth.cfg.audio.hop_length + 1
        exit_step = 20 if name in ("exit", "exit_trim") else SYNTH_STEPS
        assert live[:exit_step * r].all() and not live[exit_step * r:].any(), name
        assert t_gl == (8 if "trim" in name else SYNTH_STEPS * r), name
    # the same seed, the same masks: calls 1 and 3
    assert all(np.array_equal(calls[0][0][k], calls[2][0][k]) for k in _outputs(calls[0][0]))
    assert not np.array_equal(calls[0][0]["mel"], calls[1][0]["mel"])


def test_synthesis_graphs_hold_k3_and_k4(synth_calls):
    """Each path's graphs and launches: K3 in the fused "synth" graph, K4 in
    the fixed path's; the step decode's kernel once in the fixed decode (40
    steps, one launch) and once a replay in the early exit's chunk graph,
    whose other nodes are those of the chunk's 16 dropout draws."""
    name, synth, calls = synth_calls
    fused, exits = synth.fused, synth.cfg.infer.early_exit
    chunks = (20 if name in ("exit", "exit_trim") else SYNTH_STEPS) // DECODE_CHUNK + (
        name in ("exit", "exit_trim"))
    per_call = {"griffin_lim": 3 * SYNTH_GL, "decode_loop" if fused else "decode_chunk":
                chunks if exits else 1}
    assert all(launches == per_call for *_, launches in calls), name
    (entry,) = synth.graphs.values()
    graphs = dict(entry.captured())
    want = (["synth"] if not synth.split else
            ["preamble", *(["chunk"] if exits else []), "postnet"])
    assert sorted(graphs) == sorted(want)
    step_decode = {} if fused else {"decode_chunk": 1}
    launches = {"synth": {**per_call, **({"decode_loop": 1} if fused else step_decode)},
                "preamble": {} if exits else step_decode, "chunk": step_decode, "postnet": {}}
    for g_name, g in graphs.items():
        nodes = graph_nodes(g.graph)
        k3 = sum(n for k, n in nodes.items() if "decode_loop_kernel" in k)
        k4 = sum(n for k, n in nodes.items() if "gl_wgmma" in k or "gl_ola_frame" in k)
        gl = g_name == "synth"
        assert (k3, k4) == (int(fused and gl), 3 * SYNTH_GL if gl else 0), (name, g_name, nodes)
        assert dict(g.launches) == launches[g_name], (name, g_name)
        assert sum(n for k, n in nodes.items() if "decode_chunk_kernel" in k) == (
            g.launches.get("decode_chunk", 0)), (name, g_name, nodes)
        assert g.capture_s > 0 and g.instantiate_s > 0 and g.pool_bytes >= 0
    if "chunk" in graphs:
        loop = graphs["preamble"].outputs
        assert loop.chunk == DECODE_CHUNK
        # the chunk graph: the kernel's one launch and the nodes of the
        # chunk's 16 dropout draws, as a capture of the draws alone holds them
        with torch.cuda.stream(synth._stream):
            draws = graph_nodes(runtime.capture_graph(loop.draw_masks, synth._stream,
                                                      synth._gen).graph)
        assert sum(n for k, n in draws.items() if "distribution" in k) == 2 * DECODE_CHUNK
        nodes = graph_nodes(graphs["chunk"].graph)
        step = [k for k in nodes if "decode_chunk_kernel" in k]
        assert len(step) == 1 and nodes == draws + collections.Counter({step[0]: 1}), (nodes, draws)


def test_synthesis_graphs_follow_the_weights(synth_state):
    (p, bs), vocab = synth_state
    cfg = _synth_cfg(early_exit=True, trim_before_gl=True, gl_length_quantum=8)
    synth = Synthesizer(cfg, p, bs, vocab)
    for seed in (1, 2):
        synth(PROMPTS, seed=seed)
    (entry,) = synth.graphs.values()
    captured = dict(entry.captured())
    new = {k: v + 0.01 * torch.randn_like(v) if v.is_floating_point() else v
           for k, v in synth.model.state_dict().items()}
    synth.model.load_state_dict(new)              # copied in place: the graphs stay
    got = synth(PROMPTS, seed=4)
    assert got["graphed"] is True and dict(next(iter(synth.graphs.values())).captured()) == captured
    eager = Synthesizer(cfg, *split_state(synth.model), vocab)(PROMPTS, seed=4, stage_ms=True)
    for k, v in _outputs(eager).items():
        assert np.array_equal(got[k], v), k
    w = synth.model.postnet.linear_proj.weight
    w.data = w.data.clone()                       # a weight at a new address
    again = synth(PROMPTS, seed=4)
    assert again["graphed"] is False
    assert [e.captured() for e in synth.graphs.values()] == [[]]
    for k, v in _outputs(eager).items():
        assert np.array_equal(again[k], v), k


class _LengthSet(Synthesizer):
    """The split path with the Griffin-Lim length set by the caller
    (``t_gl``), in place of the one a trained model's end frames give
    (random weights give every call the same)."""

    t_gl = None

    def _t_gl(self, ends, frames):
        return self.t_gl


GRAPH_SYNTH_ATOL = 1e-5       # chip_smoke.py's: a graphed call against an eager one
# six lengths, each seen again, some more than twice
GL_ORDER = (8, 16, 24, 32, 40, 48, 8, 16, 24, 32, 40, 48, 24, 8, 40)


def _graph_pool_bytes(dev) -> int:
    """Bytes the caching allocator reserves for CUDA graph pools (every
    segment outside the default pool), freed or not."""
    return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
               if seg.get("device", dev.index) == dev.index
               and tuple(seg["segment_pool_id"]) != (0, 0))


def test_split_path_keeps_no_gl_graph_over_many_lengths(dev, synth_state):
    (p, bs), vocab = synth_state
    cfg = _synth_cfg(trim_before_gl=True)
    synth, eager = _LengthSet(cfg, p, bs, vocab), _LengthSet(cfg, p, bs, vocab)
    torch.cuda.empty_cache()
    base = _graph_pool_bytes(dev)        # the pools of other tests' graphs still alive
    held = []
    for i, t in enumerate(GL_ORDER):
        synth.t_gl = eager.t_gl = t
        got = synth(PROMPTS, seed=i)
        want = eager(PROMPTS, seed=i, stage_ms=True)
        assert got["graphed"] is (i > 0), (i, t)
        assert got["wavs"].shape[1] == cfg.audio.hop_length * (t - 1)
        for k, v in _outputs(want).items():
            np.testing.assert_allclose(got[k], v, atol=GRAPH_SYNTH_ATOL, err_msg=f"{i} {t} {k}")
        (entry,) = synth.graphs.values()
        graphs = dict(entry.captured())
        assert sorted(graphs) == ([] if i == 0 else ["postnet", "preamble"]), (i, t)
        held.append(_graph_pool_bytes(dev) - base)
        assert held[-1] <= sum(g.pool_bytes for g in graphs.values()), (i, t, held[-1])
        del entry, graphs
    assert held[2:] == [held[1]] * (len(held) - 2), held


# ------------------------------------------------------- a mesh over NCCL

@pytest.fixture(scope="module")
def nccl_mesh(dev, tmp_path_factory):
    """A mesh over a 1-rank NCCL group in this process: NCCL refuses two
    processes on one card, so one rank is all that one card can hold, and
    it runs every collective of the mesh paths (a 1-rank reduction is a
    copy)."""
    import torch.distributed as dist

    from tacotron_tpu_torch.parallel import make_mesh

    rdv = tmp_path_factory.mktemp("nccl") / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{rdv}", world_size=1, rank=0)
    mesh = make_mesh(get_config("tiny_cpu").mesh)
    assert dist.get_backend(mesh.data_group) == "nccl" and mesh.capturable
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mesh_interleaved(nccl_mesh, request):
    """Over ORDER from one seeded state each: the one-process graphed step,
    ``make_train_step(cfg, mesh)`` and the eager mesh step -> (cfg, per
    call {run: (metrics, alignments)} and the mesh step's launches, the
    three states, the one-process step, the mesh step)."""
    cfg = _cfg(request.param)
    dev = nccl_mesh.device
    batches = {k: _batch(cfg, dev, *s, seed=i) for i, (k, s) in enumerate(SHAPES.items())}
    one, graphed = make_train_step(cfg), make_train_step(cfg, nccl_mesh)
    steps = {"one": one, "mesh": graphed,
             "eager": functools.partial(train_step, cfg=cfg, mesh=nccl_mesh)}
    states = {"one": create_train_state(cfg, seed=0),
              **{k: create_train_state(cfg, seed=0, mesh=nccl_mesh) for k in ("mesh", "eager")}}
    calls = []
    for k in ORDER:
        call = {}
        for run, fn in steps.items():
            before = collections.Counter(runtime.LAUNCHES)
            states[run], m, a = fn(states[run], *batches[k])
            if run == "mesh":
                launches = collections.Counter(runtime.LAUNCHES)
                launches.subtract(before)
            call[run] = (m, a)
        calls.append((k, call, +launches))
    torch.cuda.synchronize()
    return cfg, calls, states, one, graphed


def test_nccl_mesh_step_is_graphed_and_bit_equal(mesh_interleaved):
    """The mesh step over NCCL is a GraphedTrainStep; its steps (eager,
    capture + replay, replay per shape) are bit-equal to the one-process
    graphed step and to the eager mesh step, and so are the states."""
    cfg, calls, states, one, graphed = mesh_interleaved
    assert isinstance(graphed, GraphedTrainStep) and graphed.mesh is not None
    for i, (k, call, _) in enumerate(calls):
        for run in ("mesh", "eager"):
            m, a = call[run]
            assert sorted(m) == sorted(call["one"][0])
            for name, v in call["one"][0].items():
                assert torch.equal(m[name], v), (i, k, run, name)
            assert torch.equal(a, call["one"][1]), (i, k, run)
    want = _state_of(states["one"])
    for run in ("mesh", "eager"):
        _assert_same(_state_of(states[run]), want)
    assert all(v is not None for v in graphed.graphs.values()) and len(graphed.graphs) == 2


def test_nccl_mesh_graph_holds_k1_k2_and_counts_them(mesh_interleaved):
    """Each shape's mesh graph holds the K1/K2 nodes of the one-process
    graph of that shape, and each replay counts them."""
    cfg, calls, _, one, graphed = mesh_interleaved
    r = cfg.model.r
    for k, _, launches in calls:
        s = SHAPES[k][2] // r
        assert launches == {"attn_energy_fwd": 2 * s, "attn_energy_bwd": s}, (k, launches)
    for key, entry in graphed.graphs.items():
        s = entry.inputs[2].shape[1] // r
        nodes = graph_nodes(entry.graph)
        ref = graph_nodes(one.graphs[(key[0], None, *key[2:])].graph)
        for kern in ("energy_fwd", "energy_bwd"):
            got = sum(n for name, n in nodes.items() if kern in name)
            assert got == sum(n for name, n in ref.items() if kern in name) == (
                s if kern == "energy_bwd" else 2 * s), (kern, got)
        assert entry.launches == {"attn_energy_fwd": 2 * s, "attn_energy_bwd": s}


def test_nccl_mesh_synthesis_replays_model_and_gl_graphs(synth_state, nccl_mesh):
    """``Synthesizer(mesh=...)`` over NCCL: eager, capture + replay, replay,
    replay, each bit-equal to an eager call without a mesh at its seed;
    two graphs per shape, the model's (no K4) and Griffin-Lim's (K4's 3
    nodes per iteration); the gather after them."""
    (p, bs), vocab = synth_state
    cfg = _synth_cfg()
    synth = Synthesizer(cfg, p, bs, vocab, mesh=nccl_mesh)
    eager = Synthesizer(cfg, p, bs, vocab)
    # the model graph's fixed decode (40 steps) is one launch of the step decode's kernel
    per_call = {"griffin_lim": 3 * SYNTH_GL, "decode_chunk": 1}
    for i, seed in enumerate(SEEDS):
        before = collections.Counter(runtime.LAUNCHES)
        got = synth(PROMPTS, seed=seed)
        launches = collections.Counter(runtime.LAUNCHES)
        launches.subtract(before)
        want = eager(PROMPTS, seed=seed, stage_ms=True)
        assert got["graphed"] is (i > 0) and +launches == per_call, (i, launches)
        for k, v in _outputs(want).items():
            assert np.array_equal(got[k], v), (i, k)
    (entry,) = synth.graphs.values()
    graphs = dict(entry.captured())
    assert sorted(graphs) == ["gl", "model"]
    for name, g in graphs.items():
        nodes = graph_nodes(g.graph)
        k4 = sum(n for k, n in nodes.items() if "gl_wgmma" in k or "gl_ola_frame" in k)
        assert k4 == (3 * SYNTH_GL if name == "gl" else 0), (name, nodes)
        assert dict(g.launches) == ({"griffin_lim": 3 * SYNTH_GL} if name == "gl"
                                    else {"decode_chunk": 1}), name
