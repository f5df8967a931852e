"""The training step: teacher-forced forward, L1 losses, backward, update.

Port of the JAX package's ``train/step.py``. JAX's step is a pure function
of an immutable state; here the state holds PyTorch objects that the step
updates in place (parameters and batch statistics in the model, the Adam
moments in the optimizer, the dropout generator), and ``train_step``
returns it with the update count advanced. ``cfg.model.compute_dtype``
"bfloat16" runs the products in bf16 (``ops/modules.py``) while the
parameters, their gradients and the Adam moments stay f32, as in JAX.

JAX compiles its step once per bucket shape (``jax.jit`` with the state
donated; on a mesh with ``in_shardings``/``out_shardings``, the gradient
all-reduce inside the program). The port's counterpart is
``GraphedTrainStep``, which ``make_train_step`` returns in one process and
on a mesh whose collectives can be captured (NCCL groups,
``parallel.collectives.capturable``): on a CUDA device each shape's first
step runs eagerly, later steps of that shape replay one captured CUDA
graph, the mesh's collectives inside it; a state on the CPU runs the eager
step.
``train_step`` stays the eager function, as JAX's ``train_step`` stays the
pure function that ``jax.jit`` wraps, and is the plain version that the
graph is held against.

Data and tensor parallelism (``make_train_step(cfg, mesh)``): every rank
runs this step on its shard of the batch, and the step is that of the
global batch, as JAX's GSPMD step is one program whatever the mesh:
dropout masks drawn for the global batch, batch statistics over it
(``ops/modules.py``), the loss its mean (``train/loss.py``), the gradients
summed over the data group (one flat all-reduce after the backward), and
with tensor parallelism (``parallel/sharding.py``) the clipping norm taken
over every parameter once: the split ones' squares summed over the model
group. A mesh over gloo (the CPU, or several ranks on one card, which NCCL
refuses) runs the eager step: its collectives go through host copies,
which no graph can capture.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from tacotron_tpu_torch import runtime
from tacotron_tpu_torch.config import Config
from tacotron_tpu_torch.models.tacotron import Tacotron
from tacotron_tpu_torch.parallel import collectives
from tacotron_tpu_torch.parallel.sharding import shard_model
from tacotron_tpu_torch.runtime import resolve_device
from tacotron_tpu_torch.train.loss import tacotron_loss
from tacotron_tpu_torch.train.schedule import clip_and_step, make_optimizer, set_learning_rate
from tacotron_tpu_torch.utils import profiling
from tacotron_tpu_torch.weights import init_params

STAGES = ("forward", "backward", "optimizer")


class TrainState(NamedTuple):
    model: Tacotron                  # parameters and batch statistics
    opt: torch.optim.Adam            # Adam moments
    step: int                        # updates applied so far
    generator: torch.Generator       # dropout; advances with every step


def create_train_state(cfg: Config, seed: int = 0, device=None, mesh=None) -> TrainState:
    """Seeded random weights (``weights.init_params``) in training mode, a
    fresh Adam and a dropout generator on ``device`` (None: the GPU, or the
    mesh's device). With ``mesh`` every rank draws the same weights and the
    same generator, then keeps its shards (``sharding.shard_model``)."""
    dev = resolve_device(mesh.device if device is None and mesh is not None else device)
    model = init_params(Tacotron(cfg.model, device=dev), seed=seed).train()
    if mesh is not None:
        shard_model(model, mesh)
    opt = make_optimizer(model.parameters(), cfg.train)
    # a stream of its own, apart from the one init_params drew the weights from
    dropout_seed = int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    return TrainState(model, opt, 0, gen)


def _sharded_norm(model, grads_by_name) -> torch.Tensor:
    """The global norm of a tensor-parallel model's gradients: each split
    parameter's norm from its shards' squares summed over the model group,
    then as ``global_norm``."""
    norms = []
    for name, g in grads_by_name:
        n = torch.linalg.vector_norm(g.float())
        if name in model.tp_shards:
            n = torch.sqrt(collectives.all_reduce_(n * n, model.mesh.model_group))
        norms.append(n)
    return torch.linalg.vector_norm(torch.stack(norms))


def _reduce_gradients(params, group) -> None:
    """Sum every parameter's gradient over ``group``: one flat all-reduce."""
    grads = [p.grad for p in params]
    flat = collectives.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(cfg: Config, mesh=None):
    """The counterpart of JAX's jitted step, for states from
    ``create_train_state(cfg, ..., mesh=mesh)``. Called as ``step(state,
    text, text_len, mel_gt, linear_gt, frame_len) -> (state, metrics,
    alignments)``, it is:

    * in one process, and on a mesh whose collectives can be captured
      (``mesh.capturable``: NCCL groups, or none, as ``cli.train`` makes
      it for one process): a ``GraphedTrainStep``, which runs one CUDA
      graph per batch shape for a state on the card, the mesh's collectives
      inside it, and the eager ``train_step`` for a state on the CPU (there
      is no graph there);
    * on a mesh over gloo: ``train_step`` bound to ``cfg`` and ``mesh``,
      eager. gloo's collectives go through host copies, which no graph can
      capture.
    """
    if mesh is None or mesh.capturable:
        return GraphedTrainStep(cfg, mesh)
    return functools.partial(train_step, cfg=cfg, mesh=mesh)


def _check_state(state: TrainState, cfg: Config, mesh) -> torch.device:
    """-> the state's device; raises on a state built for another model or mesh."""
    model = state.model
    if model.cfg != cfg.model:
        raise ValueError("cfg.model differs from the configuration the state's model was built with")
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("the state was not created for this mesh: "
                         "create_train_state(cfg, seed, mesh=mesh)")
    return next(model.parameters()).device


def train_step(state: TrainState, text, text_len, mel_gt, linear_gt, frame_len,
               *, cfg: Config, mesh=None, stage_ms: bool = False):
    """One teacher-forced forward/backward/update on the state's device.

    Targets are cast to f32. Returns ``(state, metrics, alignments)``:
    ``metrics`` holds ``mel_loss``, ``linear_loss``, ``total_loss`` and
    ``grad_norm`` (of the unclipped gradients) as 0-d tensors on the device,
    and with ``stage_ms`` a ``stage_ms`` dict of forward / backward /
    optimizer milliseconds (device time by CUDA events, read after the step
    ends; the host clock on the CPU). With ``mesh`` the batch is this
    rank's shard and the metrics are the global batch's; every rank must
    call it. The step is one record of the stage clock
    (``utils.profiling``) when it is on.
    """
    dev = _check_state(state, cfg, mesh)
    with profiling.clock("train_step", dev, STAGES, force=stage_ms) as clock:
        set_learning_rate(state.opt, cfg.train, state.step)
        with profiling.span("eager"):
            metrics, alignments = _forward_backward_update(
                state, text, text_len, mel_gt, linear_gt, frame_len, cfg, mesh)
    if stage_ms:
        metrics["stage_ms"] = clock.record()["stage_ms"]
    return state._replace(step=state.step + 1), metrics, alignments


def _forward_backward_update(state, text, text_len, mel_gt, linear_gt, frame_len,
                             cfg: Config, mesh):
    """``train_step`` at the LR already set: what a CUDA graph captures (no
    host synchronisation, no host-side state but ``p.grad``), with the
    stage clock's marks of ``STAGES``. -> (metrics, alignments)."""
    model, opt = state.model, state.opt
    dev = next(model.parameters()).device
    text, text_len = text.to(dev), text_len.to(dev)
    mel_gt = mel_gt.to(dev, torch.float32)
    linear_gt = linear_gt.to(dev, torch.float32)
    if frame_len is not None:
        frame_len = frame_len.to(dev)
    profiling.mark(None)

    model.train()
    data_group = None if mesh is None else mesh.data_group
    gen = state.generator if mesh is None else mesh.batch_shard(state.generator)
    out = model(text, text_len, gt_mel=mel_gt, generator=gen)
    total, metrics = tacotron_loss(out.mel, out.linear, mel_gt, linear_gt, frame_len,
                                   mask_padding=cfg.train.mask_padding,
                                   linear_weight=cfg.train.loss_linear_weight,
                                   data_group=data_group)
    profiling.mark("forward")
    opt.zero_grad(set_to_none=True)
    total.backward()
    norm = None
    if data_group is not None:
        _reduce_gradients(list(model.parameters()), data_group)
        if model.tp_shards:
            norm = _sharded_norm(model, [(k, p.grad) for k, p in model.named_parameters()])
    profiling.mark("backward")
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = clip_and_step(opt, cfg.train, norm)
    profiling.mark("optimizer")
    return metrics, out.alignments.detach()


def _state_tensors(state: TrainState) -> tuple:
    """What a graph reads and writes in place in ``state``, by address: the
    parameters, buffers, Adam's state and LR tensors, and the generator."""
    opt = state.opt
    tensors = [*state.model.parameters(), *state.model.buffers(),
               *(t for st in opt.state.values() for t in st.values()
                 if isinstance(t, torch.Tensor)),
               *(g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor))]
    return (id(state.generator), *(t.data_ptr() for t in tensors))


@dataclasses.dataclass
class CapturedStep:
    """One shape's captured step and what a replay reads and returns."""

    graph: torch.cuda.CUDAGraph
    inputs: list                      # static batch tensors (None: no frame_len)
    metrics: dict                     # 0-d tensors the graph writes
    alignments: torch.Tensor
    grads: list                       # each parameter's .grad as the graph writes it
    launches: collections.Counter     # runtime.LAUNCHES of one replay
    capture_s: float                  # host seconds to record the graph
    instantiate_s: float              # host seconds to instantiate it
    pool_bytes: int                   # the private memory pool's growth during capture
    marks: list                       # the stage clock's event nodes (utils.profiling.mark)


class GraphedTrainStep:
    """``train_step`` as one CUDA graph per batch shape (``shape_key``), the
    counterpart of JAX's step jitted per bucket shape, on one CUDA device,
    and on each rank of a mesh whose collectives can be captured (NCCL):
    the gradient all-reduce, the global batch statistics and, with tensor
    parallelism, the split layers' collectives and the clipping norm's are
    captured with the rest, as JAX's sharded step holds them. A state on
    the CPU runs ``train_step`` itself: no graph, no shape. A state on the
    card with a mesh over gloo raises (``make_train_step`` gives such a
    mesh the eager step).

    The first step of a shape runs eagerly on the step's own stream: it is
    a real step, and it fills every lazy cache (Adam's state, K1/K2's
    library, residency table and K2's counter for that stream, cuBLAS's and
    cuDNN's workspaces) and issues every collective of the step, so that
    each NCCL communicator exists before a capture records its work. The
    next step of that shape captures the graph (``torch.cuda.graph``,
    thread-local capture mode, a private memory pool per shape, the dropout
    generator registered so that each replay draws the masks an eager step
    would) and replays it; later steps copy their batch into the graph's
    static inputs and replay. The LR is filled in
    before each replay (``set_learning_rate``) and the host ``step``
    advances as ``train_step``'s does. ``metrics`` and ``alignments`` come
    back as clones, so a caller may keep them past the next step.

    A replay runs what ``train_step`` runs: with deterministic algorithms
    (``torch.use_deterministic_algorithms``) it is bit-equal to it on the
    same state; with torch's defaults, as two eager steps do, it may differ
    in the last bits of atomically summed gradients. Graphs point
    at the state's tensors: when they are not those the graphs were
    captured on (a ``checkpoint.restore``, which replaces Adam's state, or
    another state), every graph is dropped and each shape's next step runs
    eagerly again. At most ``cfg.data.num_buckets`` shapes are served (the
    loader's buckets); another shape raises. A failed capture raises.

    ``runtime.LAUNCHES``: the capture's wrapper calls launch nothing, so
    their counts are taken back and added again on every replay
    (``runtime.capture_graph``, ``runtime.replay_graph``).
    ``graphs`` maps each shape seen to its ``CapturedStep`` (None after the
    shape's eager first step).

    Each step on the card is one record of the stage clock
    (``utils.profiling``) when it is on: the graph holds the marks of
    ``STAGES`` as event nodes, and host marks before and after a replay
    bound it. A replay re-records the graph's events, so a record is read
    before the next replay of its shape: with the clock on, the host waits
    there for the step before (the cost of the clock when on).
    """

    def __init__(self, cfg: Config, mesh=None):
        self.cfg, self.mesh = cfg, mesh
        self.max_shapes = cfg.data.num_buckets
        self.graphs: dict = {}
        self._stream = None
        self._bound = None            # _state_tensors of the state the graphs point at

    def shape_key(self, device, text, text_len, mel_gt, linear_gt, frame_len) -> tuple:
        """What one captured graph is valid for: the device, the shapes and
        dtypes of the batch (``frame_len`` None apart from any tensor) and
        the mesh (by identity: its groups are in the graph). ``cfg`` is
        fixed per step and the state's model is checked against it, so it
        is no part of the key. Raises on a new shape past ``max_shapes``."""
        def sig(x):
            return None if x is None else (tuple(x.shape), x.dtype)

        key = (torch.device(device), self.mesh,
               *(sig(x) for x in (text, text_len, mel_gt, linear_gt, frame_len)))
        if key not in self.graphs and len(self.graphs) >= self.max_shapes:
            raise ValueError(f"a graphed step serves at most cfg.data.num_buckets = "
                             f"{self.max_shapes} batch shapes; this is another one: "
                             f"{key[2:]}")
        return key

    def __call__(self, state: TrainState, text, text_len, mel_gt, linear_gt, frame_len):
        dev = _check_state(state, self.cfg, self.mesh)
        batch = (text, text_len, mel_gt, linear_gt, frame_len)
        if dev.type != "cuda":
            return train_step(state, *batch, cfg=self.cfg, mesh=self.mesh)
        if self.mesh is not None and not self.mesh.capturable:
            raise ValueError("a mesh over gloo cannot be captured (its collectives go "
                             "through host copies): make_train_step(cfg, mesh) gives it "
                             "the eager train_step")
        if _state_tensors(state) != self._bound:
            self.graphs.clear()
        key = self.shape_key(dev, *batch)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)      # the batch's copies, made on the caller's stream
        with torch.cuda.stream(self._stream), profiling.clock("train_step", dev, STAGES):
            if key not in self.graphs:
                set_learning_rate(state.opt, self.cfg.train, state.step)
                with profiling.span("eager"):
                    metrics, alignments = _forward_backward_update(state, *batch, self.cfg,
                                                                   self.mesh)
                self.graphs[key] = None
            else:
                if self.graphs[key] is None:
                    with profiling.span("capture"):
                        self.graphs[key] = self._capture(state, batch)
                metrics, alignments = self._replay(state, self.graphs[key], batch)
        cur.wait_stream(self._stream)
        self._bound = _state_tensors(state)
        return state._replace(step=state.step + 1), metrics, alignments

    def _capture(self, state: TrainState, batch) -> CapturedStep:
        dev = next(state.model.parameters()).device
        inputs = [None if x is None else torch.empty_like(x, device=dev) for x in batch]
        _copy_into(inputs, batch)
        c = runtime.capture_graph(
            lambda: _forward_backward_update(state, *inputs, self.cfg, self.mesh),
            self._stream, state.generator)
        metrics, alignments = c.outputs
        return CapturedStep(c.graph, inputs, metrics, alignments,
                            [p.grad for p in state.model.parameters()], c.launches,
                            c.capture_s, c.instantiate_s, c.pool_bytes, c.marks)

    def _replay(self, state: TrainState, entry: CapturedStep, batch):
        with profiling.span("inputs"):
            _copy_into(entry.inputs, batch)
            set_learning_rate(state.opt, self.cfg.train, state.step)
        with profiling.span("replay"):
            profiling.mark(None)
            runtime.replay_graph(entry)
            profiling.mark(None)
        with profiling.span("outputs"):
            for p, g in zip(state.model.parameters(), entry.grads):
                p.grad = g
            return ({k: v.clone() for k, v in entry.metrics.items()},
                    entry.alignments.clone())


def _copy_into(static, batch) -> None:
    """``batch`` into a graph's static inputs (None, an absent ``frame_len``,
    is part of the shape key, so both sides agree on it)."""
    for dst, src in zip(static, batch):
        if dst is not None:
            dst.copy_(src, non_blocking=True)
