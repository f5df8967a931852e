"""Training steps back to back through ``make_train_step(cfg)``.

Traffic parameters (``traffic/<name>.json``): ``preset``, ``batch``,
``t_in``, ``t_out`` (every row full), ``pool`` (batches made on the device
in set-up; step k takes batch k mod pool), ``checked_steps`` (the first
steps, run in set-up through the window's own call, that the reference
follows), ``summary_every`` (the loss is read back every so many steps,
and at the end) and ``trace_steps`` (steps profiled in a traced run).

Set-up builds one training step with its model and optimizer state, drives
it through the checked steps (the shape's eager first step, its capture,
a replay), keeps what the reference is compared on, and hands the same
object to the window. ``trace_steps`` steps at the window's start are
profiled in a traced run.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness, inputs
from benchmark.compare import norm_gaps
from benchmark.counts import flops
from benchmark.reference.masks import train_keep
from benchmark.reference.model import F32, Adam, Model, Precision, l1_loss
from benchmark.trace import SPAN, graph_nodes


class Run:
    def __init__(self, cell, seed: int, device, overrides=None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.t = cell.traffic
        self.cfg = harness.port_config(cell, overrides)
        self.plain = harness.plain(self.cfg)

    def dropout_seed(self) -> int:
        return (int(self.seed) + 2) % 2 ** 63

    # ------------------------------------------------------------ set-up
    def setup(self):
        from tacotron_tpu_torch import runtime
        from tacotron_tpu_torch.models.tacotron import Tacotron
        from tacotron_tpu_torch.train.schedule import make_optimizer
        from tacotron_tpu_torch.train.step import TrainState, make_train_step

        t, m = self.t, self.plain["model"]
        if self.device.type == "cuda":
            runtime.build()
        self.weights, self.stats = inputs.make_weights(m, self.seed, self.device)
        model = Tacotron(self.cfg.model, device=self.device)
        model.load_state_dict({**self.weights, **self.stats}, strict=True)
        model.train()
        gen = torch.Generator(device=self.device).manual_seed(self.dropout_seed())
        self.state = TrainState(model, make_optimizer(model.parameters(), self.cfg.train), 0, gen)
        self.step = make_train_step(self.cfg)
        self.pool = inputs.train_pool(self.seed, t["pool"], t["batch"], t["t_in"], t["t_out"],
                                      m["n_mels"], m["n_freq"], m["vocab_size"], self.device)
        params = dict(model.named_parameters())
        self.p0 = {k: v.detach().clone() for k, v in params.items()}
        self.losses, self.g1 = [], None
        b1 = self.cfg.train.adam_b1
        for k in range(t["checked_steps"]):
            self.state, metrics, _ = self.step(self.state, *self.pool[k % t["pool"]])
            self.losses.append(float(metrics["total_loss"]))
            if k == 0:
                opt = self.state.opt
                self.g1 = {n: float((opt.state[p]["exp_avg"] / (1 - b1)).norm())
                           for n, p in params.items()}
        self.delta = {k: float((v.detach() - self.p0[k]).norm()) for k, v in params.items()}
        self.steps_done = t["checked_steps"]
        graphs = [g for g in getattr(self.step, "graphs", {}).values() if g is not None]
        nodes = graph_nodes(graphs[0].graph) if graphs else {}
        self.energy_nodes = {part: sum(v for k, v in nodes.items() if part in k)
                             for part in ("energy_fwd", "energy_bwd")}

    # ------------------------------------------------------------ window
    def window(self, seconds: float, profile=None) -> dict:
        """Steps back to back until ``seconds`` have passed, the host at most
        two steps ahead of the device; ``profile``: a ``torch.profiler.profile``
        run over the window's first ``trace_steps`` steps, which are issued
        as the rest are and marked by one span that ends when the device
        has finished them. Each traced step's ``info`` gets ``wall_s``, the
        window's untraced steps' time a step: the profiler lengthens the
        steps it traces."""
        t, m = self.t, self.plain["model"]
        n_trace = t["trace_steps"] if profile is not None else 0
        frames = t["batch"] * t["t_out"]
        self.span_info = [{"flops": flops.train_step_flops(m, t["batch"], t["t_in"], t["t_out"]),
                           "energy_nodes": self.energy_nodes, "b": t["batch"], "t_in": t["t_in"],
                           "t_out": t["t_out"], "model": m} for _ in range(n_trace)]
        self._k, self._pending, self._losses = 0, [], []
        start = time.perf_counter()
        if n_trace:
            self._sync()
            profile.start()
            with torch.profiler.record_function(SPAN):
                for _ in range(n_trace):
                    self._one()
                self._sync()
            profile.stop()
        untraced = time.perf_counter()
        while True:
            self._one()
            if time.perf_counter() - start >= seconds:
                break
        self._losses.append(float(self._metrics["total_loss"]))    # waits for the last step
        end = time.perf_counter()
        elapsed = end - start
        k = self._k
        for info in self.span_info:
            info["wall_s"] = (end - untraced) / (k - n_trace)
        self.steps_done += k
        return {"attempted": k, "failed": sum(1 for x in self._losses if x != x),
                "window_s": elapsed, "train_frames_per_s": k * frames / elapsed}

    def _one(self):
        """One step of the window; every ``summary_every`` steps the loss is
        read back, as ``cli.train`` reads it."""
        t = self.t
        i = self.steps_done + self._k
        self.state, self._metrics, _ = self.step(self.state, *self.pool[i % t["pool"]])
        self._k += 1
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._pending.append(ev)
            if len(self._pending) > 2:
                self._pending.pop(0).synchronize()
        if (i + 1) % t["summary_every"] == 0:
            self._losses.append(float(self._metrics["total_loss"]))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        del self.state, self.step, self.pool
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def reference(self, precision: Precision = F32) -> tuple[list, dict, dict]:
        """The reference's checked steps from the same weights, batches and
        masks -> (losses, first clipped gradient's leaf norms, each leaf's
        change's norm)."""
        t, m, tr = self.t, self.plain["model"], self.plain["train"]
        w = {k: v.clone().requires_grad_(True) for k, v in self.weights.items()}
        stats = {k[:-len(".running_mean")]: (v, self.stats[k[:-len("mean")] + "var"])
                 for k, v in self.stats.items() if k.endswith(".running_mean")}
        model = Model(m, w, stats, train=True, precision=precision)
        opt = Adam(w, tr["learning_rate"], tr["adam_b1"], tr["adam_b2"], tr["adam_eps"],
                   tr["grad_clip_norm"])
        gen = torch.Generator(device=self.device).manual_seed(self.dropout_seed())
        pool = inputs.train_pool(self.seed, t["pool"], t["batch"], t["t_in"], t["t_out"],
                                 m["n_mels"], m["n_freq"], m["vocab_size"], self.device)
        losses, g1 = [], None
        for k in range(t["checked_steps"]):
            ids, tl, mel, lin, _ = pool[k % t["pool"]]
            enc_keep, dec_keep = train_keep(gen, t["batch"], t["t_in"], t["t_out"] // m["r"],
                                            m["prenet_dims"], m["prenet_dropout"], self.device)
            mel_p, lin_p, _ = model.teacher_forced(ids, tl, mel, enc_keep, dec_keep)
            total, _, _ = l1_loss(mel_p, lin_p, mel, lin)
            grads = dict(zip(w, torch.autograd.grad(total, list(w.values()))))
            clipped = opt.step(w, grads)
            losses.append(float(total.detach()))
            if k == 0:
                g1 = {n: float(g.norm()) for n, g in clipped.items()}
        delta = {k: float((v.detach() - self.weights[k]).norm()) for k, v in w.items()}
        return losses, g1, delta

    def gaps(self, losses, g1, delta, ref) -> dict:
        """The numbers compared (``compare.py``), and beside them the later
        steps' loss gaps, which are not compared: they carry the first
        updates' rounding forward and swing from seed to seed."""
        r_losses, r_g1, r_delta = ref
        norms = sorted(r_g1.values())
        median = norms[len(norms) // 2]
        moving = [k for k, v in r_g1.items() if v >= 1e-3 * median]
        steps = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
        return {"loss_gap": steps[0], "grad_gap": norm_gaps(g1, r_g1),
                "update_gap": norm_gaps(delta, r_delta, moving),
                **{f"loss_gap_step{k + 1}": v for k, v in enumerate(steps[1:], start=1)}}

    def check(self) -> list[dict]:
        self.ref = self.reference()
        return [self.gaps(self.losses, self.g1, self.delta, self.ref)]

    def control(self, model: str) -> list[dict]:
        """The reference in the lower precision put in the program's place."""
        low = self.reference(Precision(model))
        ref = self.ref if hasattr(self, "ref") else self.reference()
        return [self.gaps(*low, ref)]
