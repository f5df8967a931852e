"""Closed-loop serving of Tacotron 2: ``serve_closed``'s client, window,
sample and checks, with the configuration's ``tacotron2`` section applied
to the port's ``Config`` and the reference ``reference/tacotron2.py`` on the
other side.

Traffic parameters: those of ``serve_closed`` and ``gate_bias``, the stop
gate's bias in the drawn weights. Random weights would open the gate at
random in the first steps; a bias far below the logit threshold keeps it
shut, so each row decodes to ``max_decode_steps``, as random Tacotron 1
weights never go silent in ``serve_fast``.

The weights have the initial form of a fresh model (normal kernels scaled
by 1 / sqrt(fan-in), zero biases but the gate's, unit batch-norm scales,
zero running means and unit running variances), drawn on the device by one
``torch.Generator`` in one call and cut into leaves.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark import inputs
from benchmark.counts import tacotron2 as t2_counts
from benchmark.drivers import serve_closed
from benchmark.reference import tacotron2 as ref_t2
from benchmark.reference.model import Precision


def make_weights(m: dict, t2: dict, seed: int, device, gate_bias: float) -> tuple[dict, dict]:
    """-> (parameters {name: f32 tensor}, batch-norm statistics {name:
    tensor}) of a fresh Tacotron 2, the kernels drawn in one call."""
    spec = ref_t2.param_spec(m, t2)
    drawn = [k for k, s in spec.items() if len(s) > 1]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(spec[k]) for k in drawn), generator=gen, device=device)
    w, off = {}, 0
    for k in drawn:
        s = spec[k]
        n = math.prod(s)
        fan_in = s[0] if k.endswith((".v", "embedding")) else math.prod(s[1:])
        w[k] = (flat[off:off + n] / math.sqrt(fan_in)).reshape(s)
        off += n
    for k, s in spec.items():
        if k not in w:
            bn_scale = k.rsplit(".", 2)[-2].startswith("bn") and k.endswith(".weight")
            w[k] = torch.full(s, 1.0 if bn_scale else 0.0, device=device)
    w["decoder.gate.bias"].fill_(gate_bias)
    stats = {}
    for name in ref_t2.batch_norm_names(m, t2):
        c = spec[f"{name}.weight"][0]
        stats[f"{name}.running_mean"] = torch.zeros(c, device=device)
        stats[f"{name}.running_var"] = torch.ones(c, device=device)
    return w, stats


class Run(serve_closed.Run):
    def __init__(self, cell, seed: int, device, overrides=None):
        from tacotron_tpu_torch.config import Tacotron2Config
        super().__init__(cell, seed, device, overrides)
        t2 = Tacotron2Config(**cell.config["tacotron2"])
        self.cfg = self.cfg.replace(tacotron2=t2)
        self.t2 = dataclasses.asdict(t2)

    def build(self):
        from tacotron_tpu_torch import runtime
        from tacotron_tpu_torch.data.vocab import Vocab
        from tacotron_tpu_torch.infer.synthesize import Synthesizer

        if self.device.type == "cuda":
            runtime.build()
        self.weights, self.stats = make_weights(self.plain["model"], self.t2, self.seed,
                                                self.device, self.t["gate_bias"])
        vocab = Vocab.build([inputs.charset()])
        self.synth = Synthesizer(self.cfg, {k: v.clone() for k, v in self.weights.items()},
                                 {k: v.clone() for k, v in self.stats.items()}, vocab,
                                 fused=self.t["fused"], device=self.device)

    def _info(self, texts, out) -> dict:
        info = super()._info(texts, out)
        m, a = self.plain["model"], self.plain["audio"]
        info["n_steps"] = int(out["end_frames"].max()) // m["r"]
        info["flops"] = t2_counts.call_flops(m, self.t2, a, self.b, info["t_in"],
                                             info["n_steps"], info["t_gl"], info["gl_iters"])
        info["tacotron2"] = self.t2
        return info

    def _reference(self, texts, s, model="f32", gl=None, decode=None) -> dict:
        ids, lengths = inputs.encode(texts)
        ids = torch.from_numpy(ids).to(self.device)
        lengths = torch.from_numpy(lengths).to(self.device)
        m, a = self.plain["model"], self.plain["audio"]
        with torch.no_grad():
            return ref_t2.synthesize(
                self.plain, self.t2, self.weights, self.stats, ids, lengths, s,
                n_steps=m["max_decode_steps"], gl_iters=a["griffin_lim_iters"] if gl else 0,
                precision=Precision(model), gl_precision=Precision(gl or "f32"))
