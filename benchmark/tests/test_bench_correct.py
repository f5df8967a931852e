"""The comparison that decides ``correct``, run whole on the CPU at a small
size: the program against the reference comes out correct; the control
(the reference in the precision below the configuration's, in the
program's place) and each fault a cell can have come out not correct."""

from __future__ import annotations

import functools

import pytest
import torch

from benchmark import harness
from benchmark.compare import judge, worst
from benchmark.tests import tiny
from benchmark.tests.test_bench_files import BENCH

CELLS = [w["name"] for w in BENCH["workloads"]]
SERVE = [c for c in CELLS if not c.startswith("train")]
TRAIN = [c for c in CELLS if c.startswith("train")]


# The numbers computed in f32 on both sides: at a small size they agree to
# rounding as at the full one. Where the program computes in bf16 (the
# Griffin-Lim kernel everywhere, the model in some cells) its gaps at a
# small size are no guide to the full size's, which set the limits; there a
# run is held to its form.
EXACT = {"serve_fast.f32.b8": ["mel_gap", "linear_gap", "align_gap", "end_frames_wrong"]}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_program_run(cell, trace):
    out = tiny.run(cell, trace=trace)
    for name in EXACT.get(cell, []):
        check = out["checks"][name]
        assert check["value"] <= check["limit"], (name, check)
    assert all(v["value"] == v["value"] for v in out["checks"].values())
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(harness.load_cell(cell, BENCH).checks["limits"])
    want = {m["name"] for m in harness.load_cell(cell, BENCH).end_to_end}
    if not trace:
        assert set(out["metrics"]) == want


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = harness.load_cell(cell, BENCH)
    c.traffic.update(tiny.overrides(cell)["traffic"])
    run = harness.driver(c).Run(c, 2 ** 31 + 9, "cpu", tiny.overrides(cell))
    run.setup()
    run.window(0.2)
    run.release()
    run.check()
    ok, rows = judge(worst(run.control(**c.checks["control"])), c.checks["limits"])
    assert not ok, rows


# --------------------------------------------------------------- faults
def _state_unchanged_serve(monkeypatch):
    from tacotron_tpu_torch.infer import early_exit
    from tacotron_tpu_torch.ops import decode_loop
    orig_while, orig_packed = early_exit.while_decoder_step, decode_loop.packed_decoder_step

    def frozen(make):
        def wrapped(*a, **k):
            state, step = make(*a, **k)

            def stuck(s):
                _, frames, alpha = step(s)
                return s, frames, alpha
            return state, stuck
        return wrapped

    monkeypatch.setattr(early_exit, "while_decoder_step", frozen(orig_while))
    monkeypatch.setattr(decode_loop, "packed_decoder_step", frozen(orig_packed))


def _half_batch_serve(monkeypatch):
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    orig = Synthesizer.__call__

    def half(self, texts, *a, **k):
        h = len(texts) // 2
        return orig(self, list(texts[:h]) * 2, *a, **k)

    monkeypatch.setattr(Synthesizer, "__call__", half)


def _linear_altered(monkeypatch):
    from tacotron_tpu_torch.models.postnet import PostNet
    orig = PostNet.forward

    def altered(self, mel, lengths=None):
        out = orig(self, mel, lengths)
        return out + torch.zeros_like(out).index_fill_(1, torch.tensor([0]), 1e-2)

    monkeypatch.setattr(PostNet, "forward", altered)


def _wav_lost(monkeypatch):
    from tacotron_tpu_torch.infer.synthesize import Synthesizer
    orig = Synthesizer.__call__

    def lost(self, *a, **k):
        out = orig(self, *a, **k)
        out["wavs"][0] = float("nan")
        return out

    monkeypatch.setattr(Synthesizer, "__call__", lost)


def _gl_short(monkeypatch):
    from tacotron_tpu_torch.infer import synthesize
    orig = synthesize.gl_spectrum              # the name ``Synthesizer._gl`` calls
    monkeypatch.setattr(synthesize, "gl_spectrum", lambda mag, cfg, n_iter=None: orig(mag, cfg, 1))


def _wav_altered(monkeypatch):
    from tacotron_tpu_torch.infer import synthesize
    orig = synthesize.spectrum_to_wav

    def altered(re, im, cfg, length=None):
        wav = orig(re, im, cfg, length)
        return wav + 0.05 * wav.abs().amax(-1, keepdim=True) * torch.sin(
            torch.arange(wav.shape[-1], dtype=wav.dtype, device=wav.device))

    monkeypatch.setattr(synthesize, "spectrum_to_wav", altered)


SERVE_FAULTS = {"state_unchanged": _state_unchanged_serve, "half_batch": _half_batch_serve,
                "linear_altered": _linear_altered, "wav_lost": _wav_lost,
                "griffin_lim_stops_early": _gl_short, "wav_altered": _wav_altered}


@functools.lru_cache(maxsize=None)
def _sound_checks(cell: str) -> dict:
    return tiny.run(cell)["checks"]


def _tripped_by_fault(cell: str, checks: dict) -> list[str]:
    """The numbers over their limits that the fault put there: within its
    limit in the sound run at this size, or moved tenfold from it (a
    number in bf16 on the program's side can sit over its full-size limit
    at a small size)."""
    sound = _sound_checks(cell)
    return [n for n, c in checks.items()
            if not c["value"] <= c["limit"]
            and (sound[n]["value"] <= sound[n]["limit"] or not c["value"] <= 10 * sound[n]["value"])]


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serve_fault_is_not_correct(cell, fault, monkeypatch):
    _sound_checks(cell)                        # before the fault
    SERVE_FAULTS[fault](monkeypatch)
    out = tiny.run(cell)
    assert not out["correct"] and _tripped_by_fault(cell, out["checks"]), out["checks"]


def _state_unchanged_train(monkeypatch):
    from tacotron_tpu_torch.train import step
    orig = step.clip_and_step

    def no_update(opt, cfg, norm=None):
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad.zero_()
        return orig(opt, cfg, norm)

    monkeypatch.setattr(step, "clip_and_step", no_update)


def _half_batch_train(monkeypatch):
    from tacotron_tpu_torch.train import step
    orig = step.tacotron_loss

    def half(mel_pred, linear_pred, mel_gt, linear_gt, *a, **k):
        h = mel_pred.shape[0] // 2
        return orig(mel_pred[:h], linear_pred[:h], mel_gt[:h], linear_gt[:h], *a, **k)

    monkeypatch.setattr(step, "tacotron_loss", half)


def _loss_altered(monkeypatch):
    from tacotron_tpu_torch.train import step
    orig = step.tacotron_loss

    def altered(*a, **k):
        total, metrics = orig(*a, **k)
        return total, {**metrics, "total_loss": metrics["total_loss"] * 1.01}

    monkeypatch.setattr(step, "tacotron_loss", altered)


def _grad_altered(monkeypatch):
    from tacotron_tpu_torch.train import step
    orig = step.clip_and_step

    def scaled(opt, cfg, norm=None):
        p = opt.param_groups[0]["params"][-1]
        p.grad.mul_(1.5)
        return orig(opt, cfg, norm)

    monkeypatch.setattr(step, "clip_and_step", scaled)


TRAIN_FAULTS = {"state_unchanged": _state_unchanged_train, "half_batch": _half_batch_train,
                "loss_altered": _loss_altered, "gradient_altered": _grad_altered}


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(cell, fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    out = tiny.run(cell)
    assert not out["correct"], out["checks"]
