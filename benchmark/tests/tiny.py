"""A run of a cell on the CPU at a small size: every layer's width cut,
the traffic shortened, the limits and everything else as committed."""

from __future__ import annotations

import contextlib
import io
import json

from benchmark import run as bench_run

SERVE = {
    "model": dict(embed_dim=32, prenet_dims=[32, 16], encoder_bank_k=3, encoder_bank_channels=8,
                  encoder_proj_dims=[16, 16], postnet_bank_k=3, postnet_bank_channels=8,
                  postnet_proj_dims=[16, 8], highway_layers=2, highway_dim=16, gru_dim=8,
                  attention_dim=16, attention_gru_dim=16, decoder_gru_dim=16, n_mels=8,
                  n_freq=65, max_decode_steps=12),
    "audio": dict(n_fft=128, win_length=100, hop_length=25, n_mels=8, griffin_lim_iters=4),
    "traffic": dict(batch=2, buckets=[[5, 8], [9, 12]],
                    sample={"first": 2, "random": 1, "below": 5}),
}
TRAIN = {**SERVE, "traffic": dict(batch=2, t_in=8, t_out=12, pool=3, summary_every=2)}


def overrides(workload: str) -> dict:
    return TRAIN if workload.startswith("train") else SERVE


def run(workload: str, seed: int = 2 ** 31 + 77, *, trace: int = 0, seconds: float = 0.5) -> dict:
    """-> the result line of one CPU run."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                             "--trace", str(trace)], device="cpu", overrides=overrides(workload))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
