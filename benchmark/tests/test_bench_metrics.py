"""Each per-layer reader on a synthetic event list whose answer is known."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.counts import flops
from benchmark.tests.test_bench_files import BENCH
from benchmark.trace import Event, Trace, breakdown, busy_seconds, union_seconds

M = harness.plain(harness.port_config(harness.load_cell("serve_fast.f32.b8", BENCH)))
MT = harness.plain(harness.port_config(harness.load_cell("train.bf16.b32", BENCH)))


def _serve_info(fused=False, flops_=1e12):
    return {"b": 8, "t_in": 64, "n_steps": 500, "t_gl": 1000, "gl_iters": 2, "fused": fused,
            "flops": flops_, "graph_nodes": {"preamble": 3, "chunk": 2, "postnet": 4},
            "model": M["model"], "audio": M["audio"], "wall_s": 0.08}


def _call(t0, fused=False):
    """One call from t0 (us): three graph launches (preamble, a chunk, the
    post-net) with their kernels, K4's six launches, a 2 ms copy back, and a
    1 ms idle gap under a host synchronise."""
    ev = [Event("bench.timed", "cpu", t0, t0 + 100_000)]
    at = t0
    for i, (name, n) in enumerate((("pre", 3), ("chunk", 2), ("post", 4))):
        corr = int(t0) + i
        ev.append(Event("cudaGraphLaunch", "runtime", at, at + 5, corr))
        for _ in range(n):
            ev.append(Event(f"k_{name}", "kernel", at + 10, at + 1_010, corr))
            at += 1_000
    for i in range(6):
        ev.append(Event("gl_wgmma" if i % 3 != 1 else "gl_ola_frame", "kernel", at + 10,
                        at + 10_010))
        at += 10_000
    if fused:
        ev.append(Event("decode_loop_kernel", "kernel", at + 10, at + 20_010))
        at += 20_000
    ev.append(Event("cudaStreamSynchronize", "runtime", at, at + 1_010))
    ev.append(Event("Memcpy DtoH (Device -> Pageable)", "memcpy", at + 1_010, at + 3_010))
    return ev


def _trace(n=2, fused=False):
    ev, spans = [], []
    for i in range(n):
        ev += _call(i * 1e6, fused)
        spans.append((i * 1e6, i * 1e6 + 100_000))
    return Trace(ev, spans, [_serve_info(fused) for _ in range(n)])


def test_union_and_busy():
    assert union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    tr = _trace(1)
    busy = (9 * 1_000 + 6 * 10_000 + 2_000) * 1e-6
    assert busy_seconds(tr) == pytest.approx(busy)


def test_mfu_synth_takes_the_untraced_wall_time():
    tr = _trace(2)
    assert harness.reader("mfu.synth").read(tr) == pytest.approx(
        100 * 2e12 / 0.16 / flops.H100_BF16_FLOPS)
    del tr.info[1]["wall_s"]                      # no untraced call of that shape
    assert harness.reader("mfu.synth").read(tr) is None


def test_gl_roofline():
    i = _serve_info()
    a = i["audio"]
    bound = flops.speed_of_light(2 * flops.gl_iteration_flops_exact(8, 1000, a["n_fft"], a["win_length"]),
                                 flops.gl_call_bytes(8, 1000, a["n_fft"], a["win_length"], True))
    assert harness.reader("gl_roofline_pct").read(_trace(1)) == pytest.approx(100 * bound / 0.06)


def test_gl_roofline_counts_a_dropped_launch_at_the_mean():
    tr = _trace(1)
    first_k4 = next(e for e in tr.events if e.name == "gl_wgmma")
    tr.events.remove(first_k4)
    full = harness.reader("gl_roofline_pct").read(_trace(1))
    assert harness.reader("gl_roofline_pct").read(tr) == pytest.approx(full)


def test_d2h_and_step_decode():
    tr = _trace(2)
    assert harness.reader("d2h_copy_ms_per_call").read(tr) == pytest.approx(2.0)
    assert harness.reader("step_decode_ms_per_call").read(tr) == pytest.approx(2.0)


def test_step_decode_leaves_out_a_partial_record():
    tr = _trace(1)
    tr.events.remove(next(e for e in tr.events if e.name == "k_chunk"))
    assert harness.reader("step_decode_ms_per_call").read(tr) is None


def test_decode_loop_roofline_reads_only_the_fused_path():
    assert harness.reader("decode_loop_roofline_pct").read(_trace(1)) is None
    m = M["model"]
    ops = 500 * flops.decode_step_flops(8, 64, n_mels=m["n_mels"], r=m["r"],
                                        prenet=tuple(m["prenet_dims"]))
    bound = flops.speed_of_light(ops, flops.decode_loop_bytes(m, 8, 64, 500, 2))
    assert harness.reader("decode_loop_roofline_pct").read(_trace(1, fused=True)) == \
        pytest.approx(100 * bound / 0.02)
    assert harness.reader("step_decode_ms_per_call").read(_trace(1, fused=True)) is None


def _train_trace():
    ev = [Event("bench.timed", "cpu", 0, 200_000)]
    for i in range(4):
        ev.append(Event("void energy_fwd<bf16>", "kernel", 10 * i, 10 * i + 2))
    for i in range(2):
        ev.append(Event("void energy_bwd<bf16>", "kernel", 100 + 10 * i, 100 + 10 * i + 7))
    ev.append(Event("gemm", "kernel", 1_000, 151_000))
    info = {"flops": 3.6e11, "energy_nodes": {"energy_fwd": 4, "energy_bwd": 2}, "b": 32, "t_in": 128, "t_out": 400,
            "model": MT["model"], "wall_s": 0.18}
    return Trace(ev, [(0, 200_000)], [info])


def test_train_readers():
    tr = _train_trace()
    assert harness.reader("mfu.train").read(tr) == pytest.approx(100 * 3.6e11 / 0.18 / 989e12)
    bound = (4 * flops.attn_energy_bytes(32, 128, 256, 2, False)
             + 2 * flops.attn_energy_bytes(32, 128, 256, 2, True)) / flops.H100_HBM_BYTES_PER_S
    assert harness.reader("attn_energy_roofline_pct").read(tr) == pytest.approx(
        100 * bound / 22e-6)
    tr.info[0]["energy_nodes"] = {"energy_fwd": 5, "energy_bwd": 2}   # a launch not recorded
    bound5 = bound + flops.attn_energy_bytes(32, 128, 256, 2, False) / flops.H100_HBM_BYTES_PER_S
    assert harness.reader("attn_energy_roofline_pct").read(tr) == pytest.approx(
        100 * bound5 / (22e-6 + 2e-6))


def test_readers_find_nothing_in_an_empty_trace():
    empty = Trace([], [], [])
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"]).read(empty) is None, m["name"]


def test_breakdown_names_ops_and_gaps():
    b = breakdown(_trace(1))
    assert b["device_ops"][0][0] == "gl_wgmma"
    gaps = dict(b["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1e-3, rel=0.05)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
