"""The per-layer readers on captures made by hand, and on a traced tiny
run: each reads the run's raw record, leaves the traced steps out where
the profiler's cost would show, and finds nothing where there is nothing
to read."""
import json

import pytest

from bench import counts, harness, profiling
from bench.tests import tiny

MAN = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
MIX = json.loads((harness.BENCH / "configs" /
                  "mixtral-8x7b-16l.json").read_text())


def capture(steps, ops=None, spans=None, busy_s=0.0, window_s=0.0,
            **record):
    return profiling.Capture(
        window_s=window_s, busy_s=busy_s, ops=ops or {}, spans=spans or {},
        breakdown={}, record=dict(model=MIX["model"],
                                  engine=MIX["engine"], steps=steps,
                                  **record))


def step(traced, wall_s=0.1, prefill=(), decode=(), emitted=0,
         admitted=()):
    return {"traced": traced, "wall_s": wall_s, "host_s": wall_s / 2,
            "prefill": [list(p) for p in prefill], "decode": list(decode),
            "admitted": [list(a) for a in admitted], "emitted": emitted}


def test_idle_share_against_the_untraced_steps():
    # 10 traced steps of 0.2 s under the profiler, busy 0.08 s each; the
    # steps outside the trace take 0.1 s: idle 20%, not the traced
    # window's 60%
    cap = capture([step(True, 0.2)] * 10 + [step(False, 0.1)] * 90,
                  busy_s=0.8, window_s=2.0)
    got = harness.metric_reader("device_idle.serve")(cap)
    assert got == pytest.approx(20.0)


def test_serving_mfu_counts_the_untraced_steps_alone():
    m = MIX["model"]
    plain = step(False, 0.5, prefill=[(0, 4)], decode=[10], emitted=2)
    cap = capture([plain, step(True, 9.0, prefill=[(0, 512)])])
    want = counts.forward_flops(m, 5, counts.pairs(0, 4) + 10, 2)
    got = harness.metric_reader("mfu.serve")(cap)
    assert got == pytest.approx(want / 0.5 / counts.H100["bf16_flops"]
                                * 100)


def test_b1_roofline_by_hand():
    m, e = MIX["model"], MIX["engine"]
    ops = {"void paged_decode_tc<128, bf16, false>": [16, 0.001],
           "paged_decode_tc_merge": [16, 0.0005], "other": [3, 1.0]}
    cap = capture([step(True, decode=[100, 20]), step(False, decode=[50])],
                  ops=ops)
    nbytes = m["num_layers"] * counts.paged_decode_bytes(
        m, [100, 20], e["max_slots"], e["block_size"])
    got = harness.metric_reader("b1_roofline")(cap)
    assert got == pytest.approx(nbytes / counts.H100["hbm_bytes_per_s"]
                                / 0.0015 * 100)


def test_prefix_hit_share_and_engine_step():
    cap = capture([step(False, 0.2, admitted=[(1000, 640), (200, 0)]),
                   step(True, 0.6, admitted=[(800, 400)])])
    assert harness.metric_reader("prefix_hit_share")(cap) == \
        pytest.approx(1040 / 2000 * 100)
    assert harness.metric_reader("engine_step_ms")(cap) == \
        pytest.approx(100.0)


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_reader_finds_nothing_in_an_empty_capture(name):
    cap = capture([], untraced_s=0.0, mix={})
    assert harness.metric_reader(name)(cap) is None


def test_traced_tiny_serving_run_records_every_step():
    c = tiny.cell("mixtral-chat")
    drv = harness.driver(c["traffic"]["driver"])
    res = drv.run(c, seed=2**31 + 9, seconds=0, trace=True, device="cpu",
                  steps=30)
    rec = res["capture"].record
    assert sum(s["traced"] for s in rec["steps"]) == \
        c["traffic"]["trace_steps"]
    assert len(rec["steps"]) == 30 - 1 + c["traffic"]["trace_steps"]
    assert harness.metric_reader("prefix_hit_share")(res["capture"]) > 0
    assert res["correct"]
