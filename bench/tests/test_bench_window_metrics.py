"""The readers of the engine's window counters (``bench/window.py``:
``schedule_ms``, ``emit_ms``, ``decode_issue_ms``, ``prefill_issue_ms``,
``queue_wait_ms``, ``prefill_wait_ms``) on hand-made ``Engine.stats``
snapshots, by hand count; on snapshots of a program that lacks the keys;
and on a traced tiny chat run, where the spans' host time covers the
step that the serving loop times from outside."""
import json

import pytest

from bench import harness, profiling, window
from bench.tests import tiny

SIX = ("schedule_ms", "emit_ms", "decode_issue_ms", "prefill_issue_ms",
       "queue_wait_ms", "prefill_wait_ms")
START = {"decode_steps": 10, "span_calls.engine/step": 100,
         "span_host_s.engine/step": 8.0,
         "span_calls.engine/schedule": 300,
         "span_host_s.engine/schedule": 0.5,
         "span_calls.engine/emit": 200, "span_host_s.engine/emit": 0.25,
         "span_calls.engine/decode": 95, "span_host_s.engine/decode": 2.0,
         "span_calls.engine/prefill": 60, "span_host_s.engine/prefill": 4.0,
         "queue_wait_s": 1.0, "admitted": 20,
         "prefill_wait_s": 3.0, "first_tokens": 18}


def capture(start, end):
    stats = None if start is None else {"window_start": start,
                                        "window_end": end}
    return profiling.Capture(window_s=0.0, busy_s=0.0, ops={}, spans={},
                             breakdown={}, record={"steps": [],
                                                   "stats": stats})


def test_six_readers_by_hand():
    end = dict(START)
    # 40 untraced steps: 120 schedule spans of 1.2 s in all, 80 emit spans
    # of 0.4 s, 38 decode calls of 2.28 s, 20 prefill calls of 3.0 s;
    # 10 requests admitted after 1.5 s of waits in all, 12 first tokens
    # 9.6 s after their admissions in all
    end.update({"span_calls.engine/step": 140,
                "span_calls.engine/schedule": 420,
                "span_host_s.engine/schedule": 1.7,
                "span_calls.engine/emit": 280,
                "span_host_s.engine/emit": 0.65,
                "span_calls.engine/decode": 133,
                "span_host_s.engine/decode": 4.28,
                "span_calls.engine/prefill": 80,
                "span_host_s.engine/prefill": 7.0,
                "queue_wait_s": 2.5, "admitted": 30,
                "prefill_wait_s": 12.6, "first_tokens": 30})
    cap = capture(START, end)
    got = {n: harness.metric_reader(n)(cap) for n in SIX}
    assert got == pytest.approx({"schedule_ms": 30.0, "emit_ms": 10.0,
                                 "decode_issue_ms": 60.0,
                                 "prefill_issue_ms": 150.0,
                                 "queue_wait_ms": 150.0,
                                 "prefill_wait_ms": 800.0})


@pytest.mark.parametrize("name", SIX)
def test_readers_find_nothing_without_the_engines_counters(name):
    read = harness.metric_reader(name)
    # a program whose Engine.stats lacks the keys, as before the spans
    old = {"decode_steps": 3, "emitted": 9}
    assert read(capture(old, dict(old, decode_steps=5))) is None
    # no snapshot at all, and a window in which nothing was counted
    assert read(capture(None, None)) is None
    assert read(capture(START, dict(START))) is None


def test_traced_tiny_chat_run_reads_the_six():
    c = tiny.cell("mixtral-chat")
    drv = harness.driver(c["traffic"]["driver"])
    res = drv.run(c, seed=2**31 + 21, seconds=0, trace=True, device="cpu",
                  steps=30)
    cap = res["capture"]
    got = {n: harness.metric_reader(n)(cap) for n in SIX}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["decode_issue_ms"] > 0 and got["prefill_issue_ms"] > 0
    step_ms = harness.metric_reader("engine_step_ms")(cap)
    assert got["schedule_ms"] + got["emit_ms"] <= step_ms
    # the engine counts its untraced steps alone, and times each from
    # inside the call that the serving loop times from outside
    untraced = [s for s in cap.record["steps"] if not s["traced"]]
    stats = cap.record["stats"]
    calls = (stats["window_end"]["span_calls.engine/step"]
             - stats["window_start"]["span_calls.engine/step"])
    assert calls == len(untraced)
    inside = window.per_ms(cap, "span_host_s.engine/step",
                           "span_calls.engine/step")
    assert 0.95 * step_ms <= inside <= step_ms
    json.dumps(stats)
    assert res["correct"]
