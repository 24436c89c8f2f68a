"""``decode_graph_share``: the window's replayed decode calls over its
decode steps, from ``Engine.stats``; by hand count, on the counters of a
program that keeps no graph counter (nothing to read), and on a tiny CPU
chat run, where the engine decodes op by op."""
import pytest

from bench import harness
from bench.tests import tiny
from bench.tests.test_bench_window_metrics import capture

read = harness.metric_reader("decode_graph_share")


def test_share_by_hand():
    start = {"decode_steps": 10, "decode_graph_replays": 9}
    end = {"decode_steps": 410, "decode_graph_replays": 389}
    assert read(capture(start, end)) == pytest.approx(95.0)


def test_nothing_to_read_without_the_counter_or_a_decode():
    old = {"decode_steps": 3, "emitted": 9}
    assert read(capture(old, dict(old, decode_steps=5))) is None
    assert read(capture(None, None)) is None
    idle = {"decode_steps": 4, "decode_graph_replays": 4}
    assert read(capture(idle, dict(idle))) is None


def test_tiny_cpu_chat_run_replays_nothing():
    c = tiny.cell("mixtral-chat")
    drv = harness.driver(c["traffic"]["driver"])
    res = drv.run(c, seed=2**31 + 5, seconds=0, trace=True, device="cpu",
                  steps=12)
    assert read(res["capture"]) == 0.0
    assert res["correct"]
