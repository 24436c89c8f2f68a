"""Port parity of the serving telemetry's exporters
(``repro_torch.serving.telemetry``) against the reference's
(``repro.serving.telemetry``): the Prometheus text of the same observations
equal line for line (few enough that the quantile sketch has not
compacted, where both are exact); a reduced f32 port engine's JSONL trace
replayed through both packages' ``replay_jsonl`` into the live timelines
(plain with a prefix-cache replay and a defrag, oversubscribed with a
forced preemption, speculative with replayed drafts); the engine's
Prometheus snapshot, as tests/test_telemetry.py asserts of the
reference; and
``RecompileTracker.unique`` / ``total``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import telemetry as JTM
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.serving import telemetry as TM
from repro_torch.serving.engine import (Engine, EngineConfig, OversubConfig,
                                        ReplayDrafter, SpecConfig)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

CFG = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
ENGINE_KW = dict(block_size=4, num_blocks=64, max_blocks_per_seq=8,
                 max_slots=4, prefill_chunk=8)
TIMELINE = ("ttft", "queue_wait", "e2e", "decode_tokens",
            "prefix_hit_tokens", "preempts", "draft_tokens",
            "accepted_tokens")


def _observe(mod, seed, n):
    """A registry of `mod` fed the same counters, gauges and histograms."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    reg.counter("reqs_total", "requests").inc(int(rng.integers(1, 9)))
    reg.counter("bytes_total").inc(float(rng.random()))
    reg.gauge("depth", "queue depth").set(int(rng.integers(0, 5)))
    reg.gauge("occupancy").add(float(rng.random()))
    reg.histogram("empty_seconds", "never observed")
    h = reg.histogram("lat_seconds", "latency", cap=n)
    g = reg.histogram("size_bytes", cap=n)
    for x in rng.lognormal(0.0, 1.5, size=n):
        h.observe(x)
    for x in rng.integers(0, 1000, size=n // 2 + 1):
        g.observe(int(x))
    return reg


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 64), (2, 1000)])
def test_prometheus_text_equals_reference(seed, n):
    """Equal line for line: counters, gauges and histograms exported as
    summaries (quantiles 0.5 / 0.9 / 0.99, `_sum`, `_count`; none for an
    empty one). cap = n: the buffer never reaches 2 * cap."""
    got = _observe(TM, seed, n).prometheus_text()
    want = _observe(JTM, seed, n).prometheus_text()
    assert got.splitlines() == want.splitlines()
    assert got.endswith("\n")
    assert '# TYPE lat_seconds summary' in got
    assert 'lat_seconds{quantile="0.99"}' in got
    assert 'empty_seconds{quantile' not in got


@pytest.fixture(scope="module")
def params():
    return T.init_params(CFG, seed=0, device="cpu")


def _requests(n=4, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, CFG.vocab_size, size=int(s)).astype(np.int32)
               for s in rng.integers(3, 20, size=n)]
    return prompts, [int(m) for m in rng.integers(2, 7, size=n)]


def _serve(params, kind):
    """A drained port engine and its request ids: "plain" (staggered
    arrivals, a defrag mid-flight, then the same prompts again from the
    prefix cache), "oversub" (one forced preemption) or "spec" (k = 4,
    drafts replayed from a plain engine's outputs, so verify steps accept
    runs of several tokens)."""
    kw = dict(ENGINE_KW)
    prompts, news = _requests(seed=3)
    drafter = None
    if kind == "oversub":
        kw.update(num_blocks=24, oversub=OversubConfig())
    if kind == "spec":
        plain, plain_rids = _serve(params, "oversub")
        truth = plain.drain()
        drafter = ReplayDrafter()
        kw.update(spec=SpecConfig(k=4, drafter=drafter))
    eng = Engine(CFG, params, EngineConfig(**kw), device="cpu")
    rids = []
    for i, (p, mn) in enumerate(zip(prompts, news)):
        rids.append(eng.add_request(p, mn))
        if drafter is not None:
            drafter.remember(rids[-1],
                             np.concatenate([p, truth[plain_rids[i]]]))
        eng.step()
    if kind == "plain":
        eng.defragment()
    if kind == "oversub":
        assert any(eng.preempt_request(r) for r in rids)
    eng.drain()
    if kind == "plain":
        rids += [eng.add_request(p, mn) for p, mn in zip(prompts, news)]
        eng.drain()
    return eng, rids


@pytest.mark.parametrize("kind", ["plain", "oversub", "spec"])
def test_jsonl_replays_equal_in_both_packages(params, kind, tmp_path):
    """Every event's data reaches ``json.dumps`` as plain numbers; the
    trace replays, through the port's and the reference's
    ``replay_jsonl``, into the live timelines."""
    eng, rids = _serve(params, kind)
    tel = eng.telemetry
    path = tmp_path / "trace.jsonl"
    n = tel.export_jsonl(path)
    assert n == len(tel.tracer.events) > 0
    names = {e.name for e in tel.tracer.events}
    want = {"plain": {"defrag", "prefix_hit"}, "oversub": {"preempt",
                                                             "resume"},
            "spec": {"verify"}}[kind]
    assert want <= names
    ours, theirs = TM.replay_jsonl(path), JTM.replay_jsonl(path)
    assert sorted(ours) == sorted(theirs) == sorted(rids)
    for rid in rids:
        live = tel.request_timeline(rid)
        for key in TIMELINE:
            assert ours[rid][key] == live[key], (rid, key)
            assert theirs[rid][key] == live[key], (rid, key)
    if kind == "plain":
        assert any(ours[r]["prefix_hit_tokens"] for r in rids)
    if kind == "spec":
        assert sum(ours[r]["accepted_tokens"] for r in rids) > 0


def test_engine_prometheus_snapshot_covers_pool_and_engine(params):
    prompts, news = _requests(n=3, seed=29)
    eng = Engine(CFG, params, EngineConfig(**ENGINE_KW), device="cpu")
    for p, mn in zip(prompts, news):
        eng.add_request(p, mn)
    eng.drain()
    text = eng.telemetry.prometheus_text()
    assert text == eng.telemetry.registry.prometheus_text()
    assert f"engine_tokens_emitted_total {sum(news)}" in text
    assert "# TYPE pool_evictions_total counter" in text
    assert "# TYPE engine_request_ttft_seconds summary" in text
    assert f"engine_request_ttft_seconds_count {len(prompts)}" in text


def test_recompile_tracker_unique_and_total(params):
    """Distinct argument signatures a function (`unique`) and over all
    (`total`); every call goes through. An engine's steps: one decode
    signature, `total` the sum of `variants`."""
    tracker = TM.RecompileTracker()
    calls = []
    fn = tracker.wrap("f", lambda *a: calls.append(a))
    fn(torch.zeros(2, 3), 1)
    fn(torch.ones(2, 3), 2)                         # same signature
    assert tracker.unique("f") == 1
    fn(torch.zeros(4, 3), 1)                        # new shape
    fn(torch.zeros(2, 3, dtype=torch.int32), 1)     # new dtype
    fn({"a": torch.zeros(2, 3)})                    # new structure
    assert tracker.unique("f") == 4
    assert tracker.unique("never") == 0
    g = tracker.wrap("g", lambda x: x)
    g(np.zeros(3))
    assert tracker.total == 5
    assert len(calls) == 5
    assert tracker._counter.value == tracker.total

    eng, _ = _serve(params, "plain")
    rec = eng.telemetry.recompiles
    assert rec.unique("decode") == 1
    assert rec.total == sum(rec.variants().values()) > 1
    assert (eng.telemetry.registry.get("engine_compiled_variants_total")
            .value == rec.total)
