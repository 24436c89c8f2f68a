"""The port's spans (``repro_torch.spans``) and the engine's host-time
counters (``Telemetry.span``, ``Engine.stats``): no range opens while no
profiler records; with telemetry on, each engine span counts its calls
and host seconds on untraced steps alone; under ``torch.profiler`` every
step's "engine/step" range holds its schedule, device call and emit
ranges; a profiler changes neither the served tokens nor a training
step's loss and params, bit for bit; and the MoE, remat and trainer
ranges appear where their names say."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import profile

from repro_torch import spans
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.serving import telemetry as TM
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.train import trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

CFG = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
ENGINE_KW = dict(block_size=4, num_blocks=64, max_blocks_per_seq=8,
                 max_slots=4, prefill_chunk=8, prefills_per_step=2)
PARTS = ("engine/schedule", "engine/prefill", "engine/decode",
         "engine/emit")
COUNTED = ("queue_wait_s", "admitted", "prefill_wait_s", "first_tokens")


@pytest.fixture(scope="module")
def params():
    return T.init_params(CFG, seed=0, device="cpu")


def _engine(params, n=5, seed=0, **kw):
    """An engine holding n requests of prompts 3-19 tokens long."""
    eng = Engine(CFG, params, EngineConfig(**ENGINE_KW, **kw), device="cpu")
    rng = np.random.default_rng(seed)
    for s in rng.integers(3, 20, size=n):
        eng.add_request(rng.integers(0, CFG.vocab_size, size=int(s)),
                        int(rng.integers(2, 7)))
    return eng


def _run(eng) -> int:
    steps = 0
    while eng.scheduler.has_work:
        eng.step()
        steps += 1
    return steps


def _spans_of(stats) -> dict:
    return {k: v for k, v in stats.items() if k.startswith("span_")}


def test_span_opens_no_range_without_a_profiler():
    assert TM.span is spans.span and TM._NULL_SPAN is spans._NULL_SPAN
    assert not spans.recording()
    assert spans.span("moe/apply") is spans._NULL_SPAN
    assert TM.Telemetry(enabled=False).span("engine/step") is TM._NULL_SPAN
    calls = []
    fn = spans.spanned("train/grads")(lambda x: calls.append(x) or x + 1)
    assert fn(1) == 2 and calls == [1]
    tel = TM.Telemetry()
    with tel.span("engine/step"):
        pass
    assert tel.span_totals()["engine/step"][0] == 1
    assert tel.span_totals()["engine/step"][1] >= 0
    assert "engine_span_engine_step_calls_total 1" in tel.prometheus_text()
    with profile() as prof:
        assert spans.recording()
        assert spans.span("moe/apply") is not spans._NULL_SPAN
        with spans.span("moe/apply"):
            fn(2)
        with tel.span("engine/step"):
            pass
    names = [e.name for e in prof.events()]
    assert "moe/apply" in names and "train/grads" in names
    assert "engine/step" in names
    assert tel.span_totals()["engine/step"][0] == 1


def test_step_span_calls_equal_the_steps_run(params):
    eng = _engine(params, n=16)
    before = eng.stats
    assert before["span_calls.engine/step"] == 0
    steps = _run(eng)
    after = eng.stats
    assert after["span_calls.engine/step"] == steps > 0
    assert after["span_calls.engine/decode"] == after["decode_steps"]
    assert after["span_calls.engine/prefill"] > 0
    assert after["span_calls.engine/schedule"] >= 2 * steps
    assert after["span_calls.engine/emit"] >= steps
    step_s = after["span_host_s.engine/step"]
    parts_s = sum(after[f"span_host_s.{p}"] for p in PARTS)
    assert 0.9 * step_s <= parts_s <= step_s
    assert after["admitted"] == after["first_tokens"] == 16
    assert after["queue_wait_s"] >= 0 and after["prefill_wait_s"] > 0


def test_profiled_steps_nest_their_parts_and_count_nothing(params):
    eng = _engine(params, n=6, seed=1)
    for _ in range(2):
        eng.step()
    before = eng.stats
    with profile() as prof:
        for _ in range(4):
            eng.step()
    after = eng.stats
    assert _spans_of(after) == _spans_of(before)
    assert {k: after[k] for k in COUNTED} == {k: before[k] for k in COUNTED}
    events = [e for e in prof.events() if e.name.startswith("engine/")]
    steps = [e for e in events if e.name == "engine/step"]
    assert len(steps) == 4

    def inside(e, outer):
        return (outer.time_range.start <= e.time_range.start
                and e.time_range.end <= outer.time_range.end)
    seen = set()
    for st in steps:
        held = {e.name for e in events if e is not st and inside(e, st)}
        assert {"engine/schedule", "engine/emit"} <= held, held
        assert held & {"engine/prefill", "engine/decode"}, held
        seen |= held
    assert set(PARTS) <= seen
    # after the profiler, the counters run again
    eng.step()
    assert eng.stats["span_calls.engine/step"] == \
        before["span_calls.engine/step"] + 1


def test_greedy_tokens_equal_with_a_profiler_on_and_off(params):
    plain = _engine(params, n=5, seed=2)
    want = plain.drain()
    traced = _engine(params, n=5, seed=2)
    with profile():
        got = traced.drain()
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    # the operator's histograms hold every request, traced or not; the
    # untraced sums of Engine.stats none of the traced run's
    for eng in (plain, traced):
        for h in (eng._h_queue_wait, eng._h_prefill_wait, eng._h_ttft,
                  eng._h_e2e):
            assert h.count == 5
    assert plain.stats["admitted"] == plain.stats["first_tokens"] == 5
    assert traced.stats["admitted"] == traced.stats["first_tokens"] == 0


def test_stats_snapshots_share_no_objects(params):
    eng = _engine(params, n=3, seed=3)
    eng.step()
    a = eng.stats
    b = eng.stats
    assert a is not b and a == b
    assert all(isinstance(v, (int, float)) for v in a.values())
    frozen = dict(a)
    eng.step()
    a["span_calls.engine/step"] = -1
    assert eng.stats["span_calls.engine/step"] == 2
    assert b == frozen


MOE_CFG = dataclasses.replace(
    reduced(get_config("mixtral-8x7b"), d_model=64, vocab=64),
    dtype="float32", remat=True, loss_chunk=8)


def _moe_batch():
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, 64, size=(2, 16)),
            "labels": rng.integers(0, 64, size=(2, 16))}


def test_moe_train_step_spans_and_bits():
    """A tiny MoE model with remat: one Adam step profiled and one not,
    from the same state and batch, give the same loss and params bit for
    bit; the profiled one shows every model and trainer range, and every
    checkpointed function, the loss's chunks too, is recomputed in
    "remat/recompute"."""
    cfg = MOE_CFG
    opt = make_optimizer("adam", lr=1e-3)
    batch = _moe_batch()
    step = trainer.make_train_step(cfg, opt)
    outs = []
    for traced in (False, True):
        state = trainer.init_state(cfg, opt, seed=3, device="cpu")
        if traced:
            with profile() as prof:
                state, m = step(state, batch)
        else:
            state, m = step(state, batch)
        outs.append((m["loss"], state["params"]))
    (l0, p0), (l1, p1) = outs
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(trainer.leaves_with_path(p0),
                                 trainer.leaves_with_path(p1)):
        assert torch.equal(a, b), path
    names = {e.name for e in prof.events()}
    want = {"train/grads", "train/optimizer", "moe/apply", "moe/experts",
            "moe/balance", "remat/forward", "remat/recompute"}
    assert want <= names, want - names
    # the recomputation's MoE layer runs inside "remat/recompute"
    host = [e for e in prof.events() if e.name == "moe/apply"]
    rec = [e for e in prof.events() if e.name == "remat/recompute"]
    assert any(r.time_range.start <= e.time_range.start
               and e.time_range.end <= r.time_range.end
               for e in host for r in rec)
    # each checkpoint's first pass runs in "remat/forward" and its
    # recomputation in "remat/recompute": the layers' and the loss's two
    # chunks alike
    first = [e for e in prof.events() if e.name == "remat/forward"]
    assert len(rec) == len(first) == cfg.num_layers + 2
    ce = [e.cpu_parent.name for e in prof.events()
          if e.name == "aten::logsumexp"
          and e.cpu_parent.name.startswith("remat/")]
    assert sorted(ce) == ["remat/forward"] * 2 + ["remat/recompute"] * 2


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_step_parts_read_the_program_ranges():
    """chip_smoke's split of a training step, read from the program's own
    ranges over a profiled tiny MoE step with remat (host self time on the
    CPU in place of device time): forward, backward, recomputation and
    optimizer each get time, the MoE layer's parts among them, and the
    checkpointed functions' first pass ("remat/forward") and
    recomputation ("remat/recompute") both read."""
    smoke = _chip_smoke()
    opt = make_optimizer("adam", lr=1e-3)
    step = trainer.make_train_step(MOE_CFG, opt)
    state = trainer.init_state(MOE_CFG, opt, seed=3, device="cpu")
    with profile() as prof:
        step(state, _moe_batch())
    parts, remat = smoke._step_parts(prof.events(),
                                     lambda e: e.self_cpu_time_total)
    assert set(parts) == set(smoke.STEP_PARTS)
    for name in ("MoE experts forward", "MoE routing+dispatch+combine "
                 "forward", "MoE experts recompute", "MoE experts backward",
                 "other forward", "other recompute", "other backward",
                 "optimizer"):
        assert parts[name] > 0, name
    assert remat["first pass"] > 0 and remat["recompute"] > 0
