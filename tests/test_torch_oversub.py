"""Port parity for oversubscription (``EngineConfig.oversub``): the port's
``OversubConfig`` / ``SLOPolicy`` against the JAX ones under one fake
clock, the ``BlockPool.append`` / ``evict_seq`` life (the reference's
property episodes, ``check()`` after every operation), the scheduler's
priority queue, growth and preemption against the JAX ``Scheduler`` on the
same operations, and engine greedy tokens under forced and natural
preemption against the JAX ``Engine`` and against the port's own run
without preemption, on f32 full, sliding and reduced gemma3 configs, with
int8 pools and with speculation, and with priority preemption.

Everything compared is exact: policy decisions, block tables, tokens,
counters and telemetry orders (host code, and greedy argmax over f32
models whose parity the other port tests hold to 2e-5). The policy's step
EWMA and queue-head wait read the wall clock, so the engine pairs run with
both SLO targets out of reach (``SLO_OFF``): their scheduling then depends
on the pool alone and is the same in both packages; the SLO rules
themselves are compared under a fake clock."""
import dataclasses
import random

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import KVQuantConfig as JaxKVQuantConfig
from repro.serving.engine import OversubConfig as JaxOversubConfig
from repro.serving.engine import SLOPolicy as JaxSLOPolicy
from repro.serving.engine import SpecConfig as JaxSpecConfig
from repro.serving.engine.paged_cache import BlockPool as JaxBlockPool
from repro.serving.engine.scheduler import Request as JaxRequest
from repro.serving.engine.scheduler import Scheduler as JaxScheduler
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.serving.engine import (BlockPool, BlockPoolError, Engine,
                                        EngineConfig, KVQuantConfig,
                                        OversubConfig, SLOPolicy, SpecConfig,
                                        prefix_hashes)
from repro_torch.serving.engine.scheduler import (DECODING, Request,
                                                  Scheduler)
from repro_torch.serving.telemetry import derive_timeline, validate_order
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

KW = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
          num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=50, loss_chunk=16,
          attn_chunk=16, remat=False, dtype="float32")
STATS = ("decode_steps", "prefill_chunks", "emitted", "prefix_hit_tokens",
         "cow_copies", "preemptions", "resumes", "block_appends")
SLO_OFF = dict(ttft_slo_s=1e9, tpot_slo_s=1e9)


# ------------------------------------------------------------ SLO policy
def test_oversub_config_validation_matches_reference():
    for kw in ({"admit_watermark": 0.0}, {"admit_watermark": 1.5},
               {"step_ewma": 0.0}, {"step_ewma": 2.0}):
        with pytest.raises(ValueError):
            JaxOversubConfig(**kw)
        with pytest.raises(ValueError):
            OversubConfig(**kw)
    port = dataclasses.asdict(OversubConfig())
    ref = dataclasses.asdict(JaxOversubConfig())
    assert port == ref      # snapshot_resume included (recurrent slabs)


class _FakePool:
    def __init__(self, num_blocks, num_free):
        self.num_blocks, self.num_free = num_blocks, num_free


class _Req:
    def __init__(self, rid, priority, generated):
        self.rid, self.priority = rid, priority
        self.out_tokens = [0] * generated


@pytest.mark.parametrize("seed", range(6))
def test_slo_policy_decisions_match_reference(seed):
    """A seeded stream of step durations, admission probes, prefill gates
    and victim picks through both policies under one fake clock: every
    decision and the EWMA equal."""
    rng = random.Random(seed)
    kw = dict(admit_watermark=rng.choice([0.5, 0.8, 0.9, 1.0]),
              ttft_slo_s=rng.choice([0.1, 0.5]),
              tpot_slo_s=rng.choice([0.01, 0.05]),
              step_ewma=rng.choice([0.2, 0.5, 1.0]))
    now = [0.0]

    def clock():
        return now[0]
    pols = (JaxSLOPolicy(JaxOversubConfig(**kw), clock=clock),
            SLOPolicy(OversubConfig(**kw), clock=clock))
    for _ in range(60):
        now[0] += rng.uniform(0.0, 0.1)
        op = rng.random()
        if op < 0.3:
            dt = rng.uniform(0.0, 0.12)
            for p in pols:
                p.note_step(dt)
            assert pols[0].step_ewma_s == pols[1].step_ewma_s
        elif op < 0.55:
            pool = _FakePool(rng.randint(8, 64), 0)
            pool.num_free = rng.randint(0, pool.num_blocks)
            args = (pool, rng.randint(0, 10), rng.randint(0, 4),
                    rng.randint(0, 5))
            assert pols[0].may_admit(*args) == pols[1].may_admit(*args)
        elif op < 0.8:
            kwargs = dict(head_wait_s=rng.choice([None, rng.uniform(0, 1)]),
                          decoding=rng.randint(0, 4),
                          pool_util=rng.uniform(0, 1))
            assert (pols[0].allow_prefill(**kwargs)
                    == pols[1].allow_prefill(**kwargs))
        else:
            reqs = [_Req(i, rng.randint(0, 2), rng.randint(0, 9))
                    for i in range(rng.randint(0, 6))]
            mp = rng.choice([None, 0, 1])
            picks = [p.pick_victim(reqs, max_priority=mp) for p in pols]
            assert picks[0] is picks[1]
            assert ([r.rid for r in JaxSLOPolicy.victim_order(reqs)]
                    == [r.rid for r in SLOPolicy.victim_order(reqs)])
    assert pols[1].clock() == now[0]


@pytest.mark.parametrize("seed", range(3))
def test_workload_generators_match_reference(seed):
    from repro.serving import workloads as JW
    from repro_torch.serving import workloads as TW
    for a, b in zip(JW.open_loop_arrivals(40, seed=seed, overload=1.5),
                    TW.open_loop_arrivals(40, seed=seed, overload=1.5)):
        assert (a.step, a.max_new, a.priority) == (b.step, b.max_new,
                                                    b.priority)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    (jp, jn), (tp, tn) = (JW.spec_workload(6, seed=seed),
                          TW.spec_workload(6, seed=seed))
    assert jn == tn and all((x == y).all() for x, y in zip(jp, tp))
    with pytest.raises(ValueError):
        TW.open_loop_arrivals(4, overload=0.0)


# ------------------------------------------ pool append/evict property test
@pytest.mark.parametrize("seed", range(40))
def test_blockpool_append_evict_episode(seed):
    """The reference's seeded oversubscription pool episodes (optimistic
    admit, multi-block append, register-then-evict, cached-prefix revival)
    on the port's BlockPool: ``check()`` and shadow tables after every
    operation; a failed append changes nothing."""
    rng = random.Random(seed)
    bs = rng.choice([2, 4])
    num_blocks = rng.choice([8, 12, 16])
    pool = BlockPool(num_blocks, bs)
    owners, tokens = {}, {}
    base = [rng.randrange(5) for _ in range(3 * bs)]
    next_rid = 0
    for _ in range(rng.randint(40, 80)):
        op = rng.random()
        if op < 0.35:                             # optimistic admit
            keep = rng.randrange(0, 3 * bs + 1)
            toks = base[:keep] + [rng.randrange(5)
                                  for _ in range(rng.randint(1, bs))]
            hashes = prefix_hashes(np.asarray(toks, np.int32), bs)
            matched = pool.match_prefix(hashes)
            if matched and len(matched) * bs == len(toks):
                matched = matched[:-1]            # CoW rule: keep a tail
            need = pool.blocks_for(len(toks) + 1)
            if pool.admit_feasible(matched, need - len(matched)):
                rid, next_rid = next_rid, next_rid + 1
                if matched:
                    pool.share(rid, matched)
                owners[rid] = list(matched) + pool.alloc(rid,
                                                         need - len(matched))
                tokens[rid] = toks
                row = pool.table(rid)
                for i in range(len(matched), len(hashes)):
                    pool.register(rid, row[i], hashes[i])
        elif op < 0.65 and owners:                # decode growth: append
            rid = rng.choice(sorted(owners))
            n = rng.randint(1, 4)
            if pool.can_alloc(n):
                fresh = pool.append(rid, n)
                assert len(fresh) == n == len(set(fresh))
                assert not (set(fresh)
                            & {b for t in owners.values() for b in t})
                owners[rid].extend(fresh)
                tokens[rid] = tokens[rid] + [rng.randrange(5)
                                             for _ in range(n * bs)]
            else:
                before, free_before = list(pool.table(rid)), pool.num_free
                with pytest.raises(BlockPoolError):
                    pool.append(rid, n)
                assert pool.table(rid) == before
                assert pool.num_free == free_before
        elif op < 0.90 and owners:                # victim: register, evict
            rid = rng.choice(sorted(owners))
            hashes = prefix_hashes(np.asarray(tokens[rid], np.int32), bs)
            row = pool.table(rid)
            for i, h in zip(range(len(row)), hashes):
                pool.register(rid, row[i], h)
            pool.evict_seq(rid)
            del owners[rid], tokens[rid]
            with pytest.raises(BlockPoolError):
                pool.evict_seq(rid)
        else:
            with pytest.raises(BlockPoolError):
                pool.append("no-such-seq", 1)
        pool.check()
        for rid, expect in owners.items():
            assert pool.table(rid) == expect
        assert (pool.num_free
                == num_blocks - len({b for t in owners.values() for b in t}))
    for rid in sorted(owners):
        pool.evict_seq(rid)
    pool.drop_cache()
    pool.check()
    assert pool.num_free == num_blocks


# ------------------------------------------------------------- scheduler
@pytest.mark.parametrize("seed", range(8))
def test_scheduler_oversub_ops_match_reference(seed):
    """The same seeded stream of submits (two priority classes), admits,
    prefill registration, growth and preemption through the JAX Scheduler
    and the port's: queue order, admissions, block tables and the pools'
    free counts equal after every operation."""
    rng = random.Random(seed)
    bs, nb = 4, rng.choice([12, 16, 24])
    clock = [0.0]
    scheds = []
    for Pool, Sched, Pol, Cfg in (
            (JaxBlockPool, JaxScheduler, JaxSLOPolicy, JaxOversubConfig),
            (BlockPool, Scheduler, SLOPolicy, OversubConfig)):
        scheds.append(Sched(Pool(nb, bs), max_slots=3, max_blocks_per_seq=8,
                            prefill_chunk=8,
                            policy=Pol(Cfg(), clock=lambda: clock[0])))
    base = [rng.randrange(7) for _ in range(8)]
    reqs = ({}, {})
    for step in range(50):
        op = rng.random()
        if op < 0.3:
            rid = step
            prompt = np.asarray(base[:rng.randrange(0, 9)]
                                + [rng.randrange(7) for _ in range(
                                    rng.randint(1, 6))], np.int32)
            pr, mn = rng.randint(0, 1), rng.randint(2, 10)
            for s, R, box in zip(scheds, (JaxRequest, Request), reqs):
                box[rid] = R(rid=rid, prompt=prompt, max_new=mn, priority=pr)
                s.submit(box[rid])
        elif op < 0.55:
            got = [[r.rid for r in s.admit()] for s in scheds]
            assert got[0] == got[1]
            for s in scheds:
                for r in list(s.running.values()):
                    r.prefilled = r.prefill_len
                    s.register_prefilled(r)
                    r.state = DECODING
                    if not r.out_tokens:
                        r.out_tokens.append(1)
        elif op < 0.8:
            rids = sorted(scheds[0].running)
            if rids:
                rid = rng.choice(rids)
                extra = rng.randint(0, 2)
                needs = [s.growth_need(box[rid], extra)
                         for s, box in zip(scheds, reqs)]
                assert needs[0] == needs[1]
                if scheds[0].pool.can_alloc(needs[0]):
                    grown = [s.grow(box[rid], extra)
                             for s, box in zip(scheds, reqs)]
                    assert grown[0] == grown[1]
                    for box in reqs:
                        box[rid].out_tokens.append(2)
        else:
            rids = sorted(scheds[0].running)
            if rids:
                rid = rng.choice(rids)
                for s, box in zip(scheds, reqs):
                    s.preempt(box[rid])
        assert ([r.rid for r in scheds[0].waiting]
                == [r.rid for r in scheds[1].waiting])
        assert sorted(scheds[0].running) == sorted(scheds[1].running)
        assert scheds[0].can_admit_head() == scheds[1].can_admit_head()
        for rid in scheds[0].running:
            assert (scheds[0].pool.table(rid)
                    == scheds[1].pool.table(rid))
        assert scheds[0].pool.num_free == scheds[1].pool.num_free
        scheds[1].pool.check()


# ---------------------------------------------------------------- engines
def _configs(kind):
    if kind == "gemma3":
        return (dataclasses.replace(jax_reduced(jax_get_config("gemma3-12b")),
                                    dtype="float32"),
                dataclasses.replace(reduced(get_config("gemma3-12b")),
                                    dtype="float32"))
    kw = dict(KW, name=f"ov-{kind}")
    if kind == "sliding":
        kw.update(attention_type="sliding", window_size=4)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _model(kind):
    jcfg, cfg = _configs(kind)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


@pytest.fixture(scope="module", params=["full", "sliding", "gemma3"])
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def full_model():
    return _model("full")


def _engines(model, *, kv_quant=False, spec=None, oversub=True, **kw):
    """(JAX engine, port engine) on the same weights and config."""
    jcfg, cfg, jp, tp = model
    ek = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
              max_slots=4, prefill_chunk=8)
    ek.update(kw)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(
        **ek, kv_quant=JaxKVQuantConfig() if kv_quant else None,
        spec=JaxSpecConfig(k=spec) if spec else None,
        oversub=JaxOversubConfig(**SLO_OFF) if oversub else None))
    teng = Engine(cfg, tp, EngineConfig(
        **ek, kv_quant=KVQuantConfig() if kv_quant else None,
        spec=SpecConfig(k=spec) if spec else None,
        oversub=OversubConfig(**SLO_OFF) if oversub else None), device="cpu")
    return jeng, teng


def _prompts(n, seed, vocab=50, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(s)).astype(np.int32)
            for s in rng.integers(lo, hi, size=n)]


def _forced_soak(eng, prompts, max_new, depth=None):
    """Submit everything, then preempt request i once it has generated
    `depth(i)` tokens; drain. Returns tokens per request in order."""
    rids = [eng.add_request(p, max_new) for p in prompts]
    pending = list(rids) if depth else []
    steps = 0
    while eng.scheduler.has_work and steps < 300:
        eng.step()
        steps += 1
        for i, rid in enumerate(rids):
            req = eng.requests[rid]
            if (rid in pending and req.state == DECODING
                    and len(req.out_tokens) >= depth(i)):
                assert eng.preempt_request(rid)
                pending.remove(rid)
    assert not pending, "not every request reached its eviction point"
    got = eng.drain()
    return [got[r].tolist() for r in rids]


def _assert_engine_clean(jeng, teng):
    assert ({k: teng.stats[k] for k in STATS}
            == {k: jeng.stats[k] for k in STATS})
    assert teng.block_pool.num_free == teng.ecfg.num_blocks
    teng.block_pool.check()
    for rid in teng.telemetry.tracer.request_ids():
        evs = teng.telemetry.tracer.request_events(rid)
        validate_order(evs)
        assert derive_timeline(evs)["preempts"] == teng.requests[rid].preempts


@pytest.mark.parametrize("variant", ["plain", "int8", "spec4", "int8-spec4"])
def test_forced_preemption_soak_matches_reference(model, variant):
    """Every request is preempted once, at a different decode depth: tokens
    and counters equal the JAX engine's under the same preemptions, and the
    tokens equal the port's own run without preemption."""
    kv_quant = variant.startswith("int8")
    spec = 4 if variant.endswith("spec4") else None
    prompts = _prompts(4, seed=1, vocab=model[1].vocab_size)
    jeng, teng = _engines(model, kv_quant=kv_quant, spec=spec)
    want = _forced_soak(jeng, prompts, 10, depth=lambda i: i + 1)
    got = _forced_soak(teng, prompts, 10, depth=lambda i: i + 1)
    assert got == want
    assert teng.stats["preemptions"] >= len(prompts)
    assert teng.stats["resumes"] >= len(prompts)
    _assert_engine_clean(jeng, teng)
    _, calm = _engines(model, kv_quant=kv_quant, spec=spec)
    assert _forced_soak(calm, prompts, 10) == got
    assert calm.stats["preemptions"] == 0


def test_preempt_while_prefilling_and_conservative_mode(full_model):
    """Eviction mid-prefill (before any token) and a forced preemption
    without an OversubConfig (the conservative scheduler re-reserves the
    whole span on resume): tokens equal the JAX engine's and the first
    token is recorded once."""
    prompt = _prompts(1, seed=5, lo=10, hi=13)[0]
    outs = []
    for eng in _engines(full_model, prefill_chunk=4):
        rid = eng.add_request(prompt, 6)
        eng.step()                                 # one 4-token chunk in
        req = eng.requests[rid]
        assert req.state != DECODING and 0 < req.prefilled < req.prefill_len
        assert eng.preempt_request(rid)
        outs.append(eng.drain()[rid].tolist())
    assert outs[0] == outs[1]
    validate_order(eng.telemetry.tracer.request_events(rid))
    outs = []
    for eng in _engines(full_model, oversub=False):
        rid = eng.add_request(prompt, 8)
        while eng.requests[rid].state != DECODING:
            eng.step()
        eng.step()
        assert eng.preempt_request(rid)
        assert not eng.preempt_request(rid)        # already WAITING
        outs.append(eng.drain()[rid].tolist())
    assert outs[0] == outs[1]
    assert eng.stats["preemptions"] == eng.stats["resumes"] == 1


@pytest.mark.parametrize("variant", ["plain", "int8-spec4"])
def test_natural_pressure_matches_reference(full_model, variant):
    """A tiny pool under optimistic admission and two priority classes:
    preemption happens by itself (append failures and blocked class-0
    heads), with speculation growing the tables by its horizon; tokens,
    counters and telemetry equal the JAX engine's, and the tokens equal an
    unpressured run's."""
    kv_quant = variant.startswith("int8")
    spec = 4 if variant.endswith("spec4") else None
    prompts = _prompts(12, seed=3)
    outs = []
    engines = _engines(full_model, kv_quant=kv_quant, spec=spec,
                       num_blocks=20, max_slots=6, max_blocks_per_seq=8)
    for eng in engines:
        rids = [eng.add_request(p, 12, priority=i % 2)
                for i, p in enumerate(prompts)]
        got = eng.drain()
        outs.append([got[r].tolist() for r in rids])
    jeng, teng = engines
    assert outs[1] == outs[0]
    assert teng.stats["preemptions"] > 0 and teng.stats["block_appends"] > 0
    _assert_engine_clean(jeng, teng)
    _, calm = _engines(full_model, kv_quant=kv_quant, spec=spec,
                       oversub=False)
    rids = [calm.add_request(p, 12) for p in prompts]
    got = calm.drain()
    assert [got[r].tolist() for r in rids] == outs[1]


def test_priority_preemption_unblocks_head(model):
    """A blocked class-0 head evicts a running class-1 victim, which
    resumes; both finish with the JAX engine's tokens."""
    lo_p, hi_p = _prompts(2, seed=11, lo=8, hi=10,
                          vocab=model[1].vocab_size)
    outs = []
    # a sliding sequence holds at most its 2-block ring: 3 blocks bind
    nb = 3 if model[1].attention_type == "sliding" else 8
    engines = _engines(model, num_blocks=nb, max_slots=2,
                       max_blocks_per_seq=16)
    for eng in engines:
        lo = eng.add_request(lo_p, 16, priority=1)
        while eng.requests[lo].state != DECODING:
            eng.step()
        for _ in range(4):
            eng.step()
        hi = eng.add_request(hi_p, 16, priority=0)
        got = eng.drain()
        assert eng.requests[lo].preempts >= 1
        outs.append((got[lo].tolist(), got[hi].tolist()))
    assert outs[0] == outs[1]
    _assert_engine_clean(*engines)


def test_optimistic_admits_more_than_full_reservation(full_model):
    prompts = _prompts(4, seed=9, lo=4, hi=6)
    n_conc = {}
    for name, ov in (("opt", True), ("full", False)):
        _, eng = _engines(full_model, num_blocks=12, max_slots=4,
                          max_blocks_per_seq=8, oversub=ov)
        for p in prompts:
            eng.add_request(p, 20)
        eng.step()
        n_conc[name] = len(eng.scheduler.running)
        eng.drain()
    assert n_conc["full"] <= 2 < n_conc["opt"] == 4


def test_stats_and_timeline_after_a_forced_cycle(full_model):
    _, eng = _engines(full_model)
    rid = eng.add_request(_prompts(1, seed=15)[0], 8)
    while eng.requests[rid].state != DECODING:
        eng.step()
    eng.step()
    assert eng.preempt_request(rid)
    eng.drain()
    assert eng.stats["preemptions"] == eng.stats["resumes"] == 1
    tl = eng.telemetry.request_timeline(rid)
    assert tl["preempts"] == 1 == eng.requests[rid].preempts
    assert tl["preempted_s"] > 0.0 and tl["finish"] is not None
    reg = eng.telemetry.registry
    assert reg.get("engine_preemptions_total").value == 1
    assert reg.get("engine_prefill_deferrals_total").value >= 0
