"""Port parity: ``repro_torch.serving.engine.Engine`` (CPU, plain versions)
against the JAX ``repro.serving.engine.Engine`` on the same converted
weights. Greedy tokens and the engine counters must be EQUAL; no block may
leak after drain. Also the port's copies of the BlockPool / Scheduler
invariant tests (host numpy code, no reference needed)."""
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.serving.engine import (BlockPool, BlockPoolError, Engine,
                                        EngineConfig, prefix_hashes)
from repro_torch.serving.engine.scheduler import (Request, Scheduler,
                                                  chunk_buckets_for,
                                                  segment_buckets_for)
from repro_torch.serving.telemetry import validate_order
from repro_torch.serving.workloads import (mixed_workload,
                                           shared_prefix_workload)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

CFG_KW = dict(name="eng-t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=50, loss_chunk=16, attn_chunk=16, remat=False,
              dtype="float32")
ENGINE_KW = dict(block_size=4, num_blocks=64, max_blocks_per_seq=8,
                 max_slots=4, prefill_chunk=8)
STATS = ("decode_steps", "prefill_chunks", "emitted", "prefix_hit_tokens",
         "cow_copies")
MIXED_LENS = (3, 7, 12, 5, 20, 9, 4, 15)
MIXED_NEWS = (4, 6, 3, 8, 5, 7, 2, 6)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JaxModelConfig(**CFG_KW), ModelConfig(**CFG_KW)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _engines(model, **kw):
    jcfg, cfg, jp, tp = model
    ek = {**ENGINE_KW, **kw}
    return (JaxEngine(jcfg, jp, JaxEngineConfig(**ek)),
            Engine(cfg, tp, EngineConfig(**ek), device="cpu"))


def _serve_both(model, prompts, news, *, stagger=True, stop_token=None,
                **kw):
    """Run the same request stream through both engines; returns the two
    engines and their outputs in submission order."""
    out = []
    engines = _engines(model, **kw)
    for eng in engines:
        rids = []
        for p, mn in zip(prompts, news):
            rids.append(eng.add_request(p, mn, stop_token=stop_token))
            if stagger:
                eng.step()
        got = eng.drain()
        out.append([got[r] for r in rids])
    return engines, out


def _assert_same(engines, outs):
    jeng, teng = engines
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    assert ({k: teng.stats[k] for k in STATS}
            == {k: jeng.stats[k] for k in STATS})
    assert teng.block_pool.num_free == teng.ecfg.num_blocks
    assert not teng.scheduler.running and not teng.scheduler.waiting
    teng.block_pool.check()
    for rid in teng.telemetry.tracer.request_ids():
        validate_order(teng.telemetry.tracer.request_events(rid))


def _mixed(seed=42, vocab=50):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in MIXED_LENS], list(MIXED_NEWS)


# ------------------------------------------------------- engine vs reference
@pytest.mark.parametrize("kw", [
    {},
    {"prefills_per_step": 3, "prefill_buckets": (4,)},
    {"prefix_caching": False, "max_slots": 2},
], ids=["default", "packed3", "nocache-2slots"])
def test_staggered_mixed_requests_match_reference(model, kw):
    prompts, news = _mixed()
    engines, outs = _serve_both(model, prompts, news, **kw)
    _assert_same(engines, outs)
    jeng, teng = engines
    assert teng.bucket_dispatches() == jeng.bucket_dispatches()


def test_prompt_longer_than_prefill_chunk(model):
    prompt = np.random.default_rng(3).integers(0, 50, size=21).astype(np.int32)
    engines, outs = _serve_both(model, [prompt], [5], prefill_chunk=4)
    _assert_same(engines, outs)
    assert engines[1].stats["prefill_chunks"] == 6          # ceil(21/4)


def test_shared_prefix_pair_copy_on_write(model):
    """The second request's prompt is fully cached (12 tokens = 3 blocks):
    the engine copies the last block and re-runs only the final token."""
    prompt = np.random.default_rng(1).integers(0, 50, size=12).astype(np.int32)
    engines, outs = _serve_both(model, [prompt, prompt], [6, 6], stagger=False,
                                max_slots=1)
    _assert_same(engines, outs)
    teng = engines[1]
    assert teng.stats["cow_copies"] == 1
    assert teng.stats["prefix_hit_tokens"] == 11
    np.testing.assert_array_equal(outs[1][0], outs[1][1])


def test_shared_prefix_workload_matches_reference(model):
    prompts, news, _ = shared_prefix_workload(n=6, seed=2, prefix_len=10,
                                              vocab=50)
    engines, outs = _serve_both(model, prompts, news, max_slots=3,
                                max_blocks_per_seq=12)
    _assert_same(engines, outs)
    assert engines[1].stats["prefix_hit_tokens"] > 0


def test_stop_token_matches_reference(model):
    prompts, news = _mixed(seed=5)
    ref = _serve_both(model, prompts, news)[1][1]
    stop = int(ref[3][2])                      # a token the stream emits
    engines, outs = _serve_both(model, prompts, news, stop_token=stop)
    _assert_same(engines, outs)
    assert any(len(o) < n for o, n in zip(outs[1], news))


def test_mixed_workload_matches_reference(model):
    prompts, news = mixed_workload(n=6, seed=0, vocab=50)
    news = [min(n, 12) for n in news]
    engines, outs = _serve_both(model, prompts, news, stagger=False,
                                max_blocks_per_seq=12)
    _assert_same(engines, outs)


def test_defragment_mid_flight_matches_reference(model):
    rng = np.random.default_rng(3)
    pre = rng.integers(0, 50, size=8).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, 50, size=k)
                               .astype(np.int32)]) for k in (2, 4, 6)]
    outs = []
    for eng in _engines(model, num_blocks=32, max_slots=3):
        r0 = eng.add_request(prompts[0], 10)
        eng.step()
        rids = [r0] + [eng.add_request(p, 10) for p in prompts[1:]]
        eng.step()
        src = eng.defragment()
        assert sorted(src.tolist()) == list(range(32))
        got = eng.drain()
        outs.append([got[r] for r in rids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


def test_defrag_device_gather_matches_host_permutation(model):
    _, teng = _engines(model, num_blocks=32, max_slots=3)
    rng = np.random.default_rng(0)
    for n in (9, 5, 14):
        teng.add_request(rng.integers(0, 50, size=n).astype(np.int32), 6)
    teng.step()
    teng.step()
    before = {k: v.clone() for k, v in teng.pool_state["l0"].items()}
    src = teng.defragment()
    for k, v in teng.pool_state["l0"].items():
        assert torch.equal(v[:, :32], before[k][:, torch.from_numpy(
            src.astype(np.int64))])
    teng.drain()
    assert teng.block_pool.num_free == 32


def test_host_side_validation(model):
    _, teng = _engines(model)
    with pytest.raises(ValueError, match="infeasible"):
        teng.add_request(np.zeros(30, np.int32), 10)        # > 8 blocks of 4
    with pytest.raises(ValueError):
        teng.add_request(np.zeros(0, np.int32), 4)
    # temperature requests are accepted, each with its own seeded generator
    rid = teng.add_request(np.zeros(3, np.int32), 4, temperature=0.7)
    assert isinstance(teng.requests[rid].generator, torch.Generator)


def test_decode_step_records_lazy_refs_without_host_sync(model):
    """Greedy requests store (step vector, index) refs; the per-slot
    vectors are replaced out of place, so a recorded vector never changes."""
    _, teng = _engines(model)
    rid = teng.add_request(np.arange(5, dtype=np.int32), 4)
    teng.step()                                 # prefill -> first token
    teng.step()                                 # one decode step
    refs = teng.requests[rid].out_tokens
    assert all(isinstance(t, tuple) for t in refs)
    snap = [(v.clone(), i) for v, i in refs]
    teng.drain()
    for (v, i), (s, _) in zip(refs, snap):
        assert torch.equal(v, s)
    assert teng.stats["emitted"] == 4


def test_engine_rejects_params_on_another_device(model):
    _, cfg, _, tp = model
    with pytest.raises(ValueError, match="params live on"):
        Engine(cfg, tp, EngineConfig(**ENGINE_KW), device="meta")


# ------------------------------------------------ BlockPool (host, port copy)
class TestBlockPool:
    def test_alloc_free_roundtrip(self):
        p = BlockPool(8, 4)
        got = p.alloc("a", 3)
        assert len(got) == len(set(got)) == 3 and p.num_free == 5
        p.alloc("b", 5)
        assert p.num_free == 0 and p.utilization == 1.0
        assert not p.can_alloc(1)
        p.free_seq("a")
        p.free_seq("b")
        assert p.num_free == 8

    def test_double_free_and_over_alloc_raise(self):
        p = BlockPool(4, 4)
        p.alloc("a", 2)
        p.free_seq("a")
        with pytest.raises(BlockPoolError):
            p.free_seq("a")
        with pytest.raises(BlockPoolError):
            p.alloc("b", 5)

    def test_blocks_for(self):
        p = BlockPool(8, 4)
        assert [p.blocks_for(n) for n in (1, 4, 5, 8, 9)] == [1, 1, 2, 2, 3]

    def test_defragment_compacts_and_preserves_ownership(self):
        p = BlockPool(10, 4)
        p.alloc("a", 3)
        p.alloc("b", 3)
        p.free_seq("a")
        before = p.table("b")
        src = p.defragment()
        after = p.table("b")
        assert after == [0, 1, 2]
        assert [int(src[i]) for i in after] == before
        p.alloc("c", 7)
        assert p.num_free == 0

    def test_prefix_hashes_chain_full_blocks(self):
        t = np.arange(10, dtype=np.int32)
        h = prefix_hashes(t, 4)
        assert len(h) == 2
        assert prefix_hashes(t[:8], 4) == h
        assert prefix_hashes(np.r_[t[:4], t[5:9]], 4)[1] != h[1]

    def test_lru_and_plain_reuse_order(self):
        p = BlockPool(4, 2)
        a = p.alloc("a", 2)
        p.register("a", a[0], b"k0")
        p.free_seq("a")
        assert p.num_cached_free == 1
        fresh = p.alloc("b", 3)                   # plain blocks first
        assert a[0] not in fresh
        p.alloc("c", 1)                           # now evicts the cached one
        assert p.match_prefix([b"k0"]) == [] and p.num_cached_free == 0
        p.check()


def _consistent_remap(pre, pool, src):
    """Every owner's table after defrag is its old table mapped through the
    inverse permutation."""
    inv = np.empty_like(src)
    inv[src] = np.arange(len(src))
    out = {}
    for rid, tbl in pre.items():
        assert pool.table(rid) == [int(inv[b]) for b in tbl]
        out[rid] = pool.table(rid)
    return out


@pytest.mark.parametrize("seed", range(40))
def test_blockpool_random_episode(seed):
    """Seeded episode: interleaved share+alloc, release, register, defrag,
    drop_cache and error probes, with the full invariant check plus shadow
    tables after every step."""
    rng = random.Random(seed)
    bs = rng.choice([2, 4, 8])
    num_blocks = rng.choice([12, 16, 32])
    pool = BlockPool(num_blocks, bs)
    owners = {}
    base = [rng.randrange(6) for _ in range(4 * bs)]
    next_rid = 0
    for _ in range(rng.randint(40, 90)):
        op = rng.random()
        if op < 0.45:
            keep = rng.randrange(0, 4 * bs + 1)
            tail = [rng.randrange(6) for _ in range(rng.randint(1, 2 * bs))]
            prompt = np.asarray(base[:keep] + tail, np.int32)
            hashes = prefix_hashes(prompt, bs)
            matched = pool.match_prefix(hashes)
            if matched and len(matched) * bs == len(prompt):
                matched = matched[:-1]
            need = pool.blocks_for(len(prompt) + rng.randint(1, bs))
            if pool.admit_feasible(matched, need - len(matched)):
                rid = next_rid
                next_rid += 1
                if matched:
                    pool.share(rid, matched)
                owners[rid] = list(matched) + pool.alloc(rid, need - len(matched))
                row = pool.table(rid)
                for i in range(len(matched), rng.randint(len(matched),
                                                         len(hashes))):
                    pool.register(rid, row[i], hashes[i])
        elif op < 0.70 and owners:
            rid = rng.choice(sorted(owners))
            pool.free_seq(rid)
            del owners[rid]
            with pytest.raises(BlockPoolError):
                pool.free_seq(rid)
        elif op < 0.80:
            pre = {r: list(t) for r, t in owners.items()}
            src = pool.defragment()
            assert sorted(src.tolist()) == list(range(num_blocks))
            owners = _consistent_remap(pre, pool, src)
        elif op < 0.88:
            pool.drop_cache()
            assert pool.num_cached_free == 0
        else:
            with pytest.raises(BlockPoolError):
                pool.alloc("probe", pool.num_free + 1)
            with pytest.raises(BlockPoolError):
                pool.table("no-such-seq")
        pool.check()
        for rid, expect in owners.items():
            assert pool.table(rid) == expect
        assert (pool.num_free
                == num_blocks - len({b for t in owners.values() for b in t}))
    for rid in sorted(owners):
        pool.free_seq(rid)
    pool.drop_cache()
    pool.check()
    assert pool.num_free == num_blocks


# ------------------------------------------------ Scheduler (host, port copy)
def test_bucket_normalisation():
    assert chunk_buckets_for(32, (8, 16, 8)) == (8, 16, 32)
    assert chunk_buckets_for(32) == (32,)
    with pytest.raises(ValueError):
        chunk_buckets_for(32, (64,))
    assert segment_buckets_for(5) == (1, 2, 4, 5)
    assert segment_buckets_for(4, packed=False) == (1,)


def test_scheduler_admission_reserves_whole_span_and_packs_prefill():
    pool = BlockPool(10, 4)
    sched = Scheduler(pool, max_slots=3, max_blocks_per_seq=6,
                      prefill_chunk=8, prefills_per_step=2)
    for rid, (n, new) in enumerate([(10, 6), (5, 3), (9, 8)]):
        sched.submit(Request(rid=rid, prompt=np.arange(n, dtype=np.int32),
                             max_new=new))
    admitted = sched.admit()
    # 4 + 2 blocks fit; the third request (5 blocks) waits in order
    assert [r.rid for r in admitted] == [0, 1]
    assert pool.num_free == 4 and len(sched.waiting) == 1
    (batch,) = sched.next_prefills()
    assert [(r.rid, s, v) for r, s, v in batch.segments] == [(0, 0, 8),
                                                            (1, 0, 5)]
    assert (batch.chunk_len, batch.num_segments) == (8, 2)
    with pytest.raises(ValueError):
        sched.submit(Request(rid=9, prompt=np.arange(30, dtype=np.int32),
                             max_new=1))
    for r in admitted:
        sched.finish(r)
    assert pool.num_free == 10 and sched.occupancy() == 0.0
