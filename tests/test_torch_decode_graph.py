"""The engine's decode call captured as a CUDA graph and replayed
(``repro_torch.serving.engine.decode_graph``).

On the CPU the wrapper runs with a stand-in graph class that records the
calls made while it captures and replays them by recomputing into the
captured outputs: the static input buffers, outputs that no later replay
rewrites, an error where a pool leaf moved to new storage, the launch
counts (the warm-ups' and the capture's, none for a replay), the engine's
counters and pools, and an engine on the CPU, which never captures.

On the card (``-m cuda``; skipped without one) a graphed engine and an
eager one, whose graph is dropped, serve the same mixed run, bf16 and
int8 pools, full, ring and recurrent layers, token for token; the paged
kernels the eager engine's wrappers count are those its own device trace
and the graphed run's name (``kernels.trace_decode_launches``, whose
reading of kernel names a CPU test holds to each key); and the profiler sees the replayed kernels by
name under the ``engine/decode`` range. Run there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_graph.py``.
This file imports no JAX: the card's tests compare the port with itself.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.kernels.quantize import KVQuantConfig
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.engine import decode_graph as DG
from repro_torch.serving.telemetry import MetricsRegistry

pytestmark = pytest.mark.port

CFG_KW = dict(name="graph-t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=50, loss_chunk=16, attn_chunk=16, remat=False,
              dtype="float32")
ENGINE_KW = dict(block_size=4, num_blocks=64, max_blocks_per_seq=8,
                 max_slots=4, prefill_chunk=8)
STATS = ("decode_steps", "prefill_chunks", "emitted", "prefix_hit_tokens",
         "cow_copies")


class RecomputeGraph:
    """Stand-in for ``torch.cuda.CUDAGraph`` on the CPU. While it captures,
    the calls of `taped` functions are recorded with their arguments and
    outputs; a replay runs them again on the same (static) arguments and
    copies the results into the recorded outputs, as a replay rewrites a
    graph's output buffers. Unlike a capture on the card, the captured call
    runs once; like a replay there, a replay runs none of the kernel
    wrappers' Python, so it leaves the launch counts as they were."""
    capturing = None

    def __init__(self):
        self.tape = []

    def capture_begin(self):
        assert RecomputeGraph.capturing is None
        RecomputeGraph.capturing = self

    def capture_end(self):
        RecomputeGraph.capturing = None

    def replay(self):
        counts = dict(kernels.launch_counts)
        for fn, args, outs in self.tape:
            for dst, src in zip(outs, fn(*args)):
                dst.copy_(src)
        kernels.launch_counts.update(counts)


def taped(fn):
    def run(*args):
        out = fn(*args)
        if RecomputeGraph.capturing is not None:
            RecomputeGraph.capturing.tape.append((fn, args, out[:3]))
        return out
    return run


def toy_step(params, pool, tokens, tables, seq_lens, active):
    """A decode-shaped step: counts one kernel launch, writes each active
    slot's token into the pool in place (inactive ones into the last,
    scratch row), and returns (greedy, logits, seq_lens + active, pool)."""
    kernels.launch_counts["paged_attention"] += 1
    row = torch.where(active, seq_lens, pool["l0"]["k"].shape[0] - 1).long()
    pool["l0"]["k"][row] = tokens.float()
    logits = (params["w"] * (tokens + tables.sum(1))[:, None].float())
    return (torch.argmax(logits, dim=-1).to(torch.int32), logits,
            seq_lens + active.to(torch.int32), pool)


def toy_inputs(seed, slots=4, width=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 9, (slots,), generator=g, dtype=torch.int32),
            torch.randint(0, 9, (slots, width), generator=g,
                          dtype=torch.int32),
            torch.randint(0, 5, (slots,), generator=g, dtype=torch.int32),
            torch.rand(slots, generator=g) < 0.7)


@pytest.fixture
def toy():
    params = {"w": torch.linspace(-1.0, 1.0, 7)}
    pool = {"l0": {"k": torch.zeros(9)}}
    captures = MetricsRegistry().counter("captures")
    graph = DG.DecodeGraph(taped(toy_step), toy_inputs(0),
                           captures=captures, graph_cls=RecomputeGraph)
    graph.capture(params, pool)
    return graph, params, pool, captures


def test_capture_runs_inactive_and_replay_reads_the_static_buffers(toy):
    graph, params, pool, _ = toy
    # warm-ups and the capture saw every slot inactive: only the scratch
    # row was written
    assert not pool["l0"]["k"][:-1].any()
    inputs = toy_inputs(1)
    want_pool = {"l0": {"k": pool["l0"]["k"].clone()}}
    want = toy_step(params, want_pool, *inputs)
    got = graph(params, pool, *inputs)
    for static, x in zip(graph.static, inputs):
        torch.testing.assert_close(static, x, rtol=0, atol=0)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got[3] is pool
    torch.testing.assert_close(pool["l0"]["k"], want_pool["l0"]["k"],
                               rtol=0, atol=0)


def test_outputs_outlive_the_next_replay(toy):
    graph, params, pool, _ = toy
    first = graph(params, pool, *toy_inputs(1))
    kept = [t.clone() for t in first[:3]]
    second = graph(params, pool, *toy_inputs(2))
    for t, k in zip(first[:3], kept):
        torch.testing.assert_close(t, k, rtol=0, atol=0)
    for out in (first, second):
        for t, static in zip(out[:3], graph.outputs):
            assert t.data_ptr() != static.data_ptr()
    assert not torch.equal(first[1], second[1])


def test_new_pool_storage_raises_instead_of_replaying(toy):
    graph, params, pool, captures = toy
    for seed in (1, 2):
        graph(params, pool, *toy_inputs(seed))
    pool["l0"]["k"] = pool["l0"]["k"].clone()
    moved = pool["l0"]["k"].clone()
    static = [t.clone() for t in graph.static]
    with pytest.raises(RuntimeError, match="new storage"):
        graph(params, pool, *toy_inputs(3))
    # nothing of the call ran: no input copied in, no replay, no capture
    for t, s in zip(graph.static, static):
        torch.testing.assert_close(t, s, rtol=0, atol=0)
    torch.testing.assert_close(pool["l0"]["k"], moved, rtol=0, atol=0)
    assert captures.value == 1


def test_launch_counts_count_the_warm_ups_and_the_capture_not_replays():
    kernels.reset_launch_counts()
    captures = MetricsRegistry().counter("captures")
    params, pool = {"w": torch.ones(7)}, {"l0": {"k": torch.zeros(9)}}
    graph = DG.DecodeGraph(taped(toy_step), toy_inputs(0),
                           captures=captures, graph_cls=RecomputeGraph)
    graph.capture(params, pool)
    # the wrappers counted what they issued: the warm-ups and the capture
    assert kernels.launch_counts["paged_attention"] == DG.WARMUP_CALLS + 1
    for seed in range(3):
        graph(params, pool, *toy_inputs(seed))
    # a replay runs no wrapper
    assert kernels.launch_counts["paged_attention"] == DG.WARMUP_CALLS + 1
    assert captures.value == 1


# ------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(**CFG_KW)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 50, size=8).astype(np.int32)
    tails = [rng.integers(0, 50, size=n).astype(np.int32) for n in (3, 9, 5)]
    return [np.concatenate([shared, t]) for t in tails] + [shared]


def _serve(eng):
    """Staggered admissions, a fully cached prompt (copy on write), a
    defragment mid-run."""
    rids, news = [], (6, 4, 7, 5)
    for i, (p, n) in enumerate(zip(_prompts(), news)):
        rids.append(eng.add_request(p, n))
        eng.step()
        if i == 1:
            eng.defragment()
    got = eng.drain()
    return [got[r].tolist() for r in rids]


def _graphed(cfg, params):
    eng = Engine(cfg, params, EngineConfig(**ENGINE_KW), device="cpu")
    eng._decode_graph = DG.DecodeGraph(
        taped(eng._decode_fn),
        (eng.next_tok, eng.tables, eng.seq_lens, eng.active),
        captures=eng._m_decode_captures, graph_cls=RecomputeGraph)
    eng._decode_graph.capture(eng.params, eng.pool_state)
    return eng


def test_cpu_engine_decodes_eagerly_and_counts_it(model):
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(**ENGINE_KW), device="cpu")
    assert eng._decode_graph is None
    _serve(eng)
    s = eng.stats
    assert s["decode_steps"] > 0
    assert s["decode_graph_replays"] == s["decode_graph_captures"] == 0


def test_replayed_engine_serves_the_eager_tokens_and_counts(model):
    cfg, params = model
    eager = Engine(cfg, params, EngineConfig(**ENGINE_KW), device="cpu")
    graphed = _graphed(cfg, params)
    want, got = _serve(eager), _serve(graphed)
    assert got == want
    e, g = eager.stats, graphed.stats
    assert {k: g[k] for k in STATS} == {k: e[k] for k in STATS}
    assert e["cow_copies"] == 1
    assert g["decode_graph_replays"] == g["decode_steps"] > 0
    # the defragment moved blocks in place: the one capture served it all
    assert g["decode_graph_captures"] == 1
    assert e["decode_graph_replays"] == e["decode_graph_captures"] == 0


def test_capture_leaves_the_engine_pools_blocks_untouched(model):
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(**ENGINE_KW), device="cpu")
    before = {(name, key): a.clone()
              for name, layer in eng.pool_state.items()
              for key, a in layer.items()}
    eng._decode_graph = DG.DecodeGraph(
        taped(eng._decode_fn),
        (eng.next_tok, eng.tables, eng.seq_lens, eng.active),
        captures=eng._m_decode_captures, graph_cls=RecomputeGraph)
    eng._decode_graph.capture(eng.params, eng.pool_state)
    n = ENGINE_KW["num_blocks"]
    for (name, key), a in before.items():
        # a leaf is (layers, blocks, ...): blocks [0, num_blocks) as they
        # were; the warm-ups' and the capture's writes went to the scratch
        # block past them
        assert a.shape[1] == n + 1
        torch.testing.assert_close(eng.pool_state[name][key][:, :n],
                                   a[:, :n], rtol=0, atol=0)
    assert eng.stats["decode_graph_captures"] == 1


def test_engine_raises_where_a_pool_leaf_moved(model):
    cfg, params = model
    eng = _graphed(cfg, params)
    eng.add_request(_prompts()[0], 6)
    eng.step()
    eng.step()
    layer = eng.pool_state["l0"]
    layer["k"] = layer["k"].clone()
    replays = eng.stats["decode_graph_replays"]
    with pytest.raises(RuntimeError, match="new storage"):
        eng.step()
    assert eng.stats["decode_graph_replays"] == replays


# as the profiler names the kernels on the card: the kernels sit in an
# anonymous namespace
ANON = "void (anonymous namespace)::"


@pytest.mark.parametrize("name, key", [
    (ANON + "paged_decode_tc<128, __nv_bfloat16, false>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*, int)", "paged_attention"),
    (ANON + "paged_decode_tc<128, signed char, false>(__nv_bfloat16 const*, "
     "signed char const*)", "paged_attention_int8"),
    (ANON + "paged_decode_tc<256, __nv_bfloat16, true>(__nv_bfloat16 const*)",
     "paged_ring"),
    (ANON + "paged_decode_tc<128, signed char, true>(__nv_bfloat16 const*)",
     "paged_ring_int8"),
    (ANON + "paged_decode_split_kernel<float, 1>(float const*, float const*)",
     "paged_attention"),
    (ANON + "paged_decode_split_kernel<signed char, 4>(float const*)",
     "paged_attention_int8"),
    (ANON + "paged_multi_split_kernel<float, 1, true>(float const*)",
     "paged_ring"),
    ("void paged_multi_split_kernel<signed char, 2, true>(float const*)",
     "paged_ring_int8")])
def test_trace_names_count_under_their_launch_key(name, key):
    others = [ANON + "paged_decode_tc_merge(float const*, float const*)",
              ANON + "paged_decode_merge_kernel(float const*)",
              "void at::native::elementwise_kernel<128, 2>(int, float)",
              "Memcpy DtoD (Device -> Device)"]
    assert kernels.trace_decode_launches([name] * 3 + others) == {key: 3}
    assert key in kernels.launch_counts


# --------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the graph is captured on CUDA")
    return torch.device("cuda")


CARD_ENGINE = dict(block_size=4, num_blocks=96, max_blocks_per_seq=16,
                   max_slots=4, prefill_chunk=8)


def _card_model(arch, full=False):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    if full:
        cfg = dataclasses.replace(cfg, attention_type="full")
    return cfg, init_params(cfg, seed=0, device="cuda")


def _card_run(eng, vocab):
    """The mixed run on the card, under a device trace: staggered
    admissions and finishes, a fully cached prompt (copy on write where
    the config caches prefixes), one temperature request and a
    defragment. Returns the tokens, the launches the wrappers counted and
    the paged decode launches the trace names."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, size=8).astype(np.int32)
    tails = [rng.integers(0, vocab, size=n).astype(np.int32)
             for n in (5, 13, 2, 9)]
    prompts = [np.concatenate([shared, t]) for t in tails] + [shared]
    news = (9, 5, 12, 6, 7)
    kernels.reset_launch_counts()
    # kernels only, as chip_smoke.py's `_counted` traces a long run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rids = []
        for i, (p, n) in enumerate(zip(prompts, news)):
            kw = {}
            if i == 2:
                kw = dict(temperature=0.8,
                          generator=torch.Generator().manual_seed(5))
            rids.append(eng.add_request(p, n, **kw))
            eng.step()
            if i == 2:
                eng.defragment()
        got = eng.drain()
        torch.cuda.synchronize()
    traced = kernels.trace_decode_launches(
        e.name for e in prof.events() if str(e.device_type).endswith("CUDA"))
    counted = {k: n for k, n in kernels.launch_counts.items() if n}
    return [got[r].tolist() for r in rids], counted, traced


@pytest.mark.cuda
@pytest.mark.parametrize("arch, full, int8, kernel", [
    ("yi-9b", True, False, "paged_attention"),
    ("yi-9b", True, True, "paged_attention_int8"),
    ("mixtral-8x7b", False, False, "paged_ring"),
    ("rwkv6-7b", False, False, None)],
    ids=["full-bf16", "full-int8", "moe-ring-bf16", "recurrent-bf16"])
def test_graphed_engine_matches_the_eager_one_on_the_card(card, arch, full,
                                                          int8, kernel):
    """`kernel`: the paged kernel the decode launches (None: the
    recurrent layers launch none)."""
    cfg, params = _card_model(arch, full)
    ecfg = EngineConfig(**CARD_ENGINE,
                        kv_quant=KVQuantConfig() if int8 else None)
    graphed = Engine(cfg, params, ecfg, device="cuda")
    eager = Engine(cfg, params, ecfg, device="cuda")
    assert graphed._decode_graph is not None
    eager._decode_graph = None
    want, want_launches, eager_traced = _card_run(eager, cfg.vocab_size)
    got, got_counted, got_traced = _card_run(graphed, cfg.vocab_size)
    assert got == want
    # the eager engine's wrappers and its trace agree on every launch
    assert eager_traced == want_launches
    assert set(want_launches) <= {kernel}
    if kernel is not None:
        assert want_launches[kernel] > 0
    # the replays ran no wrapper; the trace names the same launches
    assert got_counted == {}
    assert got_traced == want_launches
    g, e = graphed.stats, eager.stats
    assert {k: g[k] for k in STATS} == {k: e[k] for k in STATS}
    if graphed.prefix_caching:
        assert g["cow_copies"] == 1
    assert g["decode_graph_replays"] == g["decode_steps"] > 0
    # the defragment moved blocks in place: construction's capture served
    # the whole run
    assert g["decode_graph_captures"] == 1
    assert e["decode_graph_replays"] == 0


@pytest.mark.cuda
def test_profiler_sees_the_replayed_kernels_under_the_decode_range(card):
    from torch.profiler import ProfilerActivity, profile
    cfg, params = _card_model("yi-9b", full=True)
    eng = Engine(cfg, params, EngineConfig(**CARD_ENGINE), device="cuda")
    for n in (6, 9, 4):
        eng.add_request(np.arange(n, dtype=np.int32) + 1, 12)
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    before = eng.stats
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    after = eng.stats
    steps = after["decode_steps"] - before["decode_steps"]
    replays = after["decode_graph_replays"] - before["decode_graph_replays"]
    assert steps == 3 and replays == 3
    events = prof.events()
    tc = [e for e in events if str(e.device_type).endswith("CUDA")
          and "paged_decode_tc" in e.name and "merge" not in e.name]
    assert len(tc) == steps * cfg.num_layers, sorted({e.name for e in tc})
    decode = [e for e in events if e.name == "engine/decode"
              and not str(e.device_type).endswith("CUDA")]
    assert len(decode) == steps
    b1_us = sum(e.time_range.elapsed_us() for e in tc)
    assert sum(e.device_time_total for e in decode) >= b1_us > 0
