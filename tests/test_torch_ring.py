"""Port parity for ring (sliding-window) KV: ``ring_pages`` and
``RingKVProvider``, the ring-mode paged write, ring decode attention,
``attention_prefill_ring`` (including a chunk that laps the ring), the
model steps of reduced gemma3 (1 local + 1 global layer), and the port's
``Engine`` serving reduced gemma3 and a dense sliding config against the
JAX ``Engine`` on the same converted weights.

Inputs come from numpy seeds; everything runs in float32 on the CPU, where
the kernel wrappers take their plain versions. Tolerances: attention
outputs 2e-5 (the reference's kernel-vs-oracle tolerance; float32 sums in
another order), logits 1e-4 (through two layers), pools 1e-5 on blocks
[:N] (the port's pools carry one extra scratch block at index N), greedy
tokens and engine counters exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.kernels.paged_attention import paged_attention as jax_kernel
from repro.kernels.paged_attention import paged_attention_ref as jax_ref
from repro.kernels.paged_attention.ref import (
    ring_key_positions as jax_ring_key_positions)
from repro.models import attention as JA
from repro.models import state_providers as JSP
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro_torch import kernels
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.paged_attention.ref import ring_key_positions
from repro_torch.models import attention as TA
from repro_torch.models import state_providers as SP
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.telemetry import validate_order
from torch_threads import jitted, one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

RING = ("window", "ring_pages")      # the ring verbs' static keywords

STATS = ("decode_steps", "prefill_chunks", "emitted", "prefix_hit_tokens",
         "cow_copies")
SLIDING_KW = dict(name="ring-t", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=50, loss_chunk=16, attn_chunk=16, remat=False,
                  dtype="float32", attention_type="sliding", window_size=8)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _gemma_cfgs():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("gemma3-12b")),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config("gemma3-12b")),
                              dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _model(jcfg, cfg, seed=0):
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module")
def gemma():
    jcfg, cfg = _gemma_cfgs()
    return (jcfg, cfg) + _model(jcfg, cfg)


@pytest.fixture(scope="module")
def sliding():
    jcfg, cfg = JaxModelConfig(**SLIDING_KW), ModelConfig(**SLIDING_KW)
    return (jcfg, cfg) + _model(jcfg, cfg)


def _layer(tree, sb=0):
    return {k: _layer(v, sb) if isinstance(v, dict) else v[sb]
            for k, v in tree.items()}


# ------------------------------------------------------ providers (host)
def test_ring_pages_and_blocks_needed_match_reference():
    for window in (4, 8, 10, 32, 1024):
        for bs in (4, 16):
            for draft in (0, 1, 3, 7):
                assert (SP.ring_pages(window, bs, draft)
                        == JSP.ring_pages(window, bs, draft))
    assert SP.ring_pages(8, 4) == 3 and SP.ring_pages(8, 4, draft=3) == 4
    assert SP.ring_pages(1024, 16) == 65 and SP.ring_pages(1024, 16, 3) == 66
    jcfg, cfg = JaxModelConfig(**SLIDING_KW), ModelConfig(**SLIDING_KW)
    for draft in (0, 3):
        (tp,) = SP.providers_for(cfg, num_blocks=32, block_size=4,
                                 draft=draft)
        (jp,) = JSP.providers_for(jcfg, num_blocks=32, block_size=4,
                                  max_slots=4, draft=draft)
        assert tp.kind == jp.kind == "ring" and not tp.supports_prefix_caching
        assert tp.ring_pages == jp.ring_pages
        for n in (1, 4, 5, 11, 12, 13, 40, 1000):
            assert tp.blocks_needed(n) == jp.blocks_needed(n)
            assert tp.write_cursor(n) == jp.write_cursor(n)
            assert tp.state_bytes_per_slot(n) == jp.state_bytes_per_slot(n)
        assert tp.max_tokens() is None


def test_gemma3_providers_and_state_layout(gemma):
    _, cfg, _, _ = gemma
    provs = SP.providers_for(cfg, num_blocks=16, block_size=4)
    assert [p.kind for p in provs] == ["ring", "full"]
    assert SP.seq_blocks_needed(provs, 100) == 25       # the full layer rules
    pool = TT.init_paged_state(cfg, 16, 4, device="cpu")
    assert sorted(pool) == ["l0", "l1"]
    assert tuple(pool["l0"]["k"].shape) == (1, 17, 4, 2, 64)


def test_gemma3_full_size_geometry():
    cfg = get_config("gemma3-12b")
    assert SP.state_kinds(cfg) == ["ring"] * 5 + ["full"]
    assert SP.superblock_layout(cfg) == (8, 6)
    assert abs(cfg.param_count() / 1e9 - 11.765) < 1e-3
    specs = TT.param_specs(cfg)
    assert sorted(specs["blocks"]) == [f"l{i}" for i in range(6)]
    assert "lm_head" not in specs                     # tied embedding


# ------------------------------------------------------------ attention verbs
def _pool(seed, N, bs, hkv, hd):
    """JAX pool (N, ...) and the port's copy with a random scratch block."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N, bs, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((N, bs, hkv, hd)).astype(np.float32)
    scratch = rng.standard_normal((1, bs, hkv, hd)).astype(np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": _t(np.concatenate([k, scratch])),
             "v": _t(np.concatenate([v, -scratch]))})


def _close(jkv, tkv, N, atol=1e-5):
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name][:N].numpy(),
                                   np.asarray(jkv[name]), atol=atol, rtol=0)


def test_paged_write_ring_mode():
    N, bs, R = 12, 4, 3
    jkv, tkv = _pool(0, N, bs, 2, 8)
    rng = np.random.default_rng(1)
    tables = rng.permutation(N)[:8].reshape(2, 4).astype(np.int32)
    for positions in ([0, 5], [11, 12], [13, 47]):      # before/at/past wrap
        positions = np.asarray(positions, np.int32)
        kn = rng.standard_normal((2, 2, 8)).astype(np.float32)
        vn = rng.standard_normal((2, 2, 8)).astype(np.float32)
        active = np.asarray([True, positions[0] != 11])
        jkv = jitted(JA.paged_write, (), ("ring_pages",))(
            jkv, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tables),
            jnp.asarray(positions), jnp.asarray(active), ring_pages=R)
        TA.paged_write(tkv, _t(kn), _t(vn), _t(tables), _t(positions),
                       _t(active), ring_pages=R)
        _close(jkv, tkv, N, atol=0)


def test_ring_key_positions_match_reference():
    pos = np.asarray([0, 3, 11, 12, 13, 47, 100], np.int32)
    for R, bs in ((3, 4), (4, 4), (65, 16)):
        np.testing.assert_array_equal(
            ring_key_positions(_t(pos), R, bs).numpy(),
            np.asarray(jax_ring_key_positions(jnp.asarray(pos), R, bs)))


@pytest.mark.parametrize("H,Hkv,hd", [(4, 2, 32), (8, 1, 16), (4, 4, 64)])
def test_ring_decode_matches_reference(H, Hkv, hd):
    """The plain ring decode against the JAX oracle and the JAX Pallas
    kernel (interpret mode) at positions before, at and far past the first
    wrap, with an inactive slot."""
    window, bs = 10, 4
    R = JSP.ring_pages(window, bs)
    pos = np.asarray([0, 9, R * bs - 1, R * bs, 5 * R * bs + 3, 0], np.int32)
    lens = np.where(np.arange(6) == 5, 0, pos + 1).astype(np.int32)
    B, P, N = 6, R + 2, 6 * (R + 2) + 3
    rng = np.random.default_rng(H * 100 + hd)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((N, bs, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, hd)).astype(np.float32)
    tables = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    args = (q, kp, vp, tables, lens)
    kw = dict(window=window, positions=pos, ring_pages=R)
    kernels.reset_launch_counts()
    out = paged_attention(*[_t(a) for a in args], window=window,
                          positions=_t(pos), ring_pages=R)
    assert sum(kernels.launch_counts.values()) == 0
    assert torch.equal(out, paged_attention_ref(
        *[_t(a) for a in args], window=window, positions=_t(pos),
        ring_pages=R))
    assert bool((out[5] == 0).all())
    jargs = [jnp.asarray(a) for a in args]
    jkw = {**kw, "positions": jnp.asarray(pos)}
    for ref in (jax_ref(*jargs, **jkw), jax_kernel(*jargs, **jkw)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=0)


def test_ring_mode_needs_all_three_arguments():
    q = torch.zeros((1, 2, 8))
    pool = torch.zeros((4, 4, 2, 8))
    tables, lens = torch.zeros((1, 3), dtype=torch.int32), torch.ones(
        (1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="ring mode"):
        paged_attention(q, pool, pool, tables, lens, window=4)


def test_attention_decode_paged_ring(sliding):
    jcfg, cfg, jp, tp = sliding
    N, bs, R = 20, 4, JSP.ring_pages(8, 4)
    jkv, tkv = _pool(3, N, bs, 2, 16)
    rng = np.random.default_rng(4)
    B = 4
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    tables = rng.permutation(N)[:B * 5].reshape(B, 5).astype(np.int32)
    positions = np.asarray([2, 12, 30, 0], np.int32)
    attn_lens = np.asarray([3, 13, 31, 0], np.int32)      # slot 3 inactive
    jout, jkv = jitted(JA.attention_decode_paged, (6,), RING)(
        _layer(jp["blocks"]["l0"])["attn"], jnp.asarray(x), jkv,
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(attn_lens),
        jcfg, window=8, ring_pages=R)
    tout, _ = TA.attention_decode_paged(
        _layer(tp["blocks"]["l0"])["attn"], _t(x), tkv, _t(tables),
        _t(positions), _t(attn_lens), cfg, window=8, ring_pages=R)
    np.testing.assert_allclose(tout[:3].numpy(), np.asarray(jout)[:3],
                               atol=2e-5, rtol=0)
    _close(jkv, tkv, N)


@pytest.mark.parametrize("C,starts,valids", [
    (8, (0, 5, 0), (8, 6, 0)),          # first chunk, mid chunk, padding
    (16, (0, 20, 3), (16, 16, 11)),     # 16 > R*bs = 12: chunks lap the ring
    (4, (11, 12, 33), (1, 4, 3)),       # around the first wrap
], ids=["plain", "lapping", "wrap"])
def test_attention_prefill_ring(sliding, C, starts, valids):
    """Gather-before-scatter: each chunk's early queries still see the
    pre-chunk ring the chunk overwrites, and only each slot's newest lap is
    written."""
    jcfg, cfg, jp, tp = sliding
    N, bs, R = 24, 4, JSP.ring_pages(8, 4)
    jkv, tkv = _pool(5 + C, N, bs, 2, 16)
    rng = np.random.default_rng(C)
    G = 3
    x = rng.standard_normal((G, C, 64)).astype(np.float32)
    rows = rng.permutation(N)[:G * 6].reshape(G, 6).astype(np.int32)
    starts, valids = np.asarray(starts, np.int32), np.asarray(valids, np.int32)
    jout, jkv = jitted(JA.attention_prefill_ring, (6,), RING)(
        _layer(jp["blocks"]["l0"])["attn"], jnp.asarray(x), jkv,
        jnp.asarray(rows), jnp.asarray(starts), jnp.asarray(valids), jcfg,
        window=8, ring_pages=R)
    tout, _ = TA.attention_prefill_ring(
        _layer(tp["blocks"]["l0"])["attn"], _t(x), tkv, _t(rows),
        _t(starts), _t(valids), cfg, window=8, ring_pages=R)
    for g in range(G):
        v = valids[g]
        np.testing.assert_allclose(tout[g, :v].numpy(),
                                   np.asarray(jout)[g, :v], atol=2e-5, rtol=0)
    _close(jkv, tkv, N)


# ---------------------------------------------------------------- model steps
def test_gemma3_prefill_then_decode_steps(gemma):
    """Packed prefill (a chunk that wraps the 36-slot ring) and two decode
    steps of reduced gemma3 against the reference, logits and pools."""
    jcfg, cfg, jp, tp = gemma
    N, bs = 40, 4
    jpool = JT.init_paged_state(jcfg, N, bs)
    tpool = TT.init_paged_state(cfg, N, bs, device="cpu")
    rng = np.random.default_rng(9)
    tables = rng.permutation(N)[:2 * 16].reshape(2, 16).astype(np.int32)
    C = 48
    tokens = rng.integers(0, cfg.vocab_size, (2, C)).astype(np.int32)
    args = (tokens, tables, np.asarray([0, 0], np.int32),
            np.asarray([C, 21], np.int32), np.asarray([0, 1], np.int32))
    jl, jpool = jitted(JT.paged_prefill_packed, (0,))(
        jcfg, jp, jpool, *[jnp.asarray(a) for a in args])
    tl, _ = TT.paged_prefill_packed(cfg, tp, tpool, _t(tokens).long(),
                                    *[_t(a) for a in args[1:]])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    seq = np.asarray([C, 21], np.int32)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(2):
        step = (tables, seq, seq + 1)
        jl, jpool = jitted(JT.paged_decode_step, (0,))(
            jcfg, jp, jpool, {"token": jnp.asarray(tok)},
            *[jnp.asarray(a) for a in step])
        tl, _ = TT.paged_decode_step(cfg, tp, tpool,
                                     {"token": _t(tok).long()},
                                     *[_t(a) for a in step])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok, seq = np.argmax(np.asarray(jl), -1).astype(np.int32), seq + 1
    for name in ("l0", "l1"):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tpool[name][kv][:, :N].numpy(),
                                       np.asarray(jpool[name][kv]),
                                       atol=1e-5, rtol=0)


# ------------------------------------------------------------------- engine
def _serve_both(model, prompts, news, **ek):
    jcfg, cfg, jp, tp = model
    outs, engines = [], []
    for eng in (JaxEngine(jcfg, jp, JaxEngineConfig(**ek)),
                Engine(cfg, tp, EngineConfig(**ek), device="cpu")):
        rids = []
        for p, m in zip(prompts, news):
            rids.append(eng.add_request(p, m))
            eng.step()
        got = eng.drain()
        outs.append([got[r] for r in rids])
        engines.append(eng)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    jeng, teng = engines
    assert ({k: teng.stats[k] for k in STATS}
            == {k: jeng.stats[k] for k in STATS})
    assert teng.bucket_dispatches() == jeng.bucket_dispatches()
    assert teng.block_pool.num_free == teng.ecfg.num_blocks
    assert not teng.prefix_caching
    teng.block_pool.check()
    for rid in teng.telemetry.tracer.request_ids():
        validate_order(teng.telemetry.tracer.request_events(rid))
    return teng


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def test_gemma3_engine_matches_reference(gemma):
    """Prompts of 40 and 70 tokens wrap the 36-slot ring of the local
    layer during prefill; long generations decode past further wraps."""
    prompts = _prompts(0, (5, 40, 70, 12, 33), 512)
    _serve_both(gemma, prompts, [10, 30, 8, 20, 12], block_size=4,
                num_blocks=128, max_blocks_per_seq=24, max_slots=3,
                prefill_chunk=16)


@pytest.mark.parametrize("kw", [
    {},
    {"prefills_per_step": 2, "prefill_buckets": (8,)},
], ids=["default", "packed2"])
def test_sliding_engine_matches_reference(sliding, kw):
    """Window 8 at block 4: a 12-slot ring that 16-token chunks lap."""
    prompts = _prompts(1, (3, 26, 9, 17, 30), 50)
    teng = _serve_both(sliding, prompts, [6, 12, 20, 5, 9], block_size=4,
                       num_blocks=64, max_blocks_per_seq=10, max_slots=3,
                       prefill_chunk=16, **kw)
    assert teng.blocks_needed(1000) == 3                 # the ring bound


def test_engine_rejects_ring_wider_than_table(sliding):
    _, cfg, _, tp = sliding
    with pytest.raises(ValueError, match="ring needs"):
        Engine(cfg, tp, EngineConfig(block_size=2, num_blocks=32,
                                     max_blocks_per_seq=4), device="cpu")
