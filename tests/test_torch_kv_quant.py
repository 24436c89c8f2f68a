"""Port parity for int8 paged KV (``EngineConfig.kv_quant``): the quantizer
against the JAX ``quantize_kv`` / ``dequantize_kv``, the plain paged
attention with scales (all four modes) against the ref on the dequantized
pool and against the JAX oracle, the quantizing writes and prefill verbs,
the wrappers' checks, the quant-aware allocator, providers and engine
gauge, the defrag and copy-on-write paths carrying the scales, and engine
greedy tokens against the JAX ``Engine`` with int8 pools on the full,
sliding and reduced gemma3 configs, with and without speculation.

Inputs come from numpy seeds; float32 on the CPU. Tolerances: the
quantizer, int8 pool values and scales bitwise; ref-with-scales vs ref on
the dequantized pool bitwise (the same f32 multiply); attention outputs vs
the JAX oracle 2e-5 (the reference's kernel-vs-oracle tolerance); pools
written from K/V that passed through a matmul 1e-5 on the scales, int8
values within one step (a K/V element that sits on a rounding tie in one
framework may round the other way after last-bit matmul differences);
tokens, counters and byte counts exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.kernels.paged_attention import ref as JREF
from repro.kernels.quantize import KVQuantConfig as JaxKVQuantConfig
from repro.kernels.quantize import dequantize_kv as jax_dequantize_kv
from repro.kernels.quantize import quantize_kv as jax_quantize_kv
from repro.models import attention as JA
from repro.models import state_providers as JSP
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import SpecConfig as JaxSpecConfig
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref,
                                                 paged_attention_verify,
                                                 paged_attention_verify_ref)
from repro_torch.kernels.paged_attention import ops as OPS
from repro_torch.kernels.paged_attention.kernel import (multi_smem_bytes,
                                                        tile_dtype)
from repro_torch.kernels.quantize import (KVQuantConfig, dequantize_kv,
                                          quantize_kv)
from repro_torch.models import attention as TA
from repro_torch.models import state_providers as SP
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Engine, EngineConfig, SpecConfig
from repro_torch.serving.telemetry import validate_order
from torch_threads import jitted, one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

KW = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
          num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=50, loss_chunk=16,
          attn_chunk=16, remat=False, dtype="float32")
STATS = ("decode_steps", "prefill_chunks", "emitted", "prefix_hit_tokens",
         "cow_copies")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _configs(kind):
    if kind == "gemma3":
        return (dataclasses.replace(jax_reduced(jax_get_config("gemma3-12b")),
                                    dtype="float32"),
                dataclasses.replace(reduced(get_config("gemma3-12b")),
                                    dtype="float32"))
    kw = dict(KW, name=f"kvq-{kind}")
    if kind == "sliding":
        kw.update(attention_type="sliding", window_size=8)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _model(kind):
    jcfg, cfg = _configs(kind)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


@pytest.fixture(scope="module", params=["full", "sliding", "gemma3"])
def model(request):
    return _model(request.param)


# ------------------------------------------------------------------ quantizer
def _quant_inputs(case):
    rng = np.random.default_rng(0)
    if case == "normal":
        return rng.standard_normal((3, 5, 16)).astype(np.float32)
    if case == "wide":
        x = rng.standard_normal((4, 2, 64)).astype(np.float32)
        return x * np.float32(10.0) ** rng.integers(-6, 6, size=(4, 2, 1))
    if case == "zeros":
        x = rng.standard_normal((4, 8)).astype(np.float32)
        x[1] = 0.0
        x[3] = -0.0
        return x
    # exact .5 ties: amax 127 gives scale 1.0, so x / scale keeps the ties
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                  [-127.0, 3.5, -3.5, 4.5, 0.0, 5.5, -6.5, 7.5]], np.float32)
    return x


@pytest.mark.parametrize("case", ["normal", "wide", "zeros", "ties"])
def test_quantize_kv_matches_reference_bitwise(case):
    x = _quant_inputs(case)
    q, s = quantize_kv(_t(x))
    jq, js = jax_quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_kv(q, s).numpy(),
                                  np.asarray(jax_dequantize_kv(jq, js)))
    if case == "zeros":
        assert s[1].item() == s[3].item() == 1.0
        assert not q[1].any() and not q[3].any()
    if case == "ties":                  # half to even, as jnp.round
        assert q[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_kv_quant_config_only_int8():
    assert KVQuantConfig().bits == 8
    with pytest.raises(ValueError, match="int8"):
        KVQuantConfig(bits=4)
    assert hash(KVQuantConfig()) == hash(KVQuantConfig())


# ---------------------------------------------- plain attention with scales
def _int8_case(mode, seed, K=3):
    """(args, kwargs) of one plain-attention call on int8 pools, in numpy."""
    rng = np.random.default_rng(seed)
    B, H, Hkv, hd, N, bs, P = 3, 4, 2, 16, 20, 4, 5
    window = R = None
    if mode.startswith("ring"):
        window, R = 7, 3
    lens = (np.array([K + 1, 11, 0], np.int32) if mode.endswith("verify")
            else np.array([1, 17, 0], np.int32))
    shape = (B, K, H, hd) if mode.endswith("verify") else (B, H, hd)
    q = rng.standard_normal(shape).astype(np.float32)
    kq = rng.integers(-128, 128, size=(N, bs, Hkv, hd)).astype(np.int8)
    vq = rng.integers(-128, 128, size=(N, bs, Hkv, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, size=(N, bs, Hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, size=(N, bs, Hkv)).astype(np.float32)
    tables = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    kw = {}
    if R is not None:
        kw = dict(window=window, positions=np.maximum(lens - 1, 0),
                  ring_pages=R)
    return (q, kq, vq, tables, lens), kw, (ks, vs)


MODES = ["decode", "ring", "verify", "ring_verify"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_ref_with_scales_equals_ref_on_dequantized_pool(mode, seed):
    """Bitwise (the same f32 multiply before the same attention), and
    within 2e-5 of the JAX oracle with scales."""
    args, kw, (ks, vs) = _int8_case(mode, seed)
    plain = (paged_attention_verify_ref if mode.endswith("verify")
             else paged_attention_ref)
    jplain = (JREF.paged_attention_verify_ref if mode.endswith("verify")
              else JREF.paged_attention_ref)
    targs = [_t(a) for a in args]
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    scales = dict(k_scale=_t(ks), v_scale=_t(vs))
    out = plain(*targs, **tkw, **scales)
    deq = [targs[0], dequantize_kv(targs[1], scales["k_scale"]),
           dequantize_kv(targs[2], scales["v_scale"]), *targs[3:]]
    assert torch.equal(out, plain(*deq, **tkw))
    # the wrapper takes the plain version for CPU tensors
    wrapper = (paged_attention_verify if mode.endswith("verify")
               else paged_attention)
    assert torch.equal(out, wrapper(*targs, **tkw, **scales))
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jout = jplain(*[jnp.asarray(a) for a in args], **jkw,
                  k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=0)
    assert not out[2].any()             # the inactive slot


def test_scales_come_in_pairs():
    args, _, (ks, _) = _int8_case("decode", 0)
    targs = [_t(a) for a in args]
    with pytest.raises(ValueError, match="together"):
        paged_attention(*targs, k_scale=_t(ks))
    with pytest.raises(ValueError, match="together"):
        paged_attention_verify_ref(targs[0][:, None], *targs[1:],
                                   v_scale=_t(ks))


def test_wrapper_checks_int8_pools_and_scales():
    """What a CUDA launch validates first (``ops._check`` runs on any
    device): int8 pools need both f32 (N, bs, Hkv) scales, pools of q's
    dtype need none."""
    args, _, (ks, vs) = _int8_case("decode", 0)
    q, kq, vq, tables, lens = [_t(a) for a in args]
    OPS._check(q, kq, vq, tables, lens, _t(ks), _t(vs))        # accepted
    with pytest.raises(TypeError, match="int8"):
        OPS._check(q, kq, vq, tables, lens)
    with pytest.raises(TypeError, match="int8"):
        OPS._check(q, kq.float(), vq.float(), tables, lens, _t(ks), _t(vs))
    with pytest.raises(ValueError, match="scales"):
        OPS._check(q, kq, vq, tables, lens, _t(ks)[:, :2], _t(vs))
    with pytest.raises(ValueError, match="scales"):
        OPS._check(q, kq, vq, tables, lens, _t(ks).double(), _t(vs))
    strided = _t(ks).transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        OPS._check(q, kq, vq, tables, lens, strided, _t(vs))
    # the int8 tile is f32: the shared-memory check sizes it as an f32 pool's
    assert tile_dtype(torch.int8) == torch.float32
    assert (multi_smem_bytes(tile_dtype(torch.int8), 128, 16)
            == multi_smem_bytes(torch.float32, 128, 16))


# ----------------------------------------------------- writes and prefill
def _pools(kind, N=12, bs=4, hkv=2, hd=16):
    jpool = JSP.alloc_kv_pool((N, bs), hkv, hd, jnp.float32,
                              JaxKVQuantConfig())
    tpool = SP.alloc_kv_pool((N + 1, bs), hkv, hd, torch.float32, "cpu",
                             KVQuantConfig())
    return jpool, tpool


def _assert_pools_equal(jpool, tpool, N, exact=True):
    """Port pools (block axis first, or after a leading superblock axis
    when `exact` is False) against the reference's on blocks [:N]."""
    for name in ("k", "v", "k_scale", "v_scale"):
        got = (tpool[name][:N] if exact else tpool[name][:, :N]).numpy()
        want = np.asarray(jpool[name])
        if exact or name.endswith("scale"):
            np.testing.assert_allclose(got, want, atol=0 if exact else 1e-5,
                                       rtol=0, err_msg=name)
        else:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("ring", [False, True])
def test_paged_write_multi_matches_reference(ring):
    """Identical K/V inputs: int8 values and scales equal exactly on [:N];
    dropped writes land in the scratch block only."""
    rng = np.random.default_rng(3)
    N, bs, B, K = 12, 4, 3, 3
    jpool, tpool = _pools("full", N, bs)
    tables = rng.permutation(N)[:B * 4].reshape(B, 4).astype(np.int32)
    pos = np.array([[0, 1, 2], [5, 6, 7], [13, 14, 15]], np.int32)
    valid = np.array([[1, 1, 1], [1, 0, 1], [0, 0, 0]], bool)
    k = rng.standard_normal((B, K, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, K, 2, 16)).astype(np.float32)
    k[0, 1] = 0.0                        # an all-zero vector: scale 1.0
    rp = 3 if ring else None
    jpool = JA.paged_write_multi(jpool, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(tables), jnp.asarray(pos),
                                 jnp.asarray(valid), ring_pages=rp)
    out = TA.paged_write_multi(tpool, _t(k), _t(v), _t(tables), _t(pos),
                               _t(valid), ring_pages=rp)
    assert out is tpool
    _assert_pools_equal(jpool, tpool, N)
    # one-token writes go through the same path
    jp1, tp1 = _pools("full", N, bs)
    jp1 = JA.paged_write(jp1, jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]),
                         jnp.asarray(tables), jnp.asarray(pos[:, 0]),
                         jnp.asarray(valid[:, 0]), ring_pages=rp)
    TA.paged_write(tp1, _t(k[:, 0]), _t(v[:, 0]), _t(tables), _t(pos[:, 0]),
                   _t(valid[:, 0]), ring_pages=rp)
    _assert_pools_equal(jp1, tp1, N)


def _prefill_both(kind, kv_seed=4):
    """One quantized packed prefill (2 segments, the second a chunk that
    laps the ring in sliding configs) through both packages' model step;
    returns the logits and pools."""
    jcfg, cfg, jp, tp = _model(kind)
    N, bs = 40, 4
    jpool = JT.init_paged_state(jcfg, N, bs, kv_quant=JaxKVQuantConfig())
    tpool = TT.init_paged_state(cfg, N, bs, device="cpu",
                                kv_quant=KVQuantConfig())
    rng = np.random.default_rng(kv_seed)
    tables = rng.permutation(N)[:2 * 10].reshape(2, 10).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    starts = np.array([0, 4], np.int32)
    valids = np.array([9, 16], np.int32)
    slots = np.array([0, 1], np.int32)
    prefill = jitted(JT.paged_prefill_packed, (0,))
    jl, jpool = prefill(jcfg, jp, jpool, jnp.asarray(tokens),
                        jnp.asarray(tables), jnp.asarray(starts),
                        jnp.asarray(valids), jnp.asarray(slots))
    tl, tpool = TT.paged_prefill_packed(cfg, tp, tpool, _t(tokens).long(),
                                        _t(tables), _t(starts), _t(valids),
                                        _t(slots))
    return jl, jpool, tl, tpool, N


@pytest.mark.parametrize("kind", ["full", "sliding", "gemma3"])
def test_quantized_prefill_matches_reference(kind):
    """Prefill writes int8 values and scales and attends what the decode
    kernels will read back: logits within 1e-4 (two layers), scales within
    1e-5, int8 values within one step (see the module docstring)."""
    jl, jpool, tl, tpool, N = _prefill_both(kind)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for name, st in tpool.items():
        assert st["k"].dtype == torch.int8
        _assert_pools_equal(jpool[name], st, N, exact=False)


# ---------------------------------------------------- allocation, providers
def test_init_paged_state_quantized_layout():
    _, cfg = _configs("gemma3")
    pool = TT.init_paged_state(cfg, 10, 4, device="cpu",
                               kv_quant=KVQuantConfig())
    n_sb, _ = SP.superblock_layout(cfg)
    for st in pool.values():
        assert set(st) == {"k", "v", "k_scale", "v_scale"}
        hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        assert st["k"].shape == (n_sb, 11, 4, hkv, hd)
        assert st["k"].dtype == torch.int8 and not st["k"].any()
        assert st["k_scale"].shape == (n_sb, 11, 4, hkv)
        assert st["k_scale"].dtype == torch.float32
        assert bool((st["v_scale"] == 1.0).all())   # scratch block included


@pytest.mark.parametrize("kind", ["full", "sliding", "gemma3"])
def test_state_bytes_and_saved_gauge_match_reference(kind):
    jcfg, cfg = _configs(kind)
    for jq, tq in ((None, None), (JaxKVQuantConfig(), KVQuantConfig())):
        jprov = JSP.providers_for(jcfg, num_blocks=64, block_size=4,
                                  max_slots=4, max_blocks_per_seq=16,
                                  kv_quant=jq)
        tprov = SP.providers_for(cfg, num_blocks=64, block_size=4,
                                 max_blocks_per_seq=16, kv_quant=tq)
        for total in (1, 9, 40, 64):
            assert ([p.state_bytes_per_slot(total) for p in tprov]
                    == [p.state_bytes_per_slot(total) for p in jprov])
            assert (SP.state_memory_per_slot(cfg, tprov, total)
                    == JSP.state_memory_per_slot(jcfg, jprov, total))
        assert ([p.pool_bytes_saved() for p in tprov]
                == [p.pool_bytes_saved() for p in jprov])
        assert (tq is None) == all(p.pool_bytes_saved() == 0 for p in tprov)


def test_kv_quant_bytes_saved_gauge_matches_reference(model):
    jcfg, cfg, jp, tp = model
    ek = dict(block_size=4, num_blocks=32, max_blocks_per_seq=16,
              max_slots=2, prefill_chunk=8)
    for jq, tq in ((None, None), (JaxKVQuantConfig(), KVQuantConfig())):
        jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ek, kv_quant=jq))
        teng = Engine(cfg, tp, EngineConfig(**ek, kv_quant=tq), device="cpu")
        name = "kv_quant_bytes_saved_total"
        want = jeng.telemetry.registry.snapshot()[name]
        assert teng.telemetry.registry.snapshot()[name] == want
        assert (want > 0) == (tq is not None)


def test_defrag_remap_and_copy_block_carry_scales():
    """The defrag gather and the copy-on-write block copy iterate over the
    pool dict's values, so the scale pools move with their blocks."""
    _, cfg = _configs("full")
    prov = SP.providers_for(cfg, num_blocks=6, block_size=2,
                            kv_quant=KVQuantConfig())[0]
    st = prov.init_layer_state(2, "cpu")
    gen = torch.Generator().manual_seed(0)
    for a in st.values():
        a.copy_(torch.randint(-100, 100, a.shape, generator=gen).to(a.dtype))
    before = {n: a.clone() for n, a in st.items()}
    perm = torch.tensor([3, 0, 5, 1, 2, 4])
    prov.defrag_remap(st, perm)
    for n, a in st.items():
        assert torch.equal(a[:, :6], before[n][:, perm]), n
        assert torch.equal(a[:, 6], before[n][:, 6])    # scratch untouched
    eng = Engine(cfg, TT.init_params(cfg, seed=0, device="cpu"),
                 EngineConfig(block_size=2, num_blocks=6, max_blocks_per_seq=4,
                              max_slots=1, prefill_chunk=4,
                              kv_quant=KVQuantConfig()), device="cpu")
    pool = eng.pool_state
    for layer in pool.values():
        for a in layer.values():
            a.copy_(torch.randint(-100, 100, a.shape,
                                  generator=gen).to(a.dtype))
    eng._copy_block(pool, 4, 1)
    for layer in pool.values():
        assert set(layer) == {"k", "v", "k_scale", "v_scale"}
        for a in layer.values():
            assert torch.equal(a[:, 1], a[:, 4])


# ------------------------------------------------------------------- engine
def _serve(eng, prompts, news, stagger=True):
    rids = []
    for p, m in zip(prompts, news):
        rids.append(eng.add_request(p, m))
        if stagger:
            eng.step()
    got = eng.drain()
    return [got[r].tolist() for r in rids]


@pytest.mark.parametrize("spec", [None, 4], ids=["plain", "spec4"])
def test_int8_engine_matches_reference(model, spec):
    """Greedy tokens and counters equal the JAX engine's with int8 pools;
    with speculation they also equal the port's int8 run without it."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 19, 8, 30, 12)]
    news = [7, 11, 5, 9, 13]
    ek = dict(block_size=4, num_blocks=80, max_blocks_per_seq=16,
              max_slots=3, prefill_chunk=8)
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(
        **ek, kv_quant=JaxKVQuantConfig(),
        spec=JaxSpecConfig(k=spec) if spec else None))
    teng = Engine(cfg, tp, EngineConfig(
        **ek, kv_quant=KVQuantConfig(),
        spec=SpecConfig(k=spec) if spec else None), device="cpu")
    want, got = _serve(jeng, prompts, news), _serve(teng, prompts, news)
    assert got == want
    assert ({k: teng.stats[k] for k in STATS}
            == {k: jeng.stats[k] for k in STATS})
    assert teng.block_pool.num_free == ek["num_blocks"]
    teng.block_pool.check()
    if spec:
        plain = Engine(cfg, tp, EngineConfig(**ek, kv_quant=KVQuantConfig()),
                       device="cpu")
        assert _serve(plain, prompts, news) == got


def test_int8_prefix_hit_cow_and_defragment_match_reference():
    """Full-attention config: a prefix-cache hit (shared int8 blocks and
    their scales read back as written), a copy-on-write replay and a
    mid-flight defragment — tokens and counters equal the JAX engine's."""
    jcfg, cfg, jp, tp = _model("full")
    rng = np.random.default_rng(23)
    prefix = rng.integers(0, 50, size=12).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 50, size=n)
                               .astype(np.int32)]) for n in (3, 5, 2)]
    ek = dict(block_size=4, num_blocks=64, max_blocks_per_seq=12,
              max_slots=3, prefill_chunk=8)
    outs = []
    engines = (JaxEngine(jcfg, jp, JaxEngineConfig(
                   **ek, kv_quant=JaxKVQuantConfig())),
               Engine(cfg, tp, EngineConfig(**ek, kv_quant=KVQuantConfig()),
                      device="cpu"))
    for eng in engines:
        rids = [eng.add_request(prefix, 3)]
        eng.drain()
        for p in prompts:
            rids.append(eng.add_request(p, 6))
            eng.step()
        eng.defragment()
        eng.drain()
        rids.append(eng.add_request(prefix, 4))   # whole prompt cached: CoW
        got = eng.drain()
        outs.append([got[r].tolist() for r in rids])
    jeng, teng = engines
    assert outs[1] == outs[0]
    assert teng.stats["prefix_hit_tokens"] > 0 and teng.stats["cow_copies"] == 1
    assert ({k: teng.stats[k] for k in STATS}
            == {k: jeng.stats[k] for k in STATS})
    assert teng.block_pool.num_free == ek["num_blocks"]
    for rid in teng.telemetry.tracer.request_ids():
        validate_order(teng.telemetry.tracer.request_events(rid))
