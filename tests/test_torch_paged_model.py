"""Port parity: the paged attention verbs and model steps of
``repro_torch.models`` against ``repro.models`` on the same weights (JAX
``init_params`` converted with ``repro_torch.convert``), the same pools and
tables, float32 on CPU.

Tolerances: logits 1e-4 and attention outputs 1e-5 (float32 sums taken in
another order through two layers); pools after the write 1e-5 on blocks
[:N] — the port's pools carry one extra scratch block at index N that
absorbs the writes the reference drops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.port

CFG_KW = dict(name="pm-t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=50, loss_chunk=16, attn_chunk=16, remat=False,
              dtype="float32")
N, BS, P = 24, 4, 6


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JaxModelConfig(**CFG_KW), ModelConfig(**CFG_KW)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _pools(seed, n_sb=2):
    """Random pools: JAX (n_sb, N, bs, Hkv, hd); the port's copy with a
    random scratch block appended at index N."""
    rng = np.random.default_rng(seed)
    shape = (n_sb, N, BS, 2, 16)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    scratch = rng.standard_normal((n_sb, 1, BS, 2, 16)).astype(np.float32)
    jpool = {"l0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    tpool = {"l0": {"k": torch.from_numpy(np.concatenate([k, scratch], 1)),
                    "v": torch.from_numpy(np.concatenate([v, -scratch], 1))}}
    return jpool, tpool


def _tables(seed, rows):
    rng = np.random.default_rng(seed)
    return rng.permutation(N)[:rows * P].reshape(rows, P).astype(np.int32)


def _close_pools(jpool, tpool, atol=1e-5):
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool["l0"][name][:, :N].numpy(),
                                   np.asarray(jpool["l0"][name]), atol=atol,
                                   rtol=0)


def _layer(tree, sb=0):
    return {k: _layer(v, sb) if isinstance(v, dict) else v[sb]
            for k, v in tree.items()}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_attention_decode_paged(model):
    jcfg, cfg, jp, tp = model
    jpool, tpool = _pools(0, n_sb=1)
    rng = np.random.default_rng(1)
    B = 4
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    tables = _tables(2, B)
    positions = np.asarray([0, 5, 23, 0], np.int32)
    attn_lens = np.asarray([1, 6, 24, 0], np.int32)          # slot 3 inactive
    jkv = {k: v[0] for k, v in jpool["l0"].items()}
    tkv = {k: v[0] for k, v in tpool["l0"].items()}
    jout, jkv = JA.attention_decode_paged(
        _layer(jp["blocks"]["l0"])["attn"], jnp.asarray(x), jkv,
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(attn_lens),
        jcfg)
    tout, _ = TA.attention_decode_paged(
        _layer(tp["blocks"]["l0"])["attn"], _t(x), tkv, _t(tables),
        _t(positions), _t(attn_lens), cfg)
    np.testing.assert_allclose(tout[:3].numpy(), np.asarray(jout)[:3],
                               atol=1e-5, rtol=0)
    _close_pools({"l0": {k: v[None] for k, v in jkv.items()}}, tpool)


def test_attention_prefill_paged(model):
    jcfg, cfg, jp, tp = model
    jpool, tpool = _pools(3, n_sb=1)
    rng = np.random.default_rng(4)
    G, C = 3, 8
    x = rng.standard_normal((G, C, 64)).astype(np.float32)
    rows = _tables(5, G)
    starts = np.asarray([0, 9, 0], np.int32)
    valids = np.asarray([8, 5, 0], np.int32)                 # seg 2: padding
    jkv = {k: v[0] for k, v in jpool["l0"].items()}
    tkv = {k: v[0] for k, v in tpool["l0"].items()}
    jout, jkv = JA.attention_prefill_paged(
        _layer(jp["blocks"]["l0"])["attn"], jnp.asarray(x), jkv,
        jnp.asarray(rows), jnp.asarray(starts), jnp.asarray(valids), jcfg)
    tout, _ = TA.attention_prefill_paged(
        _layer(tp["blocks"]["l0"])["attn"], _t(x), tkv, _t(rows),
        _t(starts), _t(valids), cfg)
    for g in range(G):
        v = valids[g]
        np.testing.assert_allclose(tout[g, :v].numpy(),
                                   np.asarray(jout)[g, :v], atol=1e-5, rtol=0)
    _close_pools({"l0": {k: v[None] for k, v in jkv.items()}}, tpool)


@pytest.mark.parametrize("seed", range(2))
def test_paged_decode_step(model, seed):
    jcfg, cfg, jp, tp = model
    jpool, tpool = _pools(10 + seed)
    rng = np.random.default_rng(seed)
    B = 4
    tokens = rng.integers(0, 50, size=B).astype(np.int32)
    tables = _tables(20 + seed, B)
    seq = rng.integers(1, P * BS, size=B).astype(np.int32)
    active = np.asarray([True, True, False, True])
    positions = np.where(active, seq, 0).astype(np.int32)
    attn_lens = np.where(active, seq + 1, 0).astype(np.int32)
    jl, jpool = JT.paged_decode_step(
        jcfg, jp, jpool, {"token": jnp.asarray(tokens)}, jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(attn_lens))
    tl, tpool = TT.paged_decode_step(
        cfg, tp, tpool, {"token": _t(tokens).long()}, _t(tables),
        _t(positions), _t(attn_lens))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               atol=1e-4, rtol=0)
    _close_pools(jpool, tpool)


@pytest.mark.parametrize("chunk", [8, 5])
def test_paged_prefill_packed(model, chunk):
    jcfg, cfg, jp, tp = model
    jpool, tpool = _pools(30 + chunk)
    rng = np.random.default_rng(chunk)
    S, G = 4, 3                                              # table rows, segs
    tables = _tables(40 + chunk, S)
    tokens = rng.integers(0, 50, size=(G, chunk)).astype(np.int32)
    starts = np.asarray([0, 6, 0], np.int32)
    valids = np.asarray([chunk, 3, 0], np.int32)
    slots = np.asarray([2, 0, S], np.int32)                  # seg 2: padding
    jl, jpool = JT.paged_prefill_packed(
        jcfg, jp, jpool, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(valids), jnp.asarray(slots))
    tl, tpool = TT.paged_prefill_packed(
        cfg, tp, tpool, _t(tokens).long(), _t(tables), _t(starts),
        _t(valids), _t(slots))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=1e-4,
                               rtol=0)
    _close_pools(jpool, tpool)


def test_all_padding_segments_leave_pool_unchanged(model):
    _, cfg, _, tp = model
    _, tpool = _pools(50)
    before = {k: v[:, :N].clone() for k, v in tpool["l0"].items()}
    G, C, S = 2, 8, 4
    zeros = torch.zeros((G,), dtype=torch.int32)
    TT.paged_prefill_packed(
        cfg, tp, tpool, torch.zeros((G, C), dtype=torch.long),
        _t(_tables(51, S)), zeros, zeros,
        torch.full((G,), S, dtype=torch.int32))
    for k, v in before.items():
        assert torch.equal(tpool["l0"][k][:, :N], v)


def test_chunk_near_table_end_does_not_raise(model):
    """Padding positions of a chunk near the end of the table index pages
    past P; the reference fills/clamps there, the port clamps the page
    index before the gather. Only masked rows reach it."""
    jcfg, cfg, jp, tp = model
    jpool, tpool = _pools(60)
    tables = _tables(61, 1)
    C = 8
    start, valid = P * BS - 3, 3                             # pages P-1 .. P+1
    tokens = np.random.default_rng(0).integers(0, 50, (1, C)).astype(np.int32)
    args = (tokens, tables, np.asarray([start], np.int32),
            np.asarray([valid], np.int32), np.asarray([0], np.int32))
    jl, jpool = JT.paged_prefill_packed(jcfg, jp, jpool,
                                        *[jnp.asarray(a) for a in args])
    tl, tpool = TT.paged_prefill_packed(
        cfg, tp, tpool, _t(tokens).long(), *[_t(a) for a in args[1:]])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    _close_pools(jpool, tpool)


def test_paged_prefill_step_is_one_segment(model):
    _, cfg, _, tp = model
    _, pool_a = _pools(70)
    _, pool_b = _pools(70)
    tables = _tables(71, 2)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 50, (1, 8))).long()
    la, _ = TT.paged_prefill_step(cfg, tp, pool_a, tokens, _t(tables[1]),
                                  4, 6, 1)
    lb, _ = TT.paged_prefill_packed(
        cfg, tp, pool_b, tokens, _t(tables),
        *[torch.tensor([v], dtype=torch.int32) for v in (4, 6, 1)])
    assert torch.equal(la, lb)
    for k in ("k", "v"):
        assert torch.equal(pool_a["l0"][k], pool_b["l0"][k])


def test_init_paged_state_layout(model):
    _, cfg, _, _ = model
    pool = TT.init_paged_state(cfg, N, BS, device="cpu")
    for name in ("k", "v"):
        t = pool["l0"][name]
        assert tuple(t.shape) == (2, N + 1, BS, 2, 16)
        assert t.dtype == torch.float32 and not t.any()
        assert t[1].is_contiguous()


def test_init_params_matches_specs_and_seed(model):
    _, cfg, _, tp = model
    a = TT.init_params(cfg, seed=3, device="cpu")
    b = TT.init_params(cfg, seed=3, device="cpu")
    flat_a, flat_b, flat_ref = [], [], []

    def walk(tree, out):
        for k in sorted(tree):
            v = tree[k]
            walk(v, out) if isinstance(v, dict) else out.append(v)
    walk(a, flat_a), walk(b, flat_b), walk(tp, flat_ref)
    for x, y, r in zip(flat_a, flat_b, flat_ref):
        assert torch.equal(x, y)
        assert x.shape == r.shape and x.dtype == r.dtype
    wq = a["blocks"]["l0"]["attn"]["wq"]
    assert abs(float(wq.std()) - 1 / 8) < 0.02              # 1/sqrt(64)


def test_unsupported_families_raise():
    """mrope builds the paged pools of its attention (ROADMAP A17 lifted
    its refusal); MoE likewise; the recurrent (ssm) and hybrid families
    build per-slot slabs beside the paged pools (and need max_slots)."""
    import dataclasses
    base = ModelConfig(**CFG_KW)
    pool = TT.init_paged_state(dataclasses.replace(base, rope_mode="mrope"),
                               4, 4, device="cpu")
    assert {k: tuple(a.shape) for k, a in pool["l0"].items()} == {
        "k": (2, 5, 4, 2, 16), "v": (2, 5, 4, 2, 16)}
    moe = dataclasses.replace(base, family="moe", num_experts=4,
                              experts_per_token=2)
    pool = TT.init_paged_state(moe, 4, 4, device="cpu")
    assert {k: tuple(a.shape) for k, a in pool["l0"].items()} == {
        "k": (2, 5, 4, 2, 16), "v": (2, 5, 4, 2, 16)}
    ssm = dataclasses.replace(base, family="ssm", ssm_type="rwkv6")
    hybrid = dataclasses.replace(base, family="hybrid", ssm_type="mamba2",
                                 hybrid_ssm_per_attn=1, ssm_state_dim=8)
    for cfg in (ssm, hybrid):
        with pytest.raises(ValueError, match="max_slots"):
            TT.init_paged_state(cfg, 4, 4, device="cpu")
    pool = TT.init_paged_state(ssm, 4, 4, max_slots=3, device="cpu")
    assert {k: tuple(a.shape) for k, a in pool["l0"].items()} == {
        "S": (2, 3, 1, 64, 64), "prev": (2, 3, 1, 64),
        "prev_cm": (2, 3, 1, 64)}
    assert pool["l0"]["S"].dtype == torch.float32
    pool = TT.init_paged_state(hybrid, 4, 4, max_slots=3, device="cpu")
    assert {k: tuple(a.shape) for k, a in pool["l0"].items()} == {
        "S": (1, 3, 2, 64, 8), "conv": (1, 3, 3, 144)}
    assert tuple(pool["l1"]["k"].shape) == (1, 5, 4, 2, 16)
    assert not any(bool(a.any()) for layer in pool.values()
                   for a in layer.values())
