"""Port parity for speculative decoding: the drafters (mirroring
tests/test_spec_decode.py::TestDrafters), the plain multi-query verify
attention in full and ring mode against the JAX oracle and Pallas kernel
(interpret mode), the verify write + attention verb, the model's verify
step, ``verify_step``'s greedy acceptance rule, and spec-engine tokens
against the port's non-spec engine and the JAX spec engine on reduced
yi-9b and gemma3.

Inputs come from numpy seeds; float32 on the CPU. Tolerances: attention
outputs 2e-5 (the reference's kernel-vs-oracle tolerance), logits 1e-4
(through two layers), pools 1e-5 on blocks [:N], tokens, acceptance counts
and engine counters exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.kernels.paged_attention import \
    paged_attention_verify as jax_verify_kernel
from repro.kernels.paged_attention import \
    paged_attention_verify_ref as jax_verify_ref
from repro.models import attention as JA
from repro.models import state_providers as JSP
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import SpecConfig as JaxSpecConfig
from repro.serving.engine import spec as JSPEC
from repro_torch import kernels
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.paged_attention import (paged_attention_ref,
                                                 paged_attention_verify,
                                                 paged_attention_verify_ref)
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import (Drafter, DraftModelDrafter, Engine,
                                        EngineConfig, NgramDrafter,
                                        ReplayDrafter, SpecConfig)
from repro_torch.serving.engine import spec as SPEC
from torch_threads import jitted, one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

K = 4
STATS = ("decode_steps", "prefill_chunks", "emitted", "prefix_hit_tokens",
         "cow_copies")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _reduced(name):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(name)),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(name)), dtype="float32")
    return jcfg, cfg


def _model(name):
    jcfg, cfg = _reduced(name)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


@pytest.fixture(scope="module", params=["yi-9b", "gemma3-12b"])
def model(request):
    return _model(request.param)


# ------------------------------------------------------------------ drafters
class _ConstantDrafter:
    """Deliberately terrible drafter (protocol via duck typing)."""

    def __init__(self, tok=0):
        self.tok = tok

    def propose(self, rid, context, n):
        return np.full((n,), self.tok, np.int32)

    def forget(self, rid):
        pass


class TestDrafters:
    def test_ngram_proposes_seen_continuation(self):
        d = NgramDrafter(3)
        out = d.propose(1, np.asarray([1, 2, 3, 4, 1, 2, 3]), 2)
        np.testing.assert_array_equal(out, [4, 1])
        out = d.propose(1, np.asarray([1, 2, 3, 4, 1, 2, 3, 4, 1]), 2)
        np.testing.assert_array_equal(out, [2, 3])

    def test_ngram_fallback_repeats_last_token(self):
        np.testing.assert_array_equal(
            NgramDrafter(3).propose(1, np.asarray([7]), 3), [7, 7, 7])

    def test_ngram_forget_then_repropose(self):
        d = NgramDrafter(2)
        ctx = np.asarray([5, 6, 5, 6, 5, 6])
        first = d.propose(9, ctx, 2)
        d.forget(9)
        np.testing.assert_array_equal(d.propose(9, ctx, 2), first)

    def test_replay_drafter_streams_the_remembered_future(self):
        d = ReplayDrafter()
        stream = np.arange(1, 11, dtype=np.int32)
        d.remember(3, stream)
        np.testing.assert_array_equal(d.propose(3, stream[:4], 3), [5, 6, 7])
        np.testing.assert_array_equal(d.propose(3, stream[:9], 3), [10, 9, 9])
        d.forget(3)
        np.testing.assert_array_equal(d.propose(3, stream[:4], 3), [5, 6, 7])
        np.testing.assert_array_equal(d.propose(4, stream[:4], 2), [4, 4])

    @pytest.mark.parametrize("seed", range(4))
    def test_ngram_matches_reference_on_random_streams(self, seed):
        rng = np.random.default_rng(seed)
        ours, ref = NgramDrafter(2), JSPEC.NgramDrafter(2)
        stream = list(rng.integers(0, 4, size=6))
        for _ in range(20):
            ctx = np.asarray(stream, np.int32)
            np.testing.assert_array_equal(ours.propose(0, ctx, 3),
                                          ref.propose(0, ctx, 3))
            stream += list(rng.integers(0, 4, size=rng.integers(1, 4)))

    def test_protocol_duck_typing(self):
        assert isinstance(NgramDrafter(), Drafter)
        assert isinstance(ReplayDrafter(), Drafter)
        assert isinstance(_ConstantDrafter(), Drafter)
        assert not isinstance(object(), Drafter)

    def test_spec_config_validation(self):
        for bad in (1, 33, 0):
            with pytest.raises(ValueError):
                SpecConfig(k=bad)
        with pytest.raises(ValueError):
            SpecConfig(drafter="beam")
        with pytest.raises(TypeError):
            SpecConfig(drafter=42)
        with pytest.raises(ValueError):
            SpecConfig(ngram=0)
        # as the reference: a name cannot carry the draft model, so the
        # draft-model drafter is passed as an instance
        with pytest.raises(ValueError):
            SpecConfig(drafter="draft_model")
        draft = DraftModelDrafter(reduced(get_config("yi-9b")), {})
        assert isinstance(draft, Drafter)
        assert SpecConfig(drafter=draft).build_drafter() is draft
        assert isinstance(SpecConfig().build_drafter(), NgramDrafter)
        inst = _ConstantDrafter()
        assert SpecConfig(drafter=inst).build_drafter() is inst


# ------------------------------------------------------- verify attention
def _verify_case(seed, B, H, Hkv, hd, N, bs, P, lens, k=K):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, k, H, hd)).astype(np.float32)
    kp = rng.standard_normal((N, bs, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, hd)).astype(np.float32)
    tables = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("H,Hkv,hd", [(4, 4, 32), (4, 2, 64), (8, 1, 32)])
def test_verify_full_matches_reference(H, Hkv, hd, k):
    lens = (k, k + 3, 13 + k, 0, 16, 29 + k)
    case = _verify_case(H * 10 + hd + k, 6, H, Hkv, hd, 80, 4, 12, lens, k)
    kernels.reset_launch_counts()
    out = paged_attention_verify(*[_t(a) for a in case])
    assert sum(kernels.launch_counts.values()) == 0
    assert torch.equal(out, paged_attention_verify_ref(*[_t(a) for a in case]))
    assert bool((out[3] == 0).all())
    jcase = [jnp.asarray(a) for a in case]
    for ref in (jax_verify_ref(*jcase),
                jax_verify_kernel(*jcase, interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_verify_ring_matches_reference(k):
    """Ring verify with draft = k-1 slack at positions before, at and far
    past the first wrap; an inactive slot (lens 0, positions -1)."""
    window, bs = 10, 4
    R = JSP.ring_pages(window, bs, draft=k - 1)
    lens = (k, window, R * bs, R * bs + 1, 5 * R * bs + 3, 0)
    case = _verify_case(k, 6, 4, 2, 32, 6 * (R + 2) + 3, bs, R + 2, lens, k)
    pos = np.asarray(lens, np.int32) - 1
    kw = dict(window=window, ring_pages=R)
    out = paged_attention_verify(*[_t(a) for a in case], positions=_t(pos),
                                 **kw)
    assert bool((out[5] == 0).all())
    jcase = [jnp.asarray(a) for a in case]
    for ref in (jax_verify_ref(*jcase, positions=jnp.asarray(pos), **kw),
                jax_verify_kernel(*jcase, positions=jnp.asarray(pos),
                                  interpret=True, **kw)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_verify_rows_equal_single_query_decode(ring):
    """Verify row j IS a one-token decode at position lens - K + j."""
    window, bs = 8, 4
    R = JSP.ring_pages(window, bs, draft=K - 1)
    lens = np.asarray((K, 9, 17, 0, 40) if ring else (K, 7, 13, 0, 29),
                      np.int32)
    P = R if ring else 8
    q, kp, vp, tables, _ = [_t(a) for a in _verify_case(
        3, 5, 4, 2, 32, 64, bs, P, lens)]
    kw = dict(window=window, ring_pages=R) if ring else {}
    pos = {"positions": _t(lens - 1)} if ring else {}
    full = paged_attention_verify_ref(q, kp, vp, tables, _t(lens), **kw,
                                      **pos)
    for j in range(K):
        lens_j = np.where(lens > 0, lens - K + 1 + j, 0).astype(np.int32)
        pos_j = {"positions": _t(np.maximum(lens_j - 1, 0))} if ring else {}
        dec = paged_attention_ref(q[:, j], kp, vp, tables, _t(lens_j), **kw,
                                  **pos_j)
        np.testing.assert_allclose(full[:, j].numpy(), dec.numpy(),
                                   atol=1e-6, err_msg=f"row {j}")


@pytest.mark.parametrize("layer", [0, 1], ids=["local", "global"])
def test_attention_verify_paged(layer):
    """Reduced gemma3's local (ring) and global (full) layer: verify output
    and the pool after the qlims-capped writes."""
    jcfg, cfg, jp, tp = _model("gemma3-12b")
    window = cfg.window_size if layer == 0 else None
    R = JSP.ring_pages(cfg.window_size, 4, draft=K - 1) if layer == 0 else None
    N, bs = 48, 4
    rng = np.random.default_rng(11)
    k = rng.standard_normal((N, bs, 2, 64)).astype(np.float32)
    v = rng.standard_normal((N, bs, 2, 64)).astype(np.float32)
    jkv = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tkv = {"k": _t(np.concatenate([k, k[:1]])),
           "v": _t(np.concatenate([v, v[:1]]))}
    B = 4
    x = rng.standard_normal((B, K, cfg.d_model)).astype(np.float32)
    tables = rng.permutation(N)[:B * 12].reshape(B, 12).astype(np.int32)
    base = np.asarray([3, 30, 41, 0], np.int32)
    qlims = np.asarray([4, 2, 1, 0], np.int32)
    lp = lambda tree: {kk: (lambda t: {a: b[0] for a, b in t.items()})(vv)
                       if isinstance(vv, dict) else vv[0]
                       for kk, vv in tree.items()}
    jout, jkv = jitted(JA.attention_verify_paged, (6,),
                       ("window", "ring_pages"))(
        lp(jp["blocks"][f"l{layer}"]["attn"]), jnp.asarray(x), jkv,
        jnp.asarray(tables), jnp.asarray(base), jnp.asarray(qlims), jcfg,
        window=window, ring_pages=R)
    tout, _ = TA.attention_verify_paged(
        lp(tp["blocks"][f"l{layer}"]["attn"]), _t(x), tkv, _t(tables),
        _t(base), _t(qlims), cfg, window=window, ring_pages=R)
    for b in range(3):
        np.testing.assert_allclose(tout[b, :qlims[b]].numpy(),
                                   np.asarray(jout)[b, :qlims[b]],
                                   atol=2e-5, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name][:N].numpy(),
                                   np.asarray(jkv[name]), atol=1e-5, rtol=0)


# --------------------------------------------------- verify step + acceptance
def _prefilled(jcfg, cfg, jp, tp):
    """Slot 0 prefilled with a 6-token prompt in both packages."""
    jpool = JT.init_paged_state(jcfg, 32, 4)
    tpool = TT.init_paged_state(cfg, 32, 4, device="cpu")
    tables = np.arange(24, dtype=np.int32).reshape(2, 12)  # >= gemma3's ring
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=6).astype(np.int32)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = prompt
    jl, jpool = jitted(JT.paged_prefill_step, (0,))(
        jcfg, jp, jpool, jnp.asarray(toks), jnp.asarray(tables[0]), 0, 6, 0)
    TT.paged_prefill_step(cfg, tp, tpool, _t(toks).long(), _t(tables[0]),
                          0, 6, 0)
    return jpool, tpool, tables, int(np.argmax(np.asarray(jl[0])))


def _sequential(cfg, tp, tpool, tables, t0, k=3):
    """k one-token port decode steps on a copy of the pool: the fed tokens
    [t0, g0 .. g_{k-2}] and the per-step logits rows."""
    pool = {n: {a: b.clone() for a, b in st.items()}
            for n, st in tpool.items()}
    cur, fed, rows = t0, [t0], []
    for j in range(k):
        lg, _ = TT.paged_decode_step(
            cfg, tp, pool, {"token": torch.tensor([cur, 0])}, _t(tables),
            torch.tensor([6 + j, 0], dtype=torch.int32),
            torch.tensor([7 + j, 0], dtype=torch.int32))
        rows.append(lg[0].numpy())
        cur = int(np.argmax(rows[-1]))
        if j < k - 1:
            fed.append(cur)
    return fed, np.stack(rows)


def test_verify_step_logits_match_sequential_decode_and_reference(model):
    jcfg, cfg, jp, tp = model
    jpool, tpool, tables, t0 = _prefilled(jcfg, cfg, jp, tp)
    fed, rows = _sequential(cfg, tp, tpool, tables, t0)
    tokens = np.zeros((2, 3), np.int32)
    tokens[0] = fed
    base, qlims = np.asarray([6, 0], np.int32), np.asarray([3, 0], np.int32)
    jl, _ = jitted(JT.paged_verify_step, (0,))(
        jcfg, jp, jpool, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(base), jnp.asarray(qlims))
    tl, _ = TT.paged_verify_step(cfg, tp, tpool, _t(tokens).long(),
                                 _t(tables), _t(base), _t(qlims))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tl[0].numpy(), rows, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.argmax(tl[0].numpy(), -1),
                                  np.argmax(rows, -1))


@pytest.mark.parametrize("wrong_at,qlim,want", [(None, 3, 3), (2, 3, 2),
                                                (1, 3, 1), (None, 1, 1)])
def test_acceptance_rule(wrong_at, qlim, want):
    """accepts = 1 + longest verified draft prefix, capped at qlims; the
    same greedy run, counts and lengths as the reference's verify_step."""
    jcfg, cfg, jp, tp = _model("gemma3-12b")
    jpool, tpool, tables, t0 = _prefilled(jcfg, cfg, jp, tp)
    fed, rows = _sequential(cfg, tp, tpool, tables, t0)
    greedy_true = np.argmax(rows, -1)
    drafts = list(fed)
    if wrong_at is not None:
        drafts[wrong_at] = int(greedy_true[wrong_at - 1] + 1) % cfg.vocab_size
    tokens = np.zeros((2, 3), np.int32)
    tokens[0] = drafts
    args = (tables, np.asarray([6, 0], np.int32), np.asarray([True, False]),
            np.asarray([qlim, 0], np.int32))
    greedy, accepts, _, new_lens, pool = SPEC.verify_step(
        cfg, tp, tpool, _t(tokens), *[_t(a) for a in args])
    assert accepts.tolist() == [want, 0]
    assert new_lens.tolist() == [6 + want, 0]
    np.testing.assert_array_equal(greedy[0, :want].numpy(),
                                  greedy_true[:want])
    assert pool is tpool
    jg, ja, _, jlens, _ = JSPEC.verify_step(
        jcfg, jp, jpool, jnp.asarray(tokens), *[jnp.asarray(a) for a in args])
    assert accepts.tolist() == np.asarray(ja).tolist()
    assert new_lens.tolist() == np.asarray(jlens).tolist()
    np.testing.assert_array_equal(greedy[0, :want].numpy(),
                                  np.asarray(jg)[0, :want])


def test_all_inactive_verify_leaves_the_pool(model):
    """The engine's warmup call: every slot inactive, qlims 0 — blocks
    [0, N) must come back unchanged (writes go to the scratch block)."""
    jcfg, cfg, jp, tp = model
    _, tpool, tables, _ = _prefilled(jcfg, cfg, jp, tp)
    before = {n: {a: b[:, :32].clone() for a, b in st.items()}
              for n, st in tpool.items()}
    z = torch.zeros((2,), dtype=torch.int32)
    _, accepts, _, new_lens, _ = SPEC.verify_step(
        cfg, tp, tpool, torch.zeros((2, 3), dtype=torch.int32), _t(tables),
        z, torch.zeros((2,), dtype=torch.bool), z)
    assert accepts.tolist() == [0, 0] and new_lens.tolist() == [0, 0]
    for n, st in before.items():
        for a, b in st.items():
            assert torch.equal(tpool[n][a][:, :32], b)


# ------------------------------------------------------------------- engine
def _serve(eng, prompts, news):
    rids = []
    for p, m in zip(prompts, news):
        rids.append(eng.add_request(p, m))
        eng.step()
    got = eng.drain()
    return [got[r].tolist() for r in rids]


def test_spec_engine_matches_plain_port_and_reference(model):
    """Greedy tokens with SpecConfig(k=4) equal the port's non-spec engine
    and the JAX spec engine; counters equal the JAX spec engine's."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(5)
    base = [rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)]
    prompts = [np.concatenate([base[0]] * 4),          # repetition: n-gram hits
               rng.integers(0, cfg.vocab_size, 45).astype(np.int32),
               rng.integers(0, cfg.vocab_size, 9).astype(np.int32),
               rng.integers(0, cfg.vocab_size, 3).astype(np.int32)]
    news = [18, 12, 25, 7]
    ek = dict(block_size=4, num_blocks=96, max_blocks_per_seq=24,
              max_slots=3, prefill_chunk=16)
    plain = _serve(Engine(cfg, tp, EngineConfig(**ek), device="cpu"),
                   prompts, news)
    teng = Engine(cfg, tp, EngineConfig(**ek, spec=SpecConfig(k=K)),
                  device="cpu")
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ek,
                                               spec=JaxSpecConfig(k=K)))
    spec, jspec = _serve(teng, prompts, news), _serve(jeng, prompts, news)
    assert spec == plain == jspec
    assert ({k: teng.stats[k] for k in STATS}
            == {k: jeng.stats[k] for k in STATS})
    reg, jreg = teng.telemetry.registry, jeng.telemetry.registry
    for name in ("engine_verify_steps_total", "engine_draft_tokens_total",
                 "engine_accepted_tokens_total"):
        assert reg.get(name).value == jreg.get(name).value, name
    assert reg.get("engine_accepted_tokens_total").value > 0
    assert teng.block_pool.num_free == ek["num_blocks"]
    assert teng.telemetry.recompiles.variants()["verify"] == 1


def test_replay_drafter_accepts_every_draft(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30)]
    news = [14, 9]
    ek = dict(block_size=4, num_blocks=64, max_blocks_per_seq=16,
              max_slots=2, prefill_chunk=8)
    plain = _serve(Engine(cfg, tp, EngineConfig(**ek), device="cpu"),
                   prompts, news)
    replay = ReplayDrafter()
    for rid, (p, out) in enumerate(zip(prompts, plain)):
        replay.remember(rid, np.concatenate([p, out]))
    eng = Engine(cfg, tp, EngineConfig(**ek, spec=SpecConfig(
        k=K, drafter=replay)), device="cpu")
    assert _serve(eng, prompts, news) == plain
    reg = eng.telemetry.registry
    assert (reg.get("engine_accepted_tokens_total").value
            == reg.get("engine_draft_tokens_total").value > 0)
