"""Port parity: the recurrent (rwkv6) and hybrid (zamba2: mamba2 layers and
one shared attention layer a superblock) families through the port's
serving engine, against the JAX engine and ``serve.generate`` on the CPU
with converted weights (reduced f32 configs).

Greedy tokens EQUAL between the port engine, the JAX engine and the port's
``generate`` (itself equal to JAX's); the packed prefill's slabs and the
verify step's checkpoints within 1e-5 of JAX's (relative to each
tensor's scale, as test_torch_ssm.py); ``select_checkpoint`` equal
to JAX's; n-gram speculation, forced preemption (snapshot resume for the
pure-recurrent rwkv6, re-prefill for the hybrid) and a reused slot all
give the tokens of the plain run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import state_providers as JSP
from repro.models import transformer as JT
from repro.serving import serve as JS
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import state_providers as SP
from repro_torch.models import transformer as TT
from repro_torch.serving import serve as TS
from repro_torch.serving.engine import (Engine, EngineConfig, OversubConfig,
                                        SpecConfig)
from torch_threads import jitted, one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

ARCHS = ["rwkv6-7b", "zamba2-2.7b"]
ENGINE_KW = dict(block_size=4, num_blocks=64, max_blocks_per_seq=10,
                 max_slots=3, prefill_chunk=8)
STATS = ("decode_steps", "prefill_chunks", "emitted", "prefix_hit_tokens",
         "cow_copies")
LENS = (5, 11, 3, 14, 8)
NEWS = (5, 4, 6, 3, 7)
SLO_OFF = dict(ttft_slo_s=1e9, tpot_slo_s=1e9)

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jc = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                 dtype="float32")
        tc = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        jp = JT.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        _MODELS[arch] = jc, tc, jp, tp
    return _MODELS[arch]


def _prompts(vocab, seed, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(eng, prompts, news, stagger=True):
    rids = []
    for p, m in zip(prompts, news):
        rids.append(eng.add_request(p, m))
        if stagger:
            eng.step()
    got = eng.drain()
    return [got[r].tolist() for r in rids]


def _port(tc, tp, **kw):
    return Engine(tc, tp, EngineConfig(**{**ENGINE_KW, **kw}), device="cpu")


def _close(a, b, tol=1e-5):
    """Within tol, the absolute part scaled by the reference's largest
    magnitude (as in test_torch_ssm.py: a state sums many unit-scale
    products, so summation order moves it by ~1e-6 of its scale)."""
    b = np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(np.asarray(a, np.float32), b,
                               atol=tol * scale, rtol=tol)


# ------------------------------------------------------------------ engines
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_reference_engine_and_generate(arch):
    jc, tc, jp, tp = _model(arch)
    prompts = _prompts(tc.vocab_size, seed=1)
    jeng = JaxEngine(jc, jp, JaxEngineConfig(**ENGINE_KW))
    teng = _port(tc, tp)
    want = _serve(jeng, prompts, NEWS)
    got = _serve(teng, prompts, NEWS)
    assert got == want
    assert ({k: teng.stats[k] for k in STATS}
            == {k: jeng.stats[k] for k in STATS})
    assert teng.block_pool.num_free == ENGINE_KW["num_blocks"]
    for p, m, o in zip(prompts, NEWS, got):
        assert TS.generate(tc, tp, p[None], m)[0].tolist() == o
    # and the port's generate equals the reference's on a batch
    batch = np.stack([p[:3] for p in prompts])
    np.testing.assert_array_equal(
        TS.generate(tc, tp, batch, 5).numpy(),
        np.asarray(JS.generate(jc, jp, jnp.asarray(batch), 5)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_caching_switches_itself_off(arch):
    _, tc, _, tp = _model(arch)
    eng = _port(tc, tp, prefix_caching=True)
    assert not eng.prefix_caching
    p = _prompts(tc.vocab_size, seed=2, lens=(12,))[0]
    outs = [_serve(eng, [p], [4])[0] for _ in range(2)]
    assert outs[0] == outs[1]
    assert eng.stats["prefix_hit_tokens"] == 0 == eng.stats["cow_copies"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slot_is_reset(arch):
    """One slot, two requests in turn: the second sees a zeroed slab, not
    the first's final state."""
    _, tc, _, tp = _model(arch)
    a, b = _prompts(tc.vocab_size, seed=3, lens=(9, 6))
    eng = _port(tc, tp, max_slots=1)
    outs = _serve(eng, [a, b], [5, 5], stagger=False)
    assert outs[1] == TS.generate(tc, tp, b[None], 5)[0].tolist()
    assert outs[0] == TS.generate(tc, tp, a[None], 5)[0].tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_ngram_spec_equals_plain(arch):
    """Repetitive prompts so the n-gram drafter's guesses are often
    accepted; the verify step's checkpoint rollback keeps the slabs exact."""
    _, tc, _, tp = _model(arch)
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(0, tc.vocab_size, size=3), 4)
               .astype(np.int32) for _ in range(3)]
    prompts += _prompts(tc.vocab_size, seed=5, lens=(7, 4))
    news = [9, 6, 8, 5, 7]
    plain = _serve(_port(tc, tp), prompts, news)
    eng = _port(tc, tp, spec=SpecConfig(k=4))
    assert _serve(eng, prompts, news) == plain
    assert eng.stats["decode_steps"] > 0
    assert eng.block_pool.num_free == ENGINE_KW["num_blocks"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_preemption_equals_no_preemption(arch):
    """Every request preempted once after its second token. rwkv6 (pure
    recurrent) resumes from its slab snapshot: the only prefill after a
    resume is the pending token. zamba2 (hybrid) re-prefills prompt +
    generated."""
    _, tc, _, tp = _model(arch)
    prompts = _prompts(tc.vocab_size, seed=6)
    news = [max(m, 4) for m in NEWS]
    outs, prefilled = {}, {}
    for forced in (False, True):
        eng = _port(tc, tp, oversub=OversubConfig(**SLO_OFF))
        assert eng._snapshot_resume == (arch == "rwkv6-7b")
        total = []
        prefill = eng._prefill

        def counted(*a, prefill=prefill, total=total):
            total.append(int(a[5].sum()))           # valids
            return prefill(*a)
        eng._prefill = counted
        rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
        pending = set(rids) if forced else set()
        while eng.scheduler.has_work:
            eng.step()
            for r in sorted(pending):
                req = eng.requests[r]
                if req.state == "decoding" and len(req.out_tokens) >= 2:
                    assert eng.preempt_request(r)
                    pending.discard(r)
        got = eng.drain()
        assert not pending and eng.stats["resumes"] == (
            len(rids) if forced else 0)
        assert eng.block_pool.num_free == ENGINE_KW["num_blocks"]
        outs[forced] = [got[r].tolist() for r in rids]
        prefilled[forced] = sum(total)
    assert outs[True] == outs[False]
    if arch == "rwkv6-7b":
        assert prefilled[True] == prefilled[False] + len(prompts)
    else:
        assert prefilled[True] > prefilled[False] + len(prompts)


# --------------------------------------------------------- device steps
def _jax_pool(jc, n_slots):
    return JT.init_paged_state(jc, ENGINE_KW["num_blocks"],
                               ENGINE_KW["block_size"], max_slots=n_slots)


def _compare_pools(tpool, jpool, N):
    for name, layer in tpool.items():
        for k, a in layer.items():
            ref = np.asarray(jpool[name][k])
            got = a.numpy()
            if k in ("k", "v"):
                got, ref = got[:, :N], ref[:, :N]       # scratch block
            _close(got, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_prefill_and_verify_match_reference(arch):
    """A packed prefill of two real segments and a padded one, then a k=3
    verify over every slot: logits, slabs, paged pools and the verify's
    checkpoints against JAX's."""
    jc, tc, jp, tp = _model(arch)
    N, S = ENGINE_KW["num_blocks"], 3
    jpool = _jax_pool(jc, S)
    tpool = TT.init_paged_state(tc, N, ENGINE_KW["block_size"], max_slots=S,
                                device="cpu")
    rng = np.random.default_rng(7)
    tables = rng.permutation(N)[:S * 10].reshape(S, 10).astype(np.int32)
    tokens = rng.integers(0, tc.vocab_size, (3, 8)).astype(np.int32)
    starts = np.zeros(3, np.int32)
    valids = np.array([5, 8, 0], np.int32)
    slots = np.array([2, 0, S], np.int32)            # the third is padding
    jl, jpool = jitted(JT.paged_prefill_packed, (0,))(
        jc, jp, jpool, *map(jnp.asarray, (tokens, tables, starts, valids,
                                          slots)))
    tl, tpool = TT.paged_prefill_packed(
        tc, tp, tpool, *map(torch.from_numpy, (tokens, tables, starts, valids,
                                               slots)))
    _close(tl[:2], np.asarray(jl)[:2])
    _compare_pools(tpool, jpool, N)
    # verify k=3 on slots 2 and 0 (slot 1 inactive)
    vt = rng.integers(0, tc.vocab_size, (S, 3)).astype(np.int32)
    base = np.array([8, 0, 5], np.int32)
    qlims = np.array([3, 0, 2], np.int32)
    jl, jaux = jitted(JT.paged_verify_step, (0,))(jc, jp, jpool, *map(
        jnp.asarray, (vt, tables, base, qlims)))
    tl, taux = TT.paged_verify_step(tc, tp, tpool, *map(
        torch.from_numpy, (vt, tables, base, qlims)))
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
    for name, kind in enumerate(SP.state_kinds(tc)):
        if kind in ("rwkv", "mamba"):
            for k, a in taux[f"l{name}"].items():
                _close(a, np.asarray(jaux[f"l{name}"][k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_select_checkpoint_matches_reference(arch):
    _, tc, _, _ = _model(arch)
    kind = SP.state_kinds(tc)[0]
    prov = SP.provider_for(kind, tc, num_blocks=1, block_size=1, max_slots=4)
    rng = np.random.default_rng(8)
    old = {k: rng.standard_normal((2, 4) + s).astype(np.float32)
           for k, (s, _) in prov._spec().items()}
    cps = {k: rng.standard_normal((2, 3, 4) + s).astype(np.float32)
           for k, (s, _) in prov._spec().items()}
    accepts = np.array([0, 1, 3, 2], np.int32)
    want = JSP.select_checkpoint({k: jnp.asarray(v) for k, v in cps.items()},
                                 jnp.asarray(accepts),
                                 {k: jnp.asarray(v) for k, v in old.items()})
    got = SP.select_checkpoint(
        {k: torch.from_numpy(v) for k, v in cps.items()},
        torch.from_numpy(accepts),
        {k: torch.from_numpy(v) for k, v in old.items()})
    for k in old:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert np.array_equal(got[next(iter(old))][:, 0].numpy(),
                          old[next(iter(old))][:, 0])       # inactive slot


def test_slab_provider_snapshot_round_trip():
    _, tc, _, _ = _model("rwkv6-7b")
    prov = SP.provider_for("rwkv", tc, num_blocks=1, block_size=1,
                           max_slots=3)
    assert prov.blocks_needed(10_000) == 0 and prov.max_tokens() is None
    assert not prov.supports_prefix_caching and prov.supports_snapshot_resume
    st = prov.init_layer_state(2, "cpu")
    for a in st.values():
        a.normal_()
    snap = prov.preempt_checkpoint(st, 1)
    before = {k: a.clone() for k, a in st.items()}
    for a in st.values():
        a[:, 1] = 0
    prov.resume_restore(st, 1, snap)
    for k in st:
        assert torch.equal(st[k], before[k])
    assert prov.state_bytes_per_slot(1) == sum(
        int(np.prod(s)) * d.itemsize for s, d in prov._spec().values())
