"""Port parity: ``repro_torch.serving.serve`` (the dense-cache reference
generator, its sampler) and the engine's temperature sampling and
draft-model drafter, against ``repro.serving.serve`` on the CPU with
converted weights.

Logits of ``prefill_step`` / ``decode_step`` within 1e-4 of JAX's (f32);
generated tokens EQUAL. Sampling: ``sample_with_noise`` fed JAX's Gumbel
noise gives ``jax.random.categorical``'s tokens, and 20,000 draws of the
port's sampler pass a chi-square test against softmax(l / T) at the
0.999 quantile of its distribution.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.kernels.quantize import KVQuantConfig as JaxKVQuantConfig
from repro.models import transformer as JT
from repro.serving import serve as JS
from repro.serving.engine.spec import DraftModelDrafter as JaxDraftModelDrafter
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.quantize import KVQuantConfig
from repro_torch.models import transformer as TT
from repro_torch.serving import serve as TS
from repro_torch.serving.engine import (DraftModelDrafter, Engine,
                                        EngineConfig, OversubConfig,
                                        SpecConfig)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

LOGIT_TOL = 1e-4
SMALL = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=50,
             loss_chunk=16, attn_chunk=16, remat=False, dtype="float32")
ENGINE_KW = dict(block_size=4, num_blocks=64, max_blocks_per_seq=10,
                 max_slots=3, prefill_chunk=8)
# the 0.999 quantile of the chi-square distribution with 7 degrees of
# freedom (8 categories): a correct sampler fails with probability 1e-3;
# the draws are seeded, so the test is deterministic
CHI2_7_999 = 24.322


def _configs(name):
    if name == "sliding":
        kw = dict(SMALL, name="sliding-t", attention_type="sliding",
                  window_size=8)
        return JaxModelConfig(**kw), ModelConfig(**kw)
    return (dataclasses.replace(jax_reduced(jax_get_config(name)),
                                dtype="float32"),
            dataclasses.replace(reduced(get_config(name)), dtype="float32"))


_MODELS = {}


def _model(name):
    """(jax cfg, port cfg, jax params, port params), built once per name."""
    if name not in _MODELS:
        jc, tc = _configs(name)
        jp = JT.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        _MODELS[name] = jc, tc, jp, tp
    return _MODELS[name]


def _prompts(n, vocab, seed, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(s)).astype(np.int32)
            for s in rng.integers(lo, hi, size=n)]


ARCHS = ["yi-9b", "sliding", "gemma3-12b"]


# ----------------------------------------------------- prefill / decode steps
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """Batched prefill over a 12-token prompt (the sliding ring of 8 wraps),
    then 4 decode steps: every step's logits within 1e-4 of JAX's."""
    jc, tc, jp, tp = _model(arch)
    B, S0, steps = 2, 12, 4
    prompt = np.random.default_rng(1).integers(
        0, tc.vocab_size, (B, S0)).astype(np.int32)
    jst = JT.init_decode_state(jc, B, S0 + steps)
    tst = TT.init_decode_state(tc, B, S0 + steps, device="cpu")
    jprefill = jax.jit(lambda p, st, t: JT.prefill_step(jc, p, st,
                                                        {"tokens": t}))
    jdecode = jax.jit(lambda p, st, t, i: JT.decode_step(jc, p, st,
                                                         {"token": t}, i))
    jl, jst = jprefill(jp, jst, jnp.asarray(prompt))
    tl, tst = TT.prefill_step(tc, tp, tst,
                              {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for j in range(steps):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jst = jdecode(jp, jst, jnp.asarray(tok), jnp.int32(S0 + j))
        tl, tst = TT.decode_step(tc, tp, tst,
                                 {"token": torch.from_numpy(tok)}, S0 + j)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
    # the caches hold the same K/V (leaf for leaf, (n_sb, B, size, ...))
    for name, layer in tst.items():
        for k, a in layer.items():
            np.testing.assert_allclose(a.numpy(), np.asarray(jst[name][k]),
                                       atol=1e-5, rtol=0)


def test_decode_state_layout_and_ring():
    jc, tc, _, _ = _model("gemma3-12b")
    st = TT.init_decode_state(tc, 3, 100, device="cpu")
    jst = JT.init_decode_state(jc, 3, 100)
    assert {n: {k: tuple(a.shape) for k, a in l.items()}
            for n, l in st.items()} == {
        n: {k: tuple(a.shape) for k, a in l.items()} for n, l in jst.items()}
    assert st["l0"]["k"].shape[2] == tc.window_size      # local: the ring
    q = TT.init_decode_state(tc, 1, 10, kv_quant=KVQuantConfig(),
                             device="cpu")
    assert q["l1"]["k"].dtype == torch.int8
    assert bool((q["l1"]["k_scale"] == 1).all())
    with pytest.raises(NotImplementedError, match="batched prefill"):
        TT.prefill_step(reduced(get_config("rwkv6-7b")), {}, {},
                        {"tokens": None})


# ------------------------------------------------------------------ generate
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,quant", [("batched", False), ("loop", False),
                                        ("batched", True)])
def test_generate_tokens_equal_reference(arch, mode, quant):
    jc, tc, jp, tp = _model(arch)
    prompt = np.random.default_rng(2).integers(
        0, tc.vocab_size, (2, 10)).astype(np.int32)
    jq, tq = (JaxKVQuantConfig(), KVQuantConfig()) if quant else (None, None)
    want = np.asarray(JS.generate(jc, jp, jnp.asarray(prompt), 8,
                                  prefill_mode=mode, kv_quant=jq))
    got = TS.generate(tc, tp, prompt, 8, prefill_mode=mode, kv_quant=tq)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_prefill_equals_loop(arch):
    _, tc, _, tp = _model(arch)
    prompt = np.random.default_rng(3).integers(
        0, tc.vocab_size, (3, 13)).astype(np.int32)
    a = TS.generate(tc, tp, prompt, 6, prefill_mode="batched")
    b = TS.generate(tc, tp, prompt, 6, prefill_mode="loop")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TS.generate(tc, tp, prompt, 2, prefill_mode="chunked")


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-12b"])
def test_engine_generate_equals_generate(arch):
    _, tc, _, tp = _model(arch)
    prompts = _prompts(4, tc.vocab_size, seed=4)
    news = [5, 3, 7, 4]
    outs, eng = TS.engine_generate(tc, tp, prompts, news,
                                   engine_cfg=EngineConfig(**ENGINE_KW),
                                   device="cpu", return_engine=True)
    assert isinstance(eng, Engine)
    for p, m, o in zip(prompts, news, outs):
        np.testing.assert_array_equal(
            o, TS.generate(tc, tp, p[None], m)[0].numpy())


def test_serve_step_and_plan_refusals():
    _, tc, _, tp = _model("yi-9b")
    step = TS.make_serve_step(tc)
    st = TT.init_decode_state(tc, 1, 4, device="cpu")
    lg, _ = step(tp, st, {"token": torch.tensor([3], dtype=torch.int32)}, 0)
    st2 = TT.init_decode_state(tc, 1, 4, device="cpu")
    lg2, _ = TT.decode_step(tc, tp, st2, {"token": torch.tensor([3])}, 0)
    assert torch.equal(lg, lg2)
    with pytest.raises(NotImplementedError, match="A15"):
        TS.make_serve_step(tc, plan=object())
    with pytest.raises(NotImplementedError, match="A15"):
        TS.jit_serve_step(tc, None, None, None, None)


# ------------------------------------------------------------------- sampling
@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0, 2.0])
def test_sample_with_noise_equals_jax_categorical(temperature):
    """Fed JAX's Gumbel noise, the port's sampler picks
    jax.random.categorical's tokens (Gumbel-max is categorical's form)."""
    rng = np.random.default_rng(5)
    for seed in range(6):
        logits = (rng.standard_normal((5, 64)) * 3).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        noise = np.array(jax.random.gumbel(key, logits.shape))
        want = np.asarray(jax.random.categorical(
            key, jnp.asarray(logits) / temperature, axis=-1))
        got = TS.sample_with_noise(torch.from_numpy(logits),
                                   torch.from_numpy(noise), temperature)
        np.testing.assert_array_equal(got.numpy(), want)
    greedy = TS.sample_with_noise(torch.from_numpy(logits), None, 0.0)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_sampler_frequencies_match_softmax():
    """20,000 draws from one seeded generator: the chi-square statistic of
    the token counts against softmax(l / T) stays under the 0.999
    quantile (7 degrees of freedom)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2])
    T, n = 0.8, 20_000
    gen = torch.Generator().manual_seed(0)
    toks = TS.sample(logits.expand(n, -1), gen, T)
    counts = np.bincount(toks.numpy(), minlength=8)
    expected = torch.softmax(logits / T, dim=-1).double().numpy() * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_7_999, (chi2, counts, expected)


def test_generate_with_temperature_is_seeded():
    _, tc, _, tp = _model("yi-9b")
    prompt = np.arange(6, dtype=np.int32)[None]
    a = TS.generate(tc, tp, prompt, 10, temperature=0.8)
    b = TS.generate(tc, tp, prompt, 10, temperature=0.8,
                    generator=torch.Generator().manual_seed(0))
    c = TS.generate(tc, tp, prompt, 10, temperature=0.8,
                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _oversub_engine(tc, tp, **kw):
    return Engine(tc, tp, EngineConfig(**ENGINE_KW, oversub=OversubConfig(
        ttft_slo_s=1e9, tpot_slo_s=1e9), **kw), device="cpu")


def test_engine_temperature_equals_generate():
    """One sampled request through the engine draws the same noise as
    generate with the same seed: the tokens are equal."""
    _, tc, _, tp = _model("yi-9b")
    prompt = _prompts(1, tc.vocab_size, seed=6)[0]
    eng = Engine(tc, tp, EngineConfig(**ENGINE_KW), device="cpu")
    rid = eng.add_request(prompt, 10, temperature=0.8,
                          generator=torch.Generator().manual_seed(42))
    got = eng.drain()[rid]
    want = TS.generate(tc, tp, prompt[None], 10, temperature=0.8,
                       generator=torch.Generator().manual_seed(42))[0]
    np.testing.assert_array_equal(got, want.numpy())


def test_temperature_sampling_exact_across_preemption():
    """The generator rides on the host request, so its draws — and every
    sampled token — are identical with and without eviction (the
    reference's tests/test_oversub.py:466)."""
    _, tc, _, tp = _model("yi-9b")
    prompt = _prompts(1, tc.vocab_size, seed=13)[0]
    outs = {}
    for forced in (False, True):
        eng = _oversub_engine(tc, tp)
        rid = eng.add_request(prompt, 10, temperature=0.8,
                              generator=torch.Generator().manual_seed(42))
        if forced:
            while eng.requests[rid].state != "decoding":
                eng.step()
            for _ in range(3):
                eng.step()
            assert eng.preempt_request(rid)
        outs[forced] = eng.drain()[rid]
        assert eng.stats["resumes"] == int(forced)
    np.testing.assert_array_equal(outs[False], outs[True])


def test_temperature_requests_run_unspeculated():
    """temperature > 0 runs with qlims == 1 under speculation (the host
    samples the one token); it completes its budget with the tokens of the
    engine without speculation, and greedy neighbours still speculate (the
    reference's tests/test_spec_decode.py:505)."""
    _, tc, _, tp = _model("yi-9b")
    prompts = _prompts(2, tc.vocab_size, seed=9)
    outs = {}
    for spec in (None, SpecConfig(k=4)):
        eng = Engine(tc, tp, EngineConfig(**ENGINE_KW, spec=spec),
                     device="cpu")
        hot = eng.add_request(prompts[0], 8, temperature=0.8,
                              generator=torch.Generator().manual_seed(3))
        cold = eng.add_request(prompts[1], 8)
        got = eng.drain()
        outs[spec is None] = got[hot], got[cold]
        if spec is not None:
            assert eng.stats["decode_steps"] >= 7     # hot: 1 token a step
    assert len(outs[False][0]) == 8
    np.testing.assert_array_equal(outs[False][0], outs[True][0])
    np.testing.assert_array_equal(outs[False][1], outs[True][1])


# ----------------------------------------------------- draft-model drafter
def _draft_model():
    # the target (reduced yi-9b) shares only its vocab with the draft
    kw = dict(SMALL, name="draft-t", num_layers=1, d_model=32, d_ff=64,
              num_heads=2, num_kv_heads=1, head_dim=16, vocab_size=512)
    jc, tc = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = JT.init_params(jc, jax.random.PRNGKey(1))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")


def test_draft_model_propose_equals_reference():
    jc, tc, jp, tp = _draft_model()
    jd, td = JaxDraftModelDrafter(jc, jp), DraftModelDrafter(tc, tp)
    for seed, n in ((0, 3), (1, 1), (2, 5)):
        ctx = _prompts(1, 50, seed=seed, lo=4, hi=20)[0]
        got = td.propose(7, ctx, n)
        assert got.dtype == np.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got, np.asarray(jd.propose(7, ctx, n)))
    td.forget(7)


def test_spec_with_draft_model_equals_plain():
    _, tc, _, tp = _model("yi-9b")
    _, dc, _, dp = _draft_model()
    prompts = _prompts(3, tc.vocab_size, seed=10)
    news = [6, 9, 4]
    outs = {}
    for spec in (None, SpecConfig(k=3, drafter=DraftModelDrafter(dc, dp))):
        eng = Engine(tc, tp, EngineConfig(**ENGINE_KW, spec=spec),
                     device="cpu")
        rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
        got = eng.drain()
        outs[spec is None] = [got[r].tolist() for r in rids]
        assert eng.block_pool.num_free == ENGINE_KW["num_blocks"]
    assert outs[False] == outs[True]
