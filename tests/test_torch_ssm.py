"""Port parity: ``repro_torch.models.ssm`` (RWKV6 and Mamba2 mixes) against
``repro.models.ssm`` on the same float32 inputs and weights, made from a
seed with numpy.

Tolerance: rtol = 1e-5 and atol = 1e-5 · max(1, max|ref|) on every output
and carried state. The absolute part scales with the output because a
chunk output sums up to C · K = 512 products of unit-scale inputs (outputs
reach |y| ~ 40 in the chunk tests): the two frameworks' summation orders
then differ by ~1e-6 of the output's scale (the largest found over 8 seeds
of the batched chunk test: 1.5e-6 · max|ref|). The RWKV6 chunk factorises
its pair decays through the chunk end, with factors up to e^40 at the
per-step clamp; `test_wkv_chunk_at_the_decay_clamp` shows they need no
more: each A[t, i] is one large and one small factor whose exponents
cancel, and at the clamp the error is smaller still (~1e-7 · max|ref|, the
decays cut the long sums). The token-by-token chain against the one-shot
mix (different summation orders of the same recurrence) is held to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import ssm as JS
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as S
from torch_threads import jitted, one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

RTOL = ATOL = 1e-5

RWKV_KW = dict(name="rwkv-t", family="ssm", ssm_type="rwkv6", d_model=64,
               num_heads=2, num_kv_heads=2, ssm_head_dim=32, d_ff=128,
               vocab_size=17, dtype="float32")
MAMBA_KW = dict(name="mamba-t", family="hybrid", ssm_type="mamba2",
                d_model=32, num_heads=2, num_kv_heads=2, ssm_head_dim=16,
                ssm_state_dim=8, d_ff=64, vocab_size=17, dtype="float32")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=atol * scale)


def _params(init, kw, seed=0):
    jc = JaxModelConfig(**kw)
    jp = init(jax.random.PRNGKey(seed), jc)
    return jc, ModelConfig(**kw), jp, {k: _t(v) for k, v in jp.items()}


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------------------ RWKV6
def _wkv_inputs(seed, lead, C=32, K=16, V=16, decay=(0.0, 1.25)):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal(lead + (C, K)).astype(np.float32)
    k = rng.standard_normal(lead + (C, K)).astype(np.float32)
    v = rng.standard_normal(lead + (C, V)).astype(np.float32)
    logw = -rng.uniform(*decay, size=lead + (C, K)).astype(np.float32)
    u = rng.standard_normal(lead[-1:] + (K,) if lead else (K,)
                            ).astype(np.float32) * 0.3
    S0 = rng.standard_normal(lead + (K, V)).astype(np.float32)
    return r, k, v, logw, u, S0


@pytest.mark.parametrize("C", [1, 7, 32])
def test_wkv_chunk_matches_reference(C):
    args = _wkv_inputs(0, (), C=C)
    jy, jS = JS._wkv_chunk(*map(jnp.asarray, args))
    y, S1 = S._wkv_chunk(*map(_t, args))
    _close(y, jy)
    _close(S1, jS)


def test_wkv_chunk_batched_over_batch_and_heads():
    """The port's leading dims equal the reference's vmap over (B, H)."""
    B, H = 2, 3
    r, k, v, logw, u, S0 = _wkv_inputs(1, (B, H))
    per_bh = jax.vmap(jax.vmap(JS._wkv_chunk, in_axes=(0, 0, 0, 0, 0, 0)),
                      in_axes=(0, 0, 0, 0, None, 0))
    jy, jS = per_bh(*map(jnp.asarray, (r, k, v, logw, u, S0)))
    y, S1 = S._wkv_chunk(*map(_t, (r, k, v, logw, u, S0)))
    _close(y, jy)
    _close(S1, jS)


def test_wkv_chunk_at_the_decay_clamp():
    """Every step at the clamp: factors reach e^(40 - 1.25); the same 1e-5."""
    clamp = JS._MAX_CHUNK_LOGDECAY / JS.CHUNK
    assert S._MAX_CHUNK_LOGDECAY == JS._MAX_CHUNK_LOGDECAY and S.CHUNK == 32
    args = list(_wkv_inputs(2, (2,), decay=(clamp, clamp)))
    args[3] = np.full_like(args[3], -clamp)
    jy, jS = jax.vmap(JS._wkv_chunk, in_axes=(0, 0, 0, 0, 0, 0))(
        *map(jnp.asarray, args))
    y, S1 = S._wkv_chunk(*map(_t, args))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S1).all())
    _close(y, jy)
    _close(S1, jS)


@pytest.mark.parametrize("Sq", [1, 32, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_mix_matches_reference(Sq, with_state):
    jc, tc, jp, tp = _params(JS.init_rwkv6, RWKV_KW)
    x = _x((2, Sq, 64), 3)
    state = None
    if with_state:
        state = {"S": _x((2, 2, 32, 32), 4), "prev": _x((2, 1, 64), 5)}
    jy, jst = jitted(JS.rwkv6_mix, (2,))(
        jp, jnp.asarray(x), jc, state=None if state is None
        else {k: jnp.asarray(v) for k, v in state.items()})
    y, st = S.rwkv6_mix(tp, _t(x), tc, state=None if state is None
                        else {k: _t(v) for k, v in state.items()})
    _close(y, jy)
    _close(st["S"], jst["S"])
    _close(st["prev"], jst["prev"], rtol=0, atol=0)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_channel_mix_matches_reference(with_state):
    jc, tc, jp, tp = _params(JS.init_rwkv6, RWKV_KW, seed=1)
    x = _x((2, 5, 64), 6)
    prev = _x((2, 1, 64), 7) if with_state else None
    jy, jprev = jitted(JS.rwkv6_channel_mix, (2,))(
        jp, jnp.asarray(x), jc, None if prev is None else jnp.asarray(prev))
    y, tprev = S.rwkv6_channel_mix(tp, _t(x), tc,
                                   None if prev is None else _t(prev))
    _close(y, jy)
    _close(tprev, jprev, rtol=0, atol=0)


def test_rwkv6_bf16_keeps_the_reference_dtypes():
    """bf16 config: output and carries in bf16, S in f32, as the reference."""
    kw = dict(RWKV_KW, dtype="bfloat16")
    jc, tc = JaxModelConfig(**kw), ModelConfig(**kw)
    jp = JS.init_rwkv6(jax.random.PRNGKey(0), jc)
    tp = {k: _t(v).to(
        torch.bfloat16 if np.asarray(v).dtype.name == "bfloat16"
        else torch.float32) for k, v in jp.items()}
    x = _x((1, 32, 64), 8)
    jy, jst = jitted(JS.rwkv6_mix, (2,))(jp, jnp.asarray(x, jnp.bfloat16), jc)
    y, st = S.rwkv6_mix(tp, _t(x).to(torch.bfloat16), tc)
    assert y.dtype == torch.bfloat16 and st["prev"].dtype == torch.bfloat16
    assert st["S"].dtype == torch.float32
    spec = S.rwkv6_state_spec(tc)
    assert {k: (s, d) for k, (s, d) in spec.items()} == {
        "S": ((2, 32, 32), torch.float32),
        "prev": ((1, 64), torch.bfloat16),
        "prev_cm": ((1, 64), torch.bfloat16)}
    _close(st["S"], jst["S"], rtol=2e-2, atol=2e-2)
    _close(y, jy, rtol=5e-2, atol=5e-2)


# ----------------------------------------------------------------- Mamba2
@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_reference(with_prev):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 10)).astype(np.float32)
    jout, jcarry = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(prev) if with_prev else None)
    out, carry = S._causal_conv(_t(x), _t(w), _t(prev) if with_prev else None)
    _close(out, jout)
    _close(carry, jcarry)


@pytest.mark.parametrize("C", [1, 9, 32])
def test_ssd_chunk_matches_reference(C):
    rng = np.random.default_rng(10)
    hd, ds = 16, 8
    xh = rng.standard_normal((C, hd)).astype(np.float32)
    Bm = rng.standard_normal((C, ds)).astype(np.float32)
    Cm = rng.standard_normal((C, ds)).astype(np.float32)
    dtv = rng.uniform(0.01, 1.0, size=C).astype(np.float32)
    la = np.cumsum(-dtv * rng.uniform(1, 16), dtype=np.float32)
    S0 = rng.standard_normal((hd, ds)).astype(np.float32)
    args = (xh, Bm, Cm, la, dtv, S0)
    jy, jS = JS._ssd_chunk(*map(jnp.asarray, args))
    y, S1 = S._ssd_chunk(*map(_t, args))
    _close(y, jy)
    _close(S1, jS)


@pytest.mark.parametrize("Sq", [1, 32, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_mix_matches_reference(Sq, with_state):
    jc, tc, jp, tp = _params(JS.init_mamba2, MAMBA_KW)
    x = _x((2, Sq, 32), 11)
    H, conv_dim = 64 // 16, 64 + 16
    state = None
    if with_state:
        state = {"S": _x((2, H, 16, 8), 12), "conv": _x((2, 3, conv_dim), 13)}
    jy, jst = jitted(JS.mamba2_mix, (2,))(
        jp, jnp.asarray(x), jc, state=None if state is None
        else {k: jnp.asarray(v) for k, v in state.items()})
    y, st = S.mamba2_mix(tp, _t(x), tc, state=None if state is None
                         else {k: _t(v) for k, v in state.items()})
    _close(y, jy)
    _close(st["S"], jst["S"])
    _close(st["conv"], jst["conv"])


def test_state_specs_and_zero_states():
    tc = ModelConfig(**MAMBA_KW)
    st = S.init_mamba2_state(tc, 3, device="cpu")
    assert st["S"].shape == (3, 4, 16, 8) and st["conv"].shape == (3, 3, 80)
    assert all(not bool(a.any()) for a in st.values())
    jst = JS.init_mamba2_state(JaxModelConfig(**MAMBA_KW), 3)
    assert {k: tuple(a.shape) for k, a in st.items()} == {
        k: tuple(a.shape) for k, a in jst.items()}
    rc = ModelConfig(**RWKV_KW)
    rst = S.init_rwkv6_state(rc, 2, device="cpu")
    assert {k: tuple(a.shape) for k, a in rst.items()} == {
        k: tuple(a.shape) for k, a in JS.init_rwkv6_state(
            JaxModelConfig(**RWKV_KW), 2).items()}


# ------------------------------------------- token chain == one-shot mix
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_decode_chain_equals_one_shot_mix(kind):
    """32 one-token calls carrying the state == one 32-token mix."""
    if kind == "rwkv":
        _, tc, _, tp = _params(JS.init_rwkv6, RWKV_KW)
        mix, D = S.rwkv6_mix, 64
        st = {k: v for k, v in S.init_rwkv6_state(tc, 2, "cpu").items()
              if k != "prev_cm"}
    else:
        _, tc, _, tp = _params(JS.init_mamba2, MAMBA_KW)
        mix, D = S.mamba2_mix, 32
        st = S.init_mamba2_state(tc, 2, "cpu")
    x = _t(_x((2, 32, D), 14))
    y_full, st_full = mix(tp, x, tc)
    ys = []
    for i in range(32):
        yi, st = mix(tp, x[:, i:i + 1], tc, state=st)
        ys.append(yi)
    _close(torch.cat(ys, dim=1), y_full.numpy(), rtol=1e-4, atol=1e-4)
    _close(st["S"], st_full["S"].numpy(), rtol=1e-4, atol=1e-4)
