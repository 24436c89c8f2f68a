"""Port parity: the port's flash attention (``repro_torch.kernels.
flash_attention``) against the JAX package's Pallas kernel (interpret mode,
as tests/test_kernels.py runs it) and its pure-jnp oracle, on the same numpy
inputs; and the port's backward (the ``FlashAttention`` autograd.Function,
run on CPU tensors over the plain forward and its row log-sum-exp) against
autograd through the plain version and ``jax.grad`` of the oracle.

Tolerances: float32 atol 2e-5 (the reference's own kernel-vs-model
tolerance, tests/test_kernels.py:72); bfloat16 2e-2 (each side rounds its
f32 result to bf16 once; one bf16 step near 2 is 2**-7). Gradients: f32
atol 2e-5; bf16 2e-2 x max(1, max |g|) (each gradient rounds to bf16 once on
each side). On CPU tensors the wrapper takes the plain version and leaves
the kernel's launch counter at 0; the CUDA kernel is held against the plain
version on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as JA
from repro_torch import kernels
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     attention_backward)
from repro_torch.models import attention as A
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

# tests/test_kernels.py:40's sweep: (S, H, Hkv, hd)
SWEEP = [(128, 4, 4, 64), (256, 4, 2, 64), (256, 8, 1, 128), (512, 2, 2, 64)]
TOL = {np.float32: 2e-5, ml_dtypes.bfloat16: 2e-2}


def _qkv(seed, B, S, H, Hkv, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32).astype(dtype)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32).astype(dtype)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32).astype(dtype)
    return q, k, v


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_oracle(q, k, v, causal=True, window=None):
    """JAX attention_ref on (B, S, H, hd) with K/V repeated per head."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kk, vv = jnp.repeat(k, rep, 2), jnp.repeat(v, rep, 2)
    tb = lambda t: t.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    out = jax_attention_ref(tb(q), tb(kk), tb(vv), causal=causal,
                            window=window)
    return out.reshape(B, H, S, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("S,H,Hkv,hd", SWEEP)
def test_causal_sweep_vs_pallas_and_oracle(S, H, Hkv, hd, dtype):
    q, k, v = _qkv(S + hd, 2, S, H, Hkv, hd, dtype)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    before = dict(kernels.launch_counts)
    out = flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert kernels.launch_counts == before
    assert out.dtype == _t(q).dtype and tuple(out.shape) == q.shape
    pallas = jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                       interpret=True)
    for ref in (pallas, _jax_oracle(jq, jk, jv)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype],
                                   rtol=0)


@pytest.mark.parametrize("window", [32, 128])
def test_sliding_window_vs_pallas_and_oracle(window):
    q, k, v = _qkv(window, 1, 256, 2, 2, 64)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out = flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    pallas = jax_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                       block_k=64, interpret=True)
    for ref in (pallas, _jax_oracle(jq, jk, jv, window=window)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("S,causal,window", [
    (64, True, None), (100, True, 16), (77, False, None), (90, False, 30)])
def test_plain_attention_ref_vs_jax_oracle(S, causal, window):
    """The plain version on (BH, S, hd) at lengths no tile divides."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((3, S, 32)).astype(np.float32)
               for _ in range(3))
    out = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window)
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5, rtol=0)


def test_row_logsumexp_vs_jax():
    B, S, H, Hkv, hd, window = 2, 96, 4, 2, 32, 40
    q, k, v = _qkv(3, B, S, H, Hkv, hd)
    _, lse = flash_attention_ref(_t(q), _t(k), _t(v), window=window)
    kk = np.repeat(k, H // Hkv, 2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
    pos = np.arange(S)
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
    want = jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1)
    np.testing.assert_allclose(_f32(lse), np.asarray(want), atol=2e-5, rtol=0)


def test_matches_model_chunked_attention_semantics():
    """The port's flash attention, the JAX model's chunked path and the
    port's chunked path agree (tests/test_kernels.py:72)."""
    q, k, v = _qkv(9, 1, 128, 2, 2, 64)
    out = flash_attention(_t(q), _t(k), _t(v), causal=True)
    jax_model = JA._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), n_rep=1,
                                      scale=64 ** -0.5, chunk=32, window=None)
    port_model = A._chunked_attention(_t(q), _t(k), _t(v), n_rep=1,
                                      scale=64 ** -0.5, chunk=32, window=None)
    np.testing.assert_allclose(_f32(out), _f32(jax_model), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_f32(port_model), _f32(jax_model), atol=2e-5,
                               rtol=0)


GRAD_CASES = [  # (B, S, H, Hkv, hd, causal, window)
    (2, 64, 4, 4, 32, True, None),
    (1, 100, 8, 2, 16, True, None),      # GQA 4, ragged
    (2, 130, 8, 1, 32, True, 32),        # GQA 8, window
    (1, 96, 4, 2, 16, False, None),
    (1, 77, 4, 2, 16, False, 20),
]


def _grads(fn, q, k, v, dout):
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, dout)


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", GRAD_CASES)
def test_backward_vs_autograd_through_plain(B, S, H, Hkv, hd, causal, window):
    q, k, v = (_t(a) for a in _qkv(S + H, B, S, H, Hkv, hd))
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, H, hd)).astype(np.float32))
    got = _grads(lambda *t: flash_attention(*t, causal=causal, window=window),
                 q, k, v, dout)
    want = _grads(lambda *t: flash_attention_ref(*t, causal=causal,
                                                 window=window)[0],
                  q, k, v, dout)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-5, rtol=0)


@pytest.mark.parametrize("chunk", [16, 40])
def test_backward_chunking_is_exact_in_the_math(chunk):
    """Chunks smaller than S (and not dividing it) give the gradients of
    one whole-sequence chunk."""
    B, S, H, Hkv, hd, window = 1, 100, 4, 2, 16, 24
    q, k, v = (_t(a) for a in _qkv(5, B, S, H, Hkv, hd))
    out, lse = flash_attention_ref(q, k, v, window=window)
    dout = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, S, H, hd)).astype(np.float32))
    kw = dict(scale=hd ** -0.5, causal=True, window=window)
    whole = attention_backward(q, k, v, out, lse, dout, chunk=S, **kw)
    split = attention_backward(q, k, v, out, lse, dout, chunk=chunk, **kw)
    for a, b in zip(split, whole):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-5, rtol=0)


def test_backward_bf16_vs_autograd_through_plain():
    B, S, H, Hkv, hd = 1, 128, 8, 2, 32
    q, k, v = (_t(a) for a in _qkv(11, B, S, H, Hkv, hd, ml_dtypes.bfloat16))
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, H, hd)).astype(np.float32)).to(torch.bfloat16)
    got = _grads(lambda *t: FlashAttention.apply(*t, hd ** -0.5, True, None),
                 q, k, v, dout)
    want = _grads(lambda *t: flash_attention_ref(*t)[0], q, k, v, dout)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        tol = 2e-2 * max(1.0, float(b.float().abs().max()))
        np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=0)


@pytest.mark.parametrize("window", [None, 24])
def test_backward_vs_jax_grad_of_oracle(window):
    B, S, H, Hkv, hd = 1, 80, 4, 1, 32
    q, k, v = _qkv(17, B, S, H, Hkv, hd)
    dout = np.random.default_rng(4).standard_normal(
        (B, S, H, hd)).astype(np.float32)
    got = _grads(lambda *t: flash_attention(*t, window=window),
                 _t(q), _t(k), _t(v), _t(dout))
    jg = jax.grad(lambda a, b, c: jnp.sum(_jax_oracle(a, b, c, window=window)
                                          * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(got, jg):
        np.testing.assert_allclose(_f32(a), np.asarray(b), atol=2e-5, rtol=0)


@pytest.mark.parametrize("bad", ["shape", "heads", "dtype", "window", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 4, 16)
    k = v = torch.zeros(1, 8, 2, 16)
    kw = {}
    if bad == "shape":
        k = v = torch.zeros(1, 8, 2, 32)
    elif bad == "heads":
        k = v = torch.zeros(1, 8, 3, 16)
    elif bad == "dtype":
        k = v = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    elif bad == "window":
        kw = dict(window=0)
    else:
        q = torch.zeros(8, 4, 16)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, **kw)
