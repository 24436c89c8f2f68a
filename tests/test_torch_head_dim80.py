"""Head dim 80 in the port's training attention (the fault where the
flash-attention kernel took only head dims 64, 128 and 256, while the
reference computes any; stablelm-3b and zamba2-2.7b have hd 80).

On the CPU the wrapper takes the plain version, so these tests hold the
plain forward, its row log-sum-exp and the ``FlashAttention`` backward at hd
80 against the JAX Pallas flash kernel (interpret mode) and ``jax.grad`` of
its oracle; a tiny f32 dense model built with ``head_dim=80`` directly (not
through ``reduced()``, which sets 64) against the JAX model: forward, loss,
gradients and three Adam steps; and stablelm-3b's registration. The kernel
itself runs at hd 80 on the card in chip_smoke.py.

Tolerances: as tests/test_torch_flash_attention.py and
tests/test_torch_train.py — attention f32 atol 2e-5, bf16 2e-2; hidden
states 2e-5, losses 1e-5, gradients 2e-6 (float32)."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.core import parallelism as par
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import trainer as jtrainer
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path, tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

HD = 80
TOL = {np.float32: 2e-5, ml_dtypes.bfloat16: 2e-2}


def _qkv(seed, B, S, H, Hkv, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32).astype(dtype)
                 for shape in ((B, S, H, HD), (B, S, Hkv, HD),
                               (B, S, Hkv, HD)))


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_oracle(q, k, v, window=None):
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kk, vv = jnp.repeat(k, rep, 2), jnp.repeat(v, rep, 2)
    tb = lambda t: t.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    out = jax_attention_ref(tb(q), tb(kk), tb(vv), causal=True,
                            window=window)
    return out.reshape(B, H, S, hd).transpose(0, 2, 1, 3)


def test_the_kernel_takes_the_paged_kernels_head_dims():
    assert HD in HEAD_DIMS
    assert HEAD_DIMS == tuple(range(8, 257, 8))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("S,H,Hkv,window", [(128, 4, 4, None),
                                            (192, 4, 2, None),
                                            (128, 2, 1, 32)])
def test_forward_vs_pallas_and_oracle(S, H, Hkv, window, dtype):
    q, k, v = _qkv(S + H, 2, S, H, Hkv, dtype)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out = flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    assert tuple(out.shape) == q.shape
    pallas = jax_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                       block_k=64, interpret=True)
    for ref in (pallas, _jax_oracle(jq, jk, jv, window)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype],
                                   rtol=0)


def test_row_logsumexp_vs_jax():
    B, S, H, Hkv = 1, 96, 4, 2
    q, k, v = _qkv(1, B, S, H, Hkv)
    _, lse = flash_attention_ref(_t(q), _t(k), _t(v))
    kk = np.repeat(k, H // Hkv, 2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kk) * HD ** -0.5
    pos = np.arange(S)
    want = jax.nn.logsumexp(jnp.where(pos[None] <= pos[:, None], s, -1e30),
                            axis=-1)
    np.testing.assert_allclose(_f32(lse), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("window", [None, 24])
def test_backward_vs_jax_grad_of_oracle(window):
    B, S, H, Hkv = 1, 80, 4, 2
    q, k, v = _qkv(2, B, S, H, Hkv)
    dout = np.random.default_rng(3).standard_normal(
        (B, S, H, HD)).astype(np.float32)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*ts, window=window), ts,
                              _t(dout))
    want = jax.grad(lambda a, b, c: jnp.sum(_jax_oracle(a, b, c, window)
                                            * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_f32(a), np.asarray(b), atol=2e-5, rtol=0)


# a tiny dense MHA model at hd 80, stablelm-3b's attention shape cut down
CFG_KW = dict(name="hd80-t", family="dense", num_layers=2, d_model=160,
              num_heads=2, num_kv_heads=2, head_dim=HD, d_ff=320,
              vocab_size=256, dtype="float32", remat=False, loss_chunk=64,
              attn_chunk=32)


def _setup(remat=False):
    jc = JaxModelConfig(**{**CFG_KW, "remat": remat})
    tc = ModelConfig(**{**CFG_KW, "remat": remat})
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _batch(seed, B=2, S=64):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, CFG_KW["vocab_size"], (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.mark.parametrize("S", [64, 40])
def test_forward_and_loss_vs_jax(S):
    """S = 64 takes the chunked attention (attn_chunk 32), S = 40 the naive
    one, as the reference's dispatch."""
    jc, tc, jp, tp = _setup()
    jc, tc = (dataclasses.replace(c, loss_chunk=S) for c in (jc, tc))
    batch = _batch(S, S=S)
    jh, _ = JT.forward(jc, jp, {"tokens": batch["tokens"]})
    th, _ = T.forward(tc, tp, _tb(batch))
    np.testing.assert_allclose(_f32(th), _f32(jh), atol=2e-5, rtol=0)
    assert abs(float(T.loss_fn(tc, tp, _tb(batch)))
               - float(JT.loss_fn(jc, jp, batch))) <= 1e-5


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_vs_jax_value_and_grad(remat):
    jc, tc, jp, tp = _setup(remat)
    batch = _batch(1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, batch)))(jp)
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    paths, leaves = zip(*leaves_with_path(live))
    loss = T.loss_fn(tc, live, _tb(batch))
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    want = {tuple(k.key for k in p): np.asarray(v) for p, v in flat}
    assert set(want) == set(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(_f32(g), want[path], atol=2e-6, rtol=0,
                                   err_msg=str(path))


def test_three_adam_steps_vs_jax_losses():
    jc, tc, jp, tp = _setup()
    batches = [_batch(10 + i, B=4) for i in range(3)]
    jopt = jax_make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    jstep = jax.jit(jtrainer.make_train_step(
        jc, jopt, par.make_plan("dp", make_host_mesh())))
    jstate = {"params": jp, "opt": jopt.init(jp)}
    opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    tstate = {"params": tp, "opt": opt.init(tp)}
    tstep = trainer.make_train_step(tc, opt)
    for b in batches:
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, _tb(b))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5


def test_stablelm_3b_matches_the_reference_config():
    tc, jc = get_config("stablelm-3b"), jax_get_config("stablelm-3b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.resolved_head_dim == HD
    assert tc.param_count() == jc.param_count()
