"""The numerics of the tensor-core (bf16) kernels B6 and B7, replayed on
the CPU: a tolerance argument for the kernels, not a test of them.

The bf16 kernels run only on the card (chip_smoke.py holds them against
their plain versions there). What sets their tolerance is arithmetic that
the CPU can replay: B6 (``flash_attention.cu``, ``flash_fwd_bf16``) forms
f32 scores from bf16 q and k (products of bf16 values are exact in f32),
runs the online softmax in f32 over 32-key tiles that start at each 64-row
query tile's first admitted key, with masked keys at p = 0, rounds P to
bf16 before P·V and accumulates in f32, with l summed from the f32 p; B7
(``matmul.cu``, ``matmul_bf16_kernel``) sums exact bf16 products in f32, 16
at a time per mma step. The replays below do the same, except that B6's
``ex2.approx`` (relative error near 2^-22) is an exact exp2 here and the
order of sums inside one mma step is not the hardware's. They must stay
within the smoke's tolerances of the port's plain versions and of the JAX
functions: B6 within 2e-2 with its row log-sum-exp within 1e-4, B7 within
2e-2·max|ref| in bf16 and the smoke's f32 rule min(2e-6·K, 1e-5·max|ref|).
The bf16 kernel's width table is read from the CUDA source, the one place
it lives, and held against the configs' head dims and ``HEAD_DIMS``."""
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul_ref as jax_matmul_ref
from repro.models.attention import _attend_full
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, SOURCE
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask
from repro_torch.kernels.matmul import matmul_ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

QUERY_TILE = 64        # the bf16 kernel's query rows per block (kTcBQ)
KEY_TILE = 32          # the bf16 kernel's keys per K/V tile (kTcBK)
MMA_K = 16             # the depth of one mma.sync.m16n8k16 step
LOG2E = 1.4426950408889634


def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32).astype(
        ml_dtypes.bfloat16)


def _t(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def emulate_flash_bf16(q, k, v, *, causal, window):
    """B6's bf16 arithmetic on (B, S, H, hd) bf16 tensors: returns (out
    bf16, lse (B, H, S) f32)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    scale = hd ** -0.5
    c = scale * LOG2E
    qf = q.float().permute(0, 2, 1, 3)                            # B H S hd
    kf = k.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    mask = attention_mask(S, causal, window, q.device)
    out = torch.zeros((B, H, S, hd))
    lse = torch.zeros((B, H, S))
    for q0 in range(0, S, QUERY_TILE):
        qs = slice(q0, min(S, q0 + QUERY_TILE))
        # the keys the query tile needs: the window's reach to the diagonal
        k_begin = max(0, q0 - window + 1) if window else 0
        k_end = qs.stop if causal else S
        m = torch.full((B, H, qs.stop - q0), NEG_INF)
        l = torch.zeros((B, H, qs.stop - q0))
        acc = torch.zeros((B, H, qs.stop - q0, hd))
        for k0 in range(k_begin, k_end, KEY_TILE):
            ks = slice(k0, min(S, k0 + KEY_TILE))
            s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)   # exact, f32
            ok = mask[qs, ks]
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2((m - m_new) * c)
            p = torch.where(ok, torch.exp2(s * c - (m_new * c)[..., None]),
                            0.0)
            l = l * corr + p.sum(-1)
            pv = p.to(torch.bfloat16).float() @ vf[:, :, ks]    # P rounded
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, qs] = acc / torch.clamp(l, min=1e-30)[..., None]
        lse[:, :, qs] = m * scale + torch.log(l)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16), lse


@pytest.mark.parametrize("window", [None, 32, 1024])
@pytest.mark.parametrize("hd", [64, 80, 128])
def test_flash_bf16_emulation_within_tolerance(hd, window):
    S = 1100 if window == 1024 else 200        # the window must bind
    B, H, Hkv = 1, 4, 2
    rng = np.random.default_rng(hd + (window or 0))
    q, k, v = (_bf16(rng, (B, S, n, hd)) for n in (H, Hkv, Hkv))
    out, lse = emulate_flash_bf16(_t(q), _t(k), _t(v), causal=True,
                                  window=window)
    ref, ref_lse = flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                       window=window)
    jax_out = _attend_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           H // Hkv, hd ** -0.5, S, window)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == q.shape
    err = (out.float() - ref.float()).abs().max().item()
    jax_err = np.abs(out.float().numpy()
                     - np.asarray(jax_out, np.float32)).max()
    lse_err = (lse - ref_lse).abs().max().item()
    assert err <= 2e-2, err
    assert jax_err <= 2e-2, jax_err
    assert lse_err <= 1e-4, lse_err


def test_flash_bf16_emulation_rounds_p():
    """The emulation is not the plain version: P's rounding to bf16 moves
    the f32 output before its own rounding."""
    rng = np.random.default_rng(0)
    q, k, v = (_t(_bf16(rng, (1, 96, 2, 64))) for _ in range(3))
    p = torch.softmax((q.float()[0, :, 0] @ k.float()[0, :, 0].T)
                      * 64 ** -0.5 + torch.triu(torch.full((96, 96), NEG_INF),
                                                1), -1)
    assert (p.to(torch.bfloat16).float() != p).any()
    out, _ = emulate_flash_bf16(q, k, v, causal=True, window=None)
    ref, _ = flash_attention_ref(q, k, v, causal=True, window=None)
    assert (out != ref).any()


def _source_widths():
    text = SOURCE.read_text()
    m = re.search(r"constexpr int kTcWidths\[\] = \{([^}]*)\};", text)
    assert m, "kTcWidths not found in flash_attention.cu"
    assert "kTcWidths[I]" in text       # the dispatch walks this table
    return tuple(int(x) for x in m.group(1).split(","))


def test_width_table_matches_source():
    """The source instantiates the bf16 kernel at the configs' head dims
    (the registered architectures and their reduced variants) and at no
    other width."""
    widths = _source_widths()
    cfgs = [get_config(n) for n in list_configs()]
    config_dims = {c.resolved_head_dim for c in cfgs + [reduced(c)
                                                        for c in cfgs]}
    assert set(widths) == config_dims == {64, 80, 128, 256}
    assert list(widths) == sorted(set(widths))
    assert all(w % MMA_K == 0 for w in widths)
    assert widths[-1] == HEAD_DIMS[-1]


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_every_head_dim_has_a_width(hd):
    width = next(w for w in _source_widths() if w >= hd)
    assert width >= hd and width % MMA_K == 0
    if hd in (64, 80, 128, 256):
        assert width == hd


def emulate_matmul_bf16(a, b, out_dtype):
    """B7's bf16 arithmetic: exact products, each 16-deep mma step summed
    into the f32 accumulator in k order; cast once to `out_dtype`."""
    K = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    a64, b64 = a.double(), b.double()
    for k0 in range(0, K, MMA_K):
        step = a64[:, k0:k0 + MMA_K] @ b64[k0:k0 + MMA_K]    # exact
        acc = acc + step.float()
    return acc.to(out_dtype)


# the smoke's ragged shapes: (M, K, N); K or N not a multiple of 8 takes the
# kernel's masked scalar loader, N = 200 a partial 64-wide tile
MATMUL_RAGGED = [(1000, 577, 65), (1, 9, 1), (130, 17, 70), (7, 33, 129),
                 (513, 576, 65), (300, 577, 200), (1000, 576, 200)]


@pytest.mark.parametrize("out_dtype", [ml_dtypes.bfloat16, np.float32])
@pytest.mark.parametrize("M,K,N", MATMUL_RAGGED)
def test_matmul_bf16_emulation_within_tolerance(M, K, N, out_dtype):
    rng = np.random.default_rng(M + K + N)
    a, b = _bf16(rng, (M, K)), _bf16(rng, (K, N))
    t_out = (torch.bfloat16 if out_dtype == ml_dtypes.bfloat16
             else torch.float32)
    got = emulate_matmul_bf16(_t(a), _t(b), t_out).float().numpy()
    jax_ref = np.asarray(jax_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                        out_dtype), np.float32)
    port_ref = matmul_ref(_t(a), _t(b), t_out).float().numpy()
    scale = np.abs(jax_ref).max()
    tol = (2e-2 * scale if out_dtype == ml_dtypes.bfloat16
           else min(2e-6 * K, 1e-5 * scale))
    assert np.abs(got - jax_ref).max() <= tol
    assert np.abs(got - port_ref).max() <= tol
