"""Port parity: the port's plain paged decode attention
(``repro_torch.kernels.paged_attention.ref``) against the JAX package's
Pallas kernel (interpret mode, as tests/test_paged_attention.py runs it) and
its pure-jnp oracle, on the same numpy inputs. float32 at atol 2e-5 (the
reference's own kernel-vs-oracle tolerance); bfloat16 at 2e-2 (the outputs
round to bf16 once on each side, one bf16 step near 1 is 2**-8).

On CPU tensors ``ops.paged_attention`` must take the plain version and
leave the kernel's launch counter at 0; the CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_kernel
from repro.kernels.paged_attention import paged_attention_ref as jax_ref
from repro_torch import kernels
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_ref)

pytestmark = pytest.mark.port

SWEEP = [(4, 4, 32), (4, 2, 64), (8, 1, 32), (8, 2, 16)]


def _case(seed, B, H, Hkv, hd, N, bs, P, lens, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(dtype)
    kp = rng.standard_normal((N, bs, Hkv, hd)).astype(dtype)
    vp = rng.standard_normal((N, bs, Hkv, hd)).astype(dtype)
    tables = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _to_torch(arrs):
    out = []
    for a in arrs:
        if a.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
        else:
            out.append(torch.from_numpy(a.copy()))
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("H,Hkv,hd", SWEEP)
def test_ref_vs_pallas_and_oracle_f32(H, Hkv, hd):
    B, N, bs, P = 3, 24, 8, 4
    case = _case(H * 100 + hd, B, H, Hkv, hd, N, bs, P, [1, bs * P, bs + 3])
    jcase = [jnp.asarray(a) for a in case]
    out = paged_attention_ref(*_to_torch(case))
    for ref in (jax_kernel(*jcase), jax_ref(*jcase)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("H,Hkv,hd", SWEEP)
def test_ref_vs_oracle_bf16(H, Hkv, hd):
    B, N, bs, P = 3, 24, 8, 4
    case = _case(H + hd, B, H, Hkv, hd, N, bs, P, [1, bs * P, bs + 3],
                 dtype=ml_dtypes.bfloat16)
    out = paged_attention_ref(*_to_torch(case))
    assert out.dtype == torch.bfloat16
    ref = jax_ref(*[jnp.asarray(a) for a in case])
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=0)


def test_inactive_slot_outputs_zero():
    case = _case(0, 2, 4, 2, 32, 8, 4, 2, [5, 0])
    out = paged_attention(*_to_torch(case))
    assert bool((out[1] == 0).all()) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(
        _f32(out), _f32(jax_ref(*[jnp.asarray(a) for a in case])), atol=2e-5)


def test_garbage_beyond_seq_len_is_masked():
    q, kp, vp, tables, lens = _case(7, 1, 2, 2, 32, 6, 4, 3, [6])
    out1 = paged_attention_ref(*_to_torch((q, kp, vp, tables, lens)))
    kp2, vp2 = kp.copy(), vp.copy()
    for pool in (kp2, vp2):
        pool[tables[0, 1], 2:] = 1e4
        pool[tables[0, 2]] = 1e4
    out2 = paged_attention_ref(*_to_torch((q, kp2, vp2, tables, lens)))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)
    jout = jax_kernel(*[jnp.asarray(a) for a in (q, kp2, vp2, tables, lens)])
    np.testing.assert_allclose(out2.numpy(), _f32(jout), atol=2e-5)


def test_ops_on_cpu_takes_plain_version_without_launch():
    case = _to_torch(_case(3, 3, 8, 2, 64, 24, 8, 4, [9, 32, 1]))
    kernels.reset_launch_counts()
    out = paged_attention(*case)
    assert kernels.launch_counts["paged_attention"] == 0
    assert torch.equal(out, paged_attention_ref(*case))


def test_ops_rejects_other_devices():
    case = [t.to("meta") for t in _to_torch(_case(0, 2, 4, 2, 32, 8, 4, 2,
                                                  [5, 3]))]
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_attention(*case)


def test_ops_validation_rejects_bad_operands():
    from repro_torch.kernels.paged_attention.ops import _check
    q, kp, vp, tables, lens = _to_torch(_case(0, 2, 4, 2, 32, 8, 4, 2, [5, 3]))
    _check(q, kp, vp, tables, lens)
    bad = [
        ((q[..., :20], kp[..., :20], vp[..., :20], tables, lens), ValueError),
        ((q, kp, vp, tables.long(), lens), TypeError),
        ((q.double(), kp.double(), vp.double(), tables, lens), TypeError),
        ((q, kp, vp, tables[:, ::2], lens), ValueError),
        ((q, kp.transpose(0, 1), vp.transpose(0, 1), tables, lens), ValueError),
        ((q[:, :3], kp, vp, tables, lens), ValueError),
    ]
    for args, exc in bad:
        with pytest.raises(exc):
            _check(*args)
