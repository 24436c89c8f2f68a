"""Port parity: the port's blocked GEMM (``repro_torch.kernels.matmul``)
against the JAX package's Pallas kernel (interpret mode with 128-blocks, as
tests/test_kernels.py:14 runs it) and its pure-jnp oracle, on the same numpy
inputs.

Tolerances are the reference's own (tests/test_kernels.py:25): float32
atol 2e-6·K, bfloat16 0.15, rtol 0.05. The Pallas wrapper refuses shapes its
blocks do not divide, so ragged shapes are held against ``matmul_ref``
alone. On CPU tensors the wrapper takes the plain version and leaves the
kernel's launch counter at 0; the CUDA kernel is held against the plain
version on the card by chip_smoke.py."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul as jax_matmul
from repro.kernels.matmul import matmul_ref as jax_matmul_ref
from repro_torch import kernels
from repro_torch.kernels.matmul import matmul, matmul_ref

pytestmark = pytest.mark.port

# tests/test_kernels.py:14's sweep: (M, K, N)
SWEEP = [(128, 128, 128), (256, 512, 128), (128, 1024, 256), (384, 256, 640)]
# no dim divides a block: K past a 16-deep tile, M and N past 128 x 64 tiles
RAGGED = [(1000, 577, 65), (1, 9, 1), (130, 17, 70), (7, 33, 129)]
DTYPES = [np.float32, ml_dtypes.bfloat16]


def _ab(seed, M, K, N, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32).astype(dtype)
    b = rng.standard_normal((K, N)).astype(np.float32).astype(dtype)
    return a, b


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype, K):
    return 2e-6 * K if dtype == np.float32 else 0.15


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", SWEEP)
def test_sweep_vs_pallas_and_oracle(M, K, N, dtype):
    a, b = _ab(M + N, M, K, N, dtype)
    before = dict(kernels.launch_counts)
    out = matmul(_t(a), _t(b))
    assert kernels.launch_counts == before
    assert out.dtype == _t(a).dtype and tuple(out.shape) == (M, N)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pallas = jax_matmul(ja, jb, block_m=128, block_n=128, block_k=128)
    for ref in (pallas, jax_matmul_ref(ja, jb)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=_tol(dtype, K),
                                   rtol=0.05)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", RAGGED)
def test_ragged_shapes_vs_oracle(M, K, N, dtype):
    a, b = _ab(K, M, K, N, dtype)
    out = matmul(_t(a), _t(b))
    ref = jax_matmul_ref(jnp.asarray(a), jnp.asarray(b))
    assert tuple(out.shape) == (M, N)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=_tol(dtype, K),
                               rtol=0.05)


@pytest.mark.parametrize("dtype,out_dtype", [
    (np.float32, ml_dtypes.bfloat16), (ml_dtypes.bfloat16, np.float32),
    (np.float32, np.float32)])
def test_out_dtype_vs_oracle(dtype, out_dtype):
    a, b = _ab(3, 64, 200, 48, dtype)
    t_out = {np.float32: torch.float32,
             ml_dtypes.bfloat16: torch.bfloat16}[out_dtype]
    out = matmul(_t(a), _t(b), out_dtype=t_out)
    ref = jax_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                         out_dtype=jnp.dtype(out_dtype))
    assert out.dtype == t_out
    tol = 2e-6 * 200 if out_dtype == np.float32 else 0.15
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol, rtol=0.05)


def test_plain_version_sums_in_f32():
    """bf16 operands are multiplied and summed in f32 and rounded once."""
    a, b = _ab(4, 16, 300, 8, ml_dtypes.bfloat16)
    want = (a.astype(np.float32).astype(np.float64)
            @ b.astype(np.float32).astype(np.float64))
    out = matmul_ref(_t(a), _t(b), torch.float32)
    np.testing.assert_allclose(_f32(out), want, atol=2e-6 * 300, rtol=0)


@pytest.mark.parametrize("bad", ["dtype_mismatch", "rank3", "int", "inner",
                                 "out_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, b, kw = torch.zeros(4, 8), torch.zeros(8, 3), {}
    if bad == "dtype_mismatch":
        b = b.to(torch.bfloat16)
    elif bad == "rank3":
        a = torch.zeros(2, 4, 8)
    elif bad == "int":
        a, b = a.int(), b.int()
    elif bad == "inner":
        b = torch.zeros(7, 3)
    else:
        kw = dict(out_dtype=torch.float16)
    with pytest.raises((ValueError, TypeError)):
        matmul(a, b, **kw)


def test_cpu_tensors_never_count_a_launch():
    kernels.reset_launch_counts()
    matmul(torch.ones(5, 6), torch.ones(6, 7))
    assert kernels.launch_counts["matmul"] == 0
