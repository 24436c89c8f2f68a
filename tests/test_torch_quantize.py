"""Port parity of the block quantizer (``repro_torch.kernels.quantize.
quantize_blocks``, kernels B8/B9 on the card) against the JAX package's
pure-jnp oracle ``quantize_blocks_ref`` and its Pallas kernel in interpret
mode (``quantize_blocks``, as tests/test_kernels.py runs it), on the same
numpy inputs and noise.

Tolerances: against the oracle, q and scales equal bit for bit (both
compute amax / maxq and x / scale as IEEE f32 divisions). Against the
Pallas kernel, q equal and scales within the reference's own rtol=1e-6
(tests/test_kernels.py:97): in interpret mode the kernel's scale is amax ·
(1/maxq), one ulp off amax / maxq in about 1 row in 16. On CPU tensors the
wrapper takes the plain version and leaves the launch counters at 0; the
CUDA kernels are held against the plain version on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize import dequantize_blocks as jax_dequantize
from repro.kernels.quantize import quantize_blocks as jax_quantize
from repro.kernels.quantize import quantize_blocks_ref as jax_ref
from repro_torch import kernels
from repro_torch.kernels.quantize import (dequantize_blocks, quantize_blocks,
                                          quantize_blocks_ref)

pytestmark = pytest.mark.port

MODES = ["stochastic", "nearest"]


def _case(n, bits, scale=0.02):
    """tests/test_kernels.py:86's inputs: the flat values, the padded rows
    and the noise JAX's quantize_blocks draws for them."""
    key = jax.random.PRNGKey(n + bits)
    flat = jax.random.normal(key, (n,)) * scale
    x = jnp.pad(flat, (0, (-n) % 256)).reshape(-1, 256)
    noise = jax.random.uniform(key, x.shape)
    return key, flat, x, noise


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [256, 1000, 4096, 65_537])
@pytest.mark.parametrize("bits", [8, 4])
def test_equals_the_oracle_bit_for_bit(n, bits, mode):
    _, flat, x, noise = _case(n, bits)
    kernels.reset_launch_counts()
    q, s = quantize_blocks(_t(flat), _t(noise), bits=bits, mode=mode)
    qr, sr = jax_ref(x, noise, bits=bits, mode=mode)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == (-(-n // 256), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    assert kernels.launch_counts["quantize_" + mode] == 0
    # the port's own plain version on the padded rows, the card's yardstick
    q2, s2 = quantize_blocks_ref(_t(x), _t(noise), bits=bits, mode=mode)
    assert torch.equal(q2, q) and torch.equal(s2, s)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [256, 1000, 4096, 65_537])
@pytest.mark.parametrize("bits", [8, 4])
def test_matches_the_pallas_kernel(n, bits, mode):
    key, flat, _, noise = _case(n, bits)
    qk, sk = jax_quantize(flat, key, bits=bits, mode=mode)
    q, s = quantize_blocks(_t(flat), _t(noise), bits=bits, mode=mode)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qk))
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_zero_block_and_ragged_tail(mode):
    """An all-zero row gets scale 1.0 and q 0; the rows past n quantize as
    the reference's zero padding (n = 256·3 + 5: a zero row, a full row, a
    ragged tail)."""
    rng = np.random.default_rng(3)
    flat = (rng.standard_normal(256 * 3 + 5) * 0.1).astype(np.float32)
    flat[256:512] = 0.0
    x = np.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256)
    noise = rng.random(x.shape, dtype=np.float32)
    q, s = quantize_blocks(_t(flat), _t(noise), mode=mode)
    qr, sr = jax_ref(jnp.asarray(x), jnp.asarray(noise), mode=mode)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    assert s[1] == 1.0 and not q[1].any() and not q[3, 5:].any()


def test_dequantize_matches_reference_and_bounds_the_error():
    key, flat, x, noise = _case(8192, 8, scale=1.0)
    q, s = quantize_blocks(_t(flat), _t(noise))
    deq = dequantize_blocks(q, s, n=8192)
    want = jax_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                          n=8192)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(want))
    # error per element ≤ scale = max|row| / 127 (tests/test_kernels.py:99)
    err = float(torch.max(torch.abs(deq - _t(flat))))
    assert err <= float(torch.max(s)) + 1e-6
    assert dequantize_blocks(q, s).shape == (8192,)


def test_rejects_what_the_kernel_does_not_take():
    flat = torch.zeros(300)
    with pytest.raises(ValueError, match="noise"):
        quantize_blocks(flat)
    with pytest.raises(ValueError, match="noise"):
        quantize_blocks(flat, torch.zeros(1, 256))
    with pytest.raises(ValueError, match="mode"):
        quantize_blocks(flat, mode="floor")
    with pytest.raises(ValueError, match="bits"):
        quantize_blocks(flat, torch.zeros(2, 256), bits=9)
    q, s = quantize_blocks(flat, mode="nearest")      # no noise needed
    assert q.shape == (2, 256) and torch.equal(s, torch.ones(2))
