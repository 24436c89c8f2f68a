"""Port parity of the survey's §4.3 convolution algorithms
(``repro_torch.models.conv``): each of the port's four algorithms against
the same JAX function (``repro.models.conv``) on the same numpy inputs, at
the reference's shapes (tests/test_conv_algorithms.py) and tolerances
(atol = rtol = 1e-4); the same cross-validation against ``conv_direct``
on the port itself; and the paper's numerics claim (Winograd less accurate
than im2col at large magnitudes) on the port. On the CPU ``conv_im2col``'s
GEMM takes ``matmul``'s plain version; chip_smoke.py holds the algorithms
against each other on the card, where the GEMM is kernel B7."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import conv as JC
from repro_torch import kernels
from repro_torch.models import conv as CV

pytestmark = pytest.mark.port


def data(seed, N=2, C=3, H=18, K=4, Ky=3):
    """The reference's `data` shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C, H, H)).astype(np.float32)
    w = (rng.standard_normal((K, C, Ky, Ky)) * 0.2).astype(np.float32)
    return x, w


def _both(algo, x, w):
    want = np.asarray(JC.ALGORITHMS[algo](jnp.asarray(x), jnp.asarray(w)))
    got = CV.ALGORITHMS[algo](torch.from_numpy(x.copy()),
                              torch.from_numpy(w.copy()))
    return got.numpy(), want


def test_algorithm_registry_matches_reference():
    assert list(CV.ALGORITHMS) == list(JC.ALGORITHMS)


@pytest.mark.parametrize("algo", ["direct", "im2col", "fft", "winograd"])
def test_3x3_vs_jax(algo):
    x, w = data(0)
    got, want = _both(algo, x, w)
    assert got.shape == want.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("algo", ["direct", "im2col", "fft"])
@pytest.mark.parametrize("Ky", [1, 5, 7])
def test_other_kernel_sizes_vs_jax(algo, Ky):
    x, w = data(1, H=20, Ky=Ky)
    got, want = _both(algo, x, w)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("algo", ["direct", "im2col", "fft", "winograd"])
def test_batch_and_channel_generalization_vs_jax(algo):
    x, w = data(2, N=5, C=7, K=11)
    got, want = _both(algo, x, w)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_winograd_odd_output_keeps_the_reference_shape():
    """An odd output size: the reference's 2x2 tiles cover one row and
    column fewer, and the port returns the same shape and values."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2, 17, 19)).astype(np.float32)
    w = rng.standard_normal((3, 2, 3, 3)).astype(np.float32)
    got, want = _both("winograd", x, w)
    assert got.shape == want.shape == (1, 3, 14, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("algo", ["im2col", "fft", "winograd"])
def test_port_algorithms_match_port_direct(algo):
    x, w = (torch.from_numpy(a) for a in data(0))
    np.testing.assert_allclose(CV.ALGORITHMS[algo](x, w).numpy(),
                               CV.conv_direct(x, w).numpy(), atol=1e-4,
                               rtol=1e-4)


def test_winograd_less_accurate_than_im2col_on_the_port():
    """§4.3: 'the numerical accuracy of Winograd convolution is generally
    lower than the other methods' — visible at larger magnitudes. The
    reference's test on the port's algorithms: its inputs (drawn with
    PRNGKey(3) as its `data` does) and its truth (``conv_direct`` in f32,
    the reference's branch without x64). At this size (3 input channels)
    the two errors are close, and which is larger depends on the draw
    (PERF.md §6); chip_smoke.py measures the claim at the survey's
    Table 6 layer against a float64 truth."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    x = np.asarray(jax.random.normal(k1, (2, 3, 18, 18))) * 100.0
    w = np.asarray(jax.random.normal(k2, (4, 3, 3, 3)) * 0.2)
    tx, tw = torch.from_numpy(x.copy()), torch.from_numpy(w.copy())
    ref = CV.conv_direct(tx, tw).numpy()
    err_wino = np.max(np.abs(CV.conv_winograd(tx, tw).numpy() - ref))
    err_im2col = np.max(np.abs(CV.conv_im2col(tx, tw).numpy() - ref))
    assert err_wino >= err_im2col


def test_winograd_refuses_other_kernel_sizes():
    x, w = (torch.from_numpy(a) for a in data(4, Ky=5))
    with pytest.raises(AssertionError, match="3x3"):
        CV.conv_winograd(x, w)


def test_im2col_gemm_takes_the_plain_version_on_cpu():
    kernels.reset_launch_counts()
    x, w = (torch.from_numpy(a) for a in data(6))
    CV.conv_im2col(x, w)
    assert kernels.launch_counts["matmul"] == 0


def test_conv_direct_scopes_its_tf32_setting():
    """conv_direct switches cuDNN's TF32 off for its own call only: the
    caller's cuDNN settings are the same afterwards."""
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
              cudnn.allow_tf32)
    x, w = (torch.from_numpy(a) for a in data(7))
    CV.conv_direct(x, w)
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32) == before
