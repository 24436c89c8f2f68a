"""Port parity of the Work-Depth model (``repro_torch.core.workdepth``, the
port's copy of ``repro.core.workdepth``): every function returns the
reference's W and D over a grid of shapes, the LeNet-5 numbers are the
survey's published W = 665,832 / D = 41, and ``transformer_train_wd`` on the
port's configs equals the reference's on the JAX configs of the same name.
All integer arithmetic: the values must be equal."""
import dataclasses

import pytest

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import workdepth as JW
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core import workdepth as W

pytestmark = pytest.mark.port


def _same(a, b):
    assert (a.work, a.depth) == (b.work, b.depth)
    assert a.avg_parallelism == b.avg_parallelism


@pytest.mark.parametrize("phase", ["y", "dw", "dx"])
@pytest.mark.parametrize("N,C_in,C_out", [(1, 1, 1), (32, 400, 120),
                                          (7, 84, 10), (128, 4096, 11008)])
def test_fully_connected(N, C_in, C_out, phase):
    _same(W.fully_connected(N, C_in, C_out, phase),
          JW.fully_connected(N, C_in, C_out, phase))


# (N, H, W, C_in, C_out, Kx, Ky): LeNet's layers, Table 6's layer at each
# kernel size, rectangular and 1x1 cases
CONV_SHAPES = [(1, 32, 32, 1, 6, 5, 5), (1, 14, 14, 6, 16, 5, 5),
               *[(64, 56, 56, 64, 64, k, k) for k in (3, 5, 7, 11, 13)],
               (2, 20, 31, 3, 8, 1, 1), (3, 17, 9, 5, 7, 3, 2)]


@pytest.mark.parametrize("phase", ["y", "dx"])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_direct_and_im2col(shape, phase):
    _same(W.conv_direct(*shape, phase=phase),
          JW.conv_direct(*shape, phase=phase))
    _same(W.conv_im2col(*shape), JW.conv_im2col(*shape))


@pytest.mark.parametrize("c", [5.0, 3.0])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_fft(shape, c):
    _same(W.conv_fft(*shape, c=c), JW.conv_fft(*shape, c=c))


@pytest.mark.parametrize("r,m", [(3, 2), (3, 4), (5, 4), (3, 6)])
@pytest.mark.parametrize("N,H,W_,C_in,C_out", [(64, 56, 56, 64, 64),
                                               (1, 18, 18, 3, 4),
                                               (5, 33, 17, 7, 11)])
def test_conv_winograd(N, H, W_, C_in, C_out, r, m):
    _same(W.conv_winograd(N, H, W_, C_in, C_out, r, m),
          JW.conv_winograd(N, H, W_, C_in, C_out, r, m))


@pytest.mark.parametrize("phase", ["y", "dx"])
@pytest.mark.parametrize("N,C,H,W_,K", [(1, 6, 28, 28, 2), (8, 16, 10, 10, 2),
                                        (4, 64, 56, 56, 3)])
def test_pooling_activation_batchnorm(N, C, H, W_, K, phase):
    _same(W.pooling(N, C, H, W_, K, K, phase), JW.pooling(N, C, H, W_, K, K,
                                                          phase))
    _same(W.activation(N, C, H, W_, phase), JW.activation(N, C, H, W_, phase))
    _same(W.batchnorm(N, C, H, W_, phase), JW.batchnorm(N, C, H, W_, phase))


@pytest.mark.parametrize("window", [None, 1024, 8192])
@pytest.mark.parametrize("N,S,H,hd", [(1, 128, 4, 64), (2, 4096, 32, 128),
                                      (1, 2048, 32, 80)])
def test_attention(N, S, H, hd, window):
    _same(W.attention(N, S, H, hd, window=window),
          JW.attention(N, S, H, hd, window=window))


def test_lenet5_published_numbers():
    total = W.lenet5_inference()
    assert (total.work, total.depth) == (665_832, 41)
    _same(total, JW.lenet5_inference())
    _same(W.lenet5_paper_total(), JW.lenet5_paper_total())
    assert W.LENET5_PAPER == JW.LENET5_PAPER
    layers = W.lenet5_layers()
    assert layers.keys() == JW.lenet5_layers().keys()
    for name, wd in layers.items():
        _same(wd, JW.lenet5_layers()[name])
        assert (wd.work, wd.depth) == W.LENET5_PAPER[name]


def test_table5_networks_and_wd_algebra():
    assert W.network_table5() == JW.network_table5()
    a, b = W.WD(10, 3), W.WD(5, 0)
    assert (a + b) == W.WD(15, 3) and b.avg_parallelism == 5.0
    assert W._clog2(1) == JW._clog2(1) == 0
    assert all(W._clog2(n) == JW._clog2(n) for n in range(2, 300))


@pytest.mark.parametrize("batch,seq", [(1, 2048), (2, 4096), (8, 64)])
@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-12b", "stablelm-3b"])
@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_transformer_train_wd_on_the_ports_configs(arch, cut, batch, seq):
    tc, jc = get_config(arch), jax_get_config(arch)
    if cut == "reduced":
        tc, jc = reduced(tc), jax_reduced(jc)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    _same(W.transformer_train_wd(tc, batch, seq),
          JW.transformer_train_wd(jc, batch, seq))


def test_every_port_config_has_a_reference_twin():
    assert set(list_configs()) == {"gemma3-12b", "stablelm-3b", "yi-9b"}
    for name in list_configs():
        _same(W.transformer_train_wd(get_config(name), 2, 512),
              JW.transformer_train_wd(jax_get_config(name), 2, 512))
