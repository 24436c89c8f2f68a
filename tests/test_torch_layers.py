"""Port parity: ``repro_torch.models.layers`` against ``repro.models.layers``
on the same numpy inputs (float32, CPU). Tolerance 1e-6: both sides run the
same float32 arithmetic, and only the order of the sums in a product and
the libm's last bit differ."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.models import layers as TL

pytestmark = pytest.mark.port

ATOL = 1e-6


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("seed", range(3))
def test_rmsnorm(seed):
    rng = np.random.default_rng(seed)
    xj, xt = _pair(rng.standard_normal((3, 5, 32)))
    sj, st = _pair(rng.uniform(0.5, 1.5, 32))
    _close(JL.rmsnorm({"scale": sj}, xj, 1e-6),
           TL.rmsnorm({"scale": st}, xt, 1e-6))


@pytest.mark.parametrize("seed", range(3))
def test_swiglu(seed):
    rng = np.random.default_rng(seed)
    d, f = 16, 32
    xj, xt = _pair(rng.standard_normal((2, 3, d)) * 0.5)
    pj, pt = {}, {}
    for name, shape in (("w_gate", (d, f)), ("w_in", (d, f)),
                        ("w_out", (f, d))):
        pj[name], pt[name] = _pair(rng.standard_normal(shape)
                                   / np.sqrt(shape[0]))
    _close(JL.swiglu(pj, xj), TL.swiglu(pt, xt))


@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (64, 1_000_000.0)])
def test_apply_rope(hd, theta):
    rng = np.random.default_rng(hd)
    xj, xt = _pair(rng.standard_normal((2, 5, 3, hd)))
    pos = rng.integers(0, 2048, size=(2, 5)).astype(np.int32)
    _close(JL.apply_rope(xj, jnp.asarray(pos), theta),
           TL.apply_rope(xt, torch.from_numpy(pos), theta))


def test_rope_freqs_identical():
    np.testing.assert_array_equal(JL.rope_freqs(128, 10_000.0),
                                  TL.rope_freqs(128, 10_000.0))


def test_embed_unembed():
    rng = np.random.default_rng(0)
    tj, tt = _pair(rng.standard_normal((50, 16)) * 0.02)
    ids = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    _close(JL.embed({"table": tj}, jnp.asarray(ids)),
           TL.embed({"table": tt}, torch.from_numpy(ids).long()), atol=0)
    hj, ht = _pair(rng.standard_normal((3, 7, 16)))
    _close(JL.unembed({"table": tj}, hj), TL.unembed({"table": tt}, ht))


def test_dtype_of():
    for dt in ("float32", "bfloat16"):
        cfg = ModelConfig(name="t", family="dense", dtype=dt)
        assert TL.dtype_of(cfg) == getattr(torch, dt)


def test_dense_init_scale_and_dtype():
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init((256, 512), torch.bfloat16, gen, "cpu")
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (256, 512)
    assert abs(float(w.float().std()) - 1 / 16) < 2e-3
    e = TL.embed_init((300, 64), torch.float32, gen, "cpu")
    assert abs(float(e.std()) - 0.02) < 1e-3


def test_config_copy_matches_reference():
    """The port's ModelConfig is a field-for-field copy: same fields, same
    defaults, and yi-9b and its reduced variant are identical."""
    jf = {f.name: f.default for f in JaxModelConfig.__dataclass_fields__.values()}
    tf = {f.name: f.default for f in ModelConfig.__dataclass_fields__.values()}
    assert jf == tf
    import dataclasses
    j, t = jax_get_config("yi-9b"), get_config("yi-9b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    from repro.configs.base import reduced as jax_reduced
    assert (dataclasses.asdict(jax_reduced(j))
            == dataclasses.asdict(reduced(t)))
