"""Port parity of gradient compression (``repro_torch.core.compression``)
against ``repro.core.compression``, and the reference's statistical tests
(unbiasedness, bounded round-trip error, error-feedback convergence) with
torch generators.

A ``jax`` key becomes a ``torch.Generator``; the two draw different numbers,
so parity feeds the port's noise-taking steps (``round_with_noise``,
``ternarize_with_noise``, ``quantize_blocks(flat, noise)``) the noise the
reference draws from its key. Tolerances: equal bit for bit everywhere
except where a per-tensor mean enters (``onebit``: mean |g| summed in
another order, rtol 1e-6, about 8 f32 ulps; the error-feedback residual
then carries that ulp as an absolute error, atol 5e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro_torch.core import compression as C
from repro_torch.kernels.quantize import quantize_blocks

pytestmark = pytest.mark.port

NAMES = ["none", "stochastic_bf16", "int8", "int4", "qsgd", "ternary",
         "onebit", "topk", "topk_int8", "threshold"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _normal(seed, shape, scale=1.0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)
                      * scale, np.float32)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_next_after_steps_the_bit_pattern_as_the_reference(dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    vals = np.array([0.0, -0.0, 1.0, -1.0, 0.1234567, -3.5e-3, 65504.0,
                     1e-30, -1e-30], np.float32)
    for d in (+1, -1):
        want = np.asarray(JC._next_after(jnp.asarray(vals).astype(jdt), d)
                          .astype(jnp.float32))
        got = C._next_after(_t(vals).to(dtype), d).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stochastic_round_with_the_reference_noise(seed):
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (4096,)) * 3.0
    want = JC.stochastic_round(x, key).astype(jnp.float32)
    u = jax.random.uniform(key, x.shape)
    got = C.round_with_noise(_t(x), _t(u))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1000, 4096, 65_537])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_int_with_the_reference_noise(n, bits):
    """The reference's quantize_int computes B9's function in jnp: the
    port's quantize_blocks (B9's plain version on the CPU) fed the same
    noise gives its q and scales bit for bit, and the round trip too."""
    key = jax.random.PRNGKey(n * bits)
    x = jax.random.normal(key, (n,)) * 0.01
    qj, sj, shape = JC.quantize_int(x, key, bits=bits)
    noise = jax.random.uniform(key, qj.shape)
    q, s = quantize_blocks(_t(x), _t(noise), bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        C.dequantize_int(q, s, (n,)).numpy(),
        np.asarray(JC.dequantize_int(qj, sj, shape)))


def test_quantize_int_draws_its_noise_from_the_generator():
    x = _t(_normal(1, (3, 700), 0.1))
    q, s, shape = C.quantize_int(x, _gen(5), bits=4)
    noise = torch.rand((9, 256), generator=_gen(5))
    q2, s2 = quantize_blocks(x.reshape(-1), noise, bits=4)
    assert shape == x.shape and torch.equal(q, q2) and torch.equal(s, s2)
    assert C.dequantize_int(q, s, shape).shape == (3, 700)


def test_ternarize_with_the_reference_noise():
    key = jax.random.PRNGKey(3)
    x = jax.random.normal(key, (1024,))
    u = jax.random.uniform(key, x.shape)
    np.testing.assert_array_equal(
        C.ternarize_with_noise(_t(x), _t(u)).numpy(),
        np.asarray(JC.ternarize(x, key)))


def test_onebit_topk_threshold_match_the_reference():
    x = _normal(4, (64, 33))
    np.testing.assert_allclose(C.onebit(_t(x)).numpy(),
                               np.asarray(JC.onebit(jnp.asarray(x))),
                               rtol=1e-6, atol=0)
    for frac in (0.01, 0.05, 0.2):
        np.testing.assert_array_equal(
            C.topk_sparsify(_t(x), frac).numpy(),
            np.asarray(JC.topk_sparsify(jnp.asarray(x), frac)))
    for tau in (1e-3, 0.5):
        np.testing.assert_array_equal(
            C.threshold_sparsify(_t(x), tau).numpy(),
            np.asarray(JC.threshold_sparsify(jnp.asarray(x), tau)))


def test_dgc_update_matches_the_reference():
    g = {"w": _normal(7, (256,)), "b": _normal(8, (5, 9))}
    v = {k: _normal(9 + i, a.shape, 0.1) for i, (k, a) in
         enumerate(sorted(g.items()))}
    r = {k: _normal(20 + i, a.shape, 0.1) for i, (k, a) in
         enumerate(sorted(g.items()))}
    want = JC.dgc_update(*(jax.tree.map(jnp.asarray, t) for t in (g, v, r)),
                         frac=0.1)
    got = C.dgc_update(*({k: _t(a) for k, a in t.items()} for t in (g, v, r)),
                       frac=0.1)
    for w, o in zip(want, got):
        for k in g:
            np.testing.assert_array_equal(o[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("name", ["topk", "onebit", "threshold", "none"])
def test_compress_with_feedback_matches_the_reference(name):
    """Deterministic compressors over a tree: the sent leaves (cast to each
    gradient's dtype) and the residual, updated in place."""
    g = {"a": _normal(5, (512,)), "b": {"c": _normal(6, (7, 11))}}
    r = {"a": _normal(15, (512,), 0.1), "b": {"c": _normal(16, (7, 11),
                                                          0.1)}}
    jsent, jres = JC.make_compressor(name, frac=0.05).compress_with_feedback(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    tr = {"a": _t(r["a"]), "b": {"c": _t(r["b"]["c"])}}
    held = tr["a"]
    sent, res = C.make_compressor(name, frac=0.05).compress_with_feedback(
        {"a": _t(g["a"]), "b": {"c": _t(g["b"]["c"])}}, tr)
    assert res is tr and res["a"] is held             # updated in place
    # onebit: the mean |g| (~0.8) may differ by an ulp, which the residual
    # (g + r) − sent carries as an absolute error of ~1e-7
    tol = dict(rtol=1e-6, atol=5e-7) if name == "onebit" else dict(rtol=0,
                                                                  atol=0)
    for path in (("a",), ("b", "c")):
        def at(t):
            for k in path:
                t = t[k]
            return t
        np.testing.assert_allclose(at(sent).numpy(), np.asarray(at(jsent)),
                                   **tol)
        np.testing.assert_allclose(at(res).numpy(), np.asarray(at(jres)),
                                   **tol)


def test_compress_with_feedback_keeps_the_gradient_dtype():
    g = {"w": _t(_normal(2, (300,))).to(torch.bfloat16)}
    r = {"w": torch.zeros(300)}
    sent, res = C.make_compressor("int8").compress_with_feedback(g, r)
    assert sent["w"].dtype == torch.bfloat16 and res["w"].dtype == torch.float32
    # residual = (g + r) − the f32 sent value, before its cast
    full = C.make_compressor("int8")(g["w"].float(), _gen(0))
    np.testing.assert_array_equal(res["w"].numpy(),
                                  (g["w"].float() - full).numpy())


def test_compress_with_feedback_draws_the_same_noise_every_call():
    """The reference passes no key in the paper step, so every call uses
    PRNGKey(0): the port makes a fresh generator seeded 0 on every call and
    draws leaf after leaf in key order."""
    comp = C.make_compressor("int8")
    g = {"b": _t(_normal(3, (700,), 0.01)), "a": _t(_normal(4, (300,), 0.01))}
    outs = [comp.compress_with_feedback(
        g, {k: torch.zeros(v.shape) for k, v in g.items()})[0]
        for _ in range(2)]
    gen = _gen(0)
    for k in ("a", "b"):                                # sorted key order
        assert torch.equal(outs[0][k], outs[1][k])
        assert torch.equal(outs[0][k], comp(g[k], gen))


@pytest.mark.parametrize("name", NAMES)
def test_ratios_equal_the_reference(name):
    for kw in ({}, {"frac": 0.015, "bits": 6, "block": 128}):
        assert (C.make_compressor(name, **kw).ratio()
                == JC.make_compressor(name, **kw).ratio())
    with pytest.raises(ValueError, match="unknown"):
        C.make_compressor("gzip")


# ------------------------------------------ the reference's statistics
def test_stochastic_rounding_is_unbiased():
    x = torch.full((20_000,), 0.1234567)
    est = np.mean([float(torch.mean(C.stochastic_round(x, _gen(s)).float()))
                   for s in range(8)])
    assert abs(est - 0.1234567) < 2e-4


@pytest.mark.parametrize("seed", range(5))
def test_stochastic_rounding_lands_on_a_neighbour(seed):
    x = torch.randn(256, generator=_gen(seed))
    r = C.stochastic_round(x, _gen(seed + 100)).float()
    ulp = torch.clamp(torch.abs(x) * 2 ** -7, min=1e-30)
    assert bool(torch.all(torch.abs(r - x) <= ulp + 1e-12))


@pytest.mark.parametrize("name,tol", [("int8", 0.02), ("int4", 0.2),
                                      ("qsgd", 0.02)])
def test_roundtrip_error_bounded(name, tol):
    x = torch.randn(4096, generator=_gen(1)) * 0.01
    y = C.make_compressor(name)(x, _gen(2))
    assert float(torch.linalg.norm(y - x) / torch.linalg.norm(x)) < tol * 4


def test_int_quantization_is_unbiased():
    x = torch.full((50_000,), 0.003217)
    comp = C.make_compressor("int8")
    est = np.mean([float(torch.mean(comp(x, _gen(s)))) for s in range(8)])
    assert abs(est - 0.003217) / 0.003217 < 0.02


def test_ternary_and_onebit_values():
    x = torch.randn(1024, generator=_gen(3))
    s = float(torch.max(torch.abs(x)))
    vals = np.unique(np.round((torch.abs(C.ternarize(x, _gen(4))) / s)
                              .numpy(), 6))
    assert set(vals).issubset({0.0, 1.0})
    y = C.onebit(x)
    assert len(torch.unique(torch.abs(y))) == 1
    assert bool(torch.all(torch.sign(y) == torch.sign(x)))


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.2])
@pytest.mark.parametrize("seed", [0, 7])
def test_topk_keeps_exactly_topk(frac, seed):
    x = torch.randn(2048, generator=_gen(seed))
    y = C.topk_sparsify(x, frac)
    nnz = int(torch.sum(y != 0))
    k = int(2048 * frac)
    assert k <= nnz <= k + 8
    kept_min = float(torch.min(torch.abs(y[y != 0])))
    dropped_max = float(torch.max(torch.abs(torch.where(y == 0, x, 0.0))))
    assert kept_min >= dropped_max - 1e-6


def test_residual_accounts_all_loss():
    comp = C.make_compressor("topk", frac=0.05)
    g = {"a": torch.randn(512, generator=_gen(5)),
         "b": torch.randn(77, generator=_gen(6))}
    r = {k: torch.zeros_like(v) for k, v in g.items()}
    sent, r1 = comp.compress_with_feedback(g, r)
    for k in g:
        np.testing.assert_allclose((sent[k] + r1[k]).numpy(), g[k].numpy(),
                                   rtol=1e-6)


def test_ef_sgd_converges_where_plain_topk_stalls():
    """Survey §6.3: a coordinate with large zero-mean gradient noise wins
    every top-1 selection and starves the descent directions, unless the
    unsent residual accumulates (the reference's test, in torch)."""
    dim = 10
    A = torch.eye(dim)
    b = torch.ones(dim)

    def grad(w, t):
        g = A @ w - b
        g[0] += 5.0 if t % 2 == 0 else -5.0
        return g

    w_ef, r, w_plain = torch.zeros(dim), torch.zeros(dim), torch.zeros(dim)
    for t in range(400):
        g = grad(w_ef, t) + r
        sent = C.topk_sparsify(g, 1.0 / dim)
        r = g - sent
        w_ef = w_ef - 0.1 * sent
        w_plain = w_plain - 0.1 * C.topk_sparsify(grad(w_plain, t), 1.0 / dim)
    sol = torch.linalg.solve(A, b)
    err_ef = float(torch.linalg.norm(w_ef - sol))
    err_plain = float(torch.linalg.norm(w_plain - sol))
    assert err_plain > 2.0 and err_ef < 0.4 * err_plain


def test_published_ratio_range_and_ordering():
    assert 40 < C.make_compressor("topk_int8", frac=0.015).ratio() < 60
    assert 500 < C.make_compressor("topk_int8", frac=0.0005).ratio() < 3000
    r = {n: C.make_compressor(n).ratio()
         for n in ("stochastic_bf16", "int8", "int4", "ternary", "onebit")}
    assert (r["stochastic_bf16"] < r["int8"] < r["int4"] < r["ternary"]
            < r["onebit"])


def test_dgc_clears_what_it_sent():
    g = {"w": torch.randn(256, generator=_gen(7))}
    zero = {"w": torch.zeros(256)}
    sent, v1, r1 = C.dgc_update(g, zero, zero, frac=0.1)
    nz = sent["w"] != 0
    assert torch.all(v1["w"][nz] == 0) and torch.all(r1["w"][nz] == 0)
    assert torch.any(v1["w"][~nz] != 0)
