"""Port parity: every Table 3 update rule of ``repro_torch.optim`` against
the JAX package's ``repro.optim.optimizers`` on the same random f32 and
bf16 parameter trees and gradients (made with numpy), one and three
updates, with and without global-norm clipping, Adam's weight decay, and
the Nesterov lookahead point.

Tolerances: f32 masters, moments and params atol 1e-6 / rtol 1e-6 (the
same f32 arithmetic; the step size's bias corrections and decays are
computed in float64 on the host here and in f32 by XLA); bf16 params
within one bf16 step (rtol 2**-8) of the reference's cast of its master.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as JO
from repro_torch.optim import OPTIMIZERS, lookahead, make_optimizer
from repro_torch.tree import leaves_with_path

pytestmark = pytest.mark.port

SHAPES = {"blocks": {"w": (2, 6, 5), "b": (2, 5)}, "embed": (7, 6),
          "norm": (6,)}


def _tree(rng, shapes=SHAPES):
    return {k: _tree(rng, v) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(np.array(a), dtype), tree)


def _torch(tree, dtype):
    return jax.tree.map(lambda a: torch.tensor(np.array(a)).to(dtype), tree)


def _pairs(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = leaves_with_path(ttree)
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tl]
    return [(np.asarray(a, np.float32), b.float().numpy())
            for (_, a), (_, b) in zip(jl, tl)]


def _run(name, dtype, steps, **kw):
    rng = np.random.default_rng(10 * OPTIMIZERS.index(name) + steps)
    p0 = _tree(rng)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jopt = JO.make_optimizer(name, lr=1e-2, **kw)
    topt = make_optimizer(name, lr=1e-2, **kw)
    jp, tp = _jax(p0, jdt), _torch(p0, tdt)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(steps):
        g = _tree(rng)
        jp, js = jopt.update(_jax(g, jdt), js, jp)
        tp, ts = topt.update(_torch(g, tdt), ts, tp)
    return jp, js, tp, ts


def _assert_state(js, ts):
    assert set(js) == set(ts)
    assert int(js["step"]) == ts["step"]
    for key in js:
        if key == "step":
            continue
        for a, b in _pairs(js[key], ts[key]):
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6, err_msg=key)


def _assert_params(jp, tp, dtype):
    for a, b in _pairs(jp, tp):
        if dtype == "float32":
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_allclose(b, a, atol=0, rtol=2 ** -8)
    for (_, p) in leaves_with_path(tp):
        assert p.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_rule_matches_reference(name, dtype, steps):
    jp, js, tp, ts = _run(name, dtype, steps)
    _assert_state(js, ts)
    _assert_params(jp, tp, dtype)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_global_norm_clipping_matches_reference(name):
    """grad_clip 0.5 against gradients of norm ~5: every step clips."""
    jp, js, tp, ts = _run(name, "float32", 3, grad_clip=0.5)
    _assert_state(js, ts)
    _assert_params(jp, tp, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_weight_decay_matches_reference(dtype):
    jp, js, tp, ts = _run("adam", dtype, 3, weight_decay=0.1, grad_clip=1.0)
    _assert_state(js, ts)
    _assert_params(jp, tp, dtype)


def test_nesterov_lookahead_matches_reference():
    _, js, _, ts = _run("nesterov", "float32", 2)
    for a, b in _pairs(JO.lookahead(js, momentum=0.9),
                       lookahead(ts, momentum=0.9)):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)


def test_update_is_in_place_and_keeps_f32_master():
    opt = make_optimizer("adam", lr=1e-2)
    params = _torch(_tree(np.random.default_rng(0)), torch.bfloat16)
    state = opt.init(params)
    leaf = params["embed"]
    grads = _torch(_tree(np.random.default_rng(1)), torch.bfloat16)
    new_params, new_state = opt.update(grads, state, params)
    assert new_params is params and new_state is state
    assert params["embed"] is leaf and state["step"] == 1
    assert state["master"]["embed"].dtype == torch.float32
    np.testing.assert_array_equal(
        leaf.float().numpy(),
        state["master"]["embed"].to(torch.bfloat16).float().numpy())


def test_unknown_rule_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion")
