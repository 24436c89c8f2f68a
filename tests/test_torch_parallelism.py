"""Port parity of the sharding plans' rules (``repro_torch.core.parallelism``)
against the reference's (``repro.core.parallelism``), with no ranks: both
run on shape-only meshes (JAX ``AbstractMesh`` against the port's
``AbstractMesh``) and read the same (path, shape) leaves, and the specs
must be equal as tuples (both store a one-axis entry as its name).

Covered: ``param_specs`` and ``opt_specs`` (ZeRO-1) of all ten configs at
their full shapes (``jax.eval_shape`` of the JAX ``init_params``), every
plan of ``PLANS``, on the production meshes (16, 16) and (2, 16, 16) and on
(2, 2); ``batch_specs`` with M-RoPE's (3, B, S) positions;
``cache_specs`` of ``init_decode_state`` shapes at batch 1 and 8 (the
dp_tp_seq sequence split); ``logical_spec``; ``constrain`` as a no-op
outside a plan context or on a plain tensor; ``make_plan("nope")`` raising.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import base as JB
from repro.core import parallelism as jpar
from repro.models import transformer as JT
from repro_torch.configs import base as B
from repro_torch.core import parallelism as par
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T

pytestmark = pytest.mark.port

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model"))]


def _jax_mesh(shape, axes):
    try:
        return JaxAbstractMesh(shape, axes)
    except TypeError:   # older jax: AbstractMesh(((name, size), ...))
        return JaxAbstractMesh(tuple(zip(axes, shape)))


def _plans(name):
    for shape, axes in MESHES:
        yield (jpar.make_plan(name, _jax_mesh(shape, axes)),
               par.make_plan(name, par.AbstractMesh(shape, axes)))


def _flat_jax(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in leaves}


def _flat(specs, prefix=()):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    assert isinstance(specs, par.P), specs
    return {"/".join(prefix): tuple(specs)}


def _abstract_params(name):
    return jax.eval_shape(lambda k: JT.init_params(JB.get_config(name), k),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", JB.list_configs())
def test_param_and_opt_specs_match_reference(name):
    shapes = _abstract_params(name)
    # the port's own parameter layout is the one the rules read
    port = {k: tuple(v[0]) for k, v in _flat_shapes(
        T.param_specs(B.get_config(name))).items()}
    assert port == {k: tuple(s.shape) for k, s in _flat_leaves(shapes)}
    for name_plan in par.PLANS:
        for jp, tp in _plans(name_plan):
            assert _flat(tp.param_specs(shapes)) == _flat_jax(
                jp.param_specs(shapes)), (name_plan, tp.shape)
            assert _flat(tp.opt_specs(shapes)) == _flat_jax(
                jp.opt_specs(shapes)), (name_plan, tp.shape)


def _flat_shapes(specs, prefix=()):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_flat_shapes(v, prefix + (k,)))
        return out
    return {"/".join(prefix): specs}


def _flat_leaves(tree):
    return [("/".join(str(k.key) for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_plan_axes_match_reference():
    for name in par.PLANS:
        for jp, tp in _plans(name):
            assert tp.batch_axes == tuple(jp.batch_axes), name
            assert tp.tensor_axes == tuple(jp.tensor_axes), name
            assert tp.seq_axes == tuple(jp.seq_axes), name


@pytest.mark.parametrize("B_", [1, 6, 8, 256])
def test_batch_specs_match_reference(B_):
    S, D = 64, 32
    batch = {"tokens": np.zeros((B_, S), np.int32),
             "labels": np.zeros((B_, S), np.int32),
             "embeds": np.zeros((B_, S, D), np.float32),
             "positions": np.zeros((3, B_, S), np.int32)}
    for name in par.PLANS:
        for jp, tp in _plans(name):
            assert _flat(tp.batch_specs(batch)) == _flat_jax(
                jp.batch_specs(batch)), (name, tp.shape)
            assert tuple(tp.spec_for_batch_leaf("token", (B_,))) == tuple(
                jp.spec_for_batch_leaf("token", (B_,)))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", ["yi-9b", "gemma3-12b", "qwen3-moe-30b-a3b",
                                  "rwkv6-7b", "zamba2-2.7b"])
def test_cache_specs_match_reference(name, batch):
    cfg = JB.get_config(name)
    max_len = 32768
    shapes = jax.eval_shape(lambda: JT.init_decode_state(cfg, batch, max_len))
    # the port's dense decode state has the reference's paths and shapes
    port = T.init_decode_state(B.get_config(name), batch, max_len,
                               device="meta")
    assert {k: tuple(v.shape) for k, v in _flat_shapes(port).items()} == {
        k: tuple(s.shape) for k, s in _flat_leaves(shapes)}
    for name_plan in par.PLANS:
        for jp, tp in _plans(name_plan):
            assert _flat(tp.cache_specs(shapes)) == _flat_jax(
                jp.cache_specs(shapes)), (name_plan, tp.shape)
    if cfg.family == "dense" and batch == 1:
        # long-context decode: the cache's sequence goes over 'data'
        tp = par.make_plan("dp_tp_seq", make_production_mesh())
        assert tp.cache_specs(shapes)["l0"]["k"][2] == "data"


def test_logical_spec_matches_reference():
    names = [("batch", "seq", None), ("heads", "ffn", "vocab"),
             ("expert", "capacity", None), (None, "seq"), ("batch",)]
    for name in par.PLANS:
        for jp, tp in _plans(name):
            for n in names:
                assert tuple(tp.logical_spec(n)) == tuple(
                    jp.logical_spec(n)), (name, n)


def test_production_mesh_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}


def test_constrain_noop_and_unknown_plan():
    x = torch.ones(4, 8)
    assert par.constrain(x, ("batch", None)) is x
    plan = par.make_plan("dp_tp", par.AbstractMesh((2, 2), ("data", "model")))
    with par.plan_context(plan):
        assert par.current_plan() is plan
        assert par.constrain(x, ("batch", None)) is x   # not a DTensor
    assert par.current_plan() is None
    with pytest.raises(ValueError, match="unknown plan"):
        par.make_plan("nope", plan.mesh)
    with pytest.raises(ValueError):
        jpar.make_plan("nope", _jax_mesh((2, 2), ("data", "model")))
