"""Port parity of the MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU: ``moe_apply`` at ample capacity and at a
capacity where experts overflow (and drop assignments), its gradients
against ``jax.grad``, ``load_balance_loss``, the configs' parameter counts,
the expert leaves' initial scale, and the expert-parallel refusals.

Weights: the JAX ``init_moe`` leaves of reduced qwen3-moe-30b-a3b (4
experts, top 2, d 256, f32), carried across as numpy arrays. Inputs: unit-scale normal rows, as
an rmsnorm hands the layer. The reference's experts start at std 1/√E =
0.5, so outputs reach ~1e3: outputs and gradients are held within 1e-5 of
the reference's largest magnitude (f32 sums in another order), the loss
within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_configs as jax_list_configs
from repro.configs.base import reduced as jax_reduced
from repro.models import moe as JM
from repro_torch.configs import ModelConfig, get_config, list_configs, reduced
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

ARCH = "qwen3-moe-30b-a3b"
LEAVES = ("router", "w_gate", "w_in", "w_out")
_CACHE = {}


def _layer():
    """(jax cfg, port cfg, JAX ``init_moe`` leaves, the same as torch)."""
    if not _CACHE:
        jc = dataclasses.replace(jax_reduced(jax_get_config(ARCH)),
                                 dtype="float32")
        tc = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
        jm = JM.init_moe(jax.random.PRNGKey(0), jc)
        tm = {k: torch.from_numpy(np.asarray(v, np.float32).copy())
              for k, v in jm.items()}
        _CACHE["layer"] = jc, tc, jm, tm
    return _CACHE["layer"]


def _jax_moe(params, x, cfg):
    return jax.jit(JM.moe_apply, static_argnums=2)(params, x, cfg)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _dropped(tc, x):
    """Assignments past their expert's capacity for the rows x."""
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    _, _, top_e = M._route(_layer()[3], xt, tc)
    C = M.capacity(xt.shape[0], tc)
    return int((~M._slots(top_e.reshape(-1), tc.num_experts, C)[2]).sum())


@pytest.mark.parametrize("factor,overflow", [(8.0, False), (1.0, True)])
def test_moe_apply_matches_reference(factor, overflow):
    jc, tc, jm, tm = _layer()
    jc, tc = (dataclasses.replace(c, capacity_factor=factor)
              for c in (jc, tc))
    x = _x((2, 12, tc.d_model), seed=1)
    assert (_dropped(tc, x) > 0) == overflow
    want = _jax_moe(jm, jnp.asarray(x), jc)
    got = M.moe_apply(tm, torch.from_numpy(x), tc)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_capacity_counts_every_row():
    """C = max(ceil(T·k/E · factor), 1) over T = B·S rows, padding
    included; an overflowing assignment goes to the drop slot C of expert
    0, and positions are ranks in token order (a stable sort)."""
    _, tc, _, _ = _layer()
    assert M.capacity(1, tc) == 1 and M.capacity(12, tc) == 8
    assert M.capacity(3 * 8, dataclasses.replace(tc, capacity_factor=1.0)) \
        == 12
    flat = torch.tensor([2, 0, 2, 2, 1, 2, 0])
    expert, slot, keep = M._slots(flat, 4, 2)
    assert slot.tolist() == [0, 0, 1, 2, 0, 2, 1]
    assert keep.tolist() == [True, True, True, False, True, False, True]
    assert expert.tolist() == [2, 0, 2, 0, 1, 0, 0]


def test_moe_gradients_match_jax_grad():
    """Gradients of Σ moe_apply(x) · c for the router, the three expert
    leaves and x, at a capacity where experts overflow."""
    jc, tc, jm, tm = _layer()
    jc, tc = (dataclasses.replace(c, capacity_factor=1.0) for c in (jc, tc))
    x, c = _x((2, 12, tc.d_model), 2), _x((2, 12, tc.d_model), 3)
    assert _dropped(tc, x) > 0
    jg = jax.jit(jax.grad(lambda p, xx: jnp.sum(_jax_moe(p, xx, jc) * c),
                          argnums=(0, 1)))(jm, jnp.asarray(x))
    live = {k: v.clone().requires_grad_() for k, v in tm.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = torch.sum(M.moe_apply(live, xt, tc) * torch.from_numpy(c))
    grads = torch.autograd.grad(out, [live[k] for k in LEAVES] + [xt])
    for name, g in zip(LEAVES + ("x",), grads):
        want = jg[1] if name == "x" else jg[0][name]
        assert float(jnp.abs(want).max()) > 0, name
        _close(g.numpy(), want)


def test_load_balance_loss_matches_reference():
    jc, tc, jm, tm = _layer()
    x = _x((3, 10, tc.d_model), 4)
    want = float(JM.load_balance_loss(jm, jnp.asarray(x), jc))
    got = M.load_balance_loss(tm, torch.from_numpy(x), tc)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6


@pytest.mark.parametrize("name", sorted(set(jax_list_configs())
                                        | set(list_configs())))
def test_param_counts_match_reference(name):
    """Every config of both registries (the reference's through the port's
    field-for-field identical dataclass); the port's own configs equal the
    reference's."""
    jc = jax_get_config(name)
    tc = ModelConfig(**dataclasses.asdict(jc))
    if name in list_configs():
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    r = ModelConfig(**dataclasses.asdict(jax_reduced(jc)))
    assert r.param_count() == jax_reduced(jc).param_count()
    assert r.active_param_count() == jax_reduced(jc).active_param_count()


def test_moe_sizes():
    mix, qwen = get_config("mixtral-8x7b"), get_config(ARCH)
    assert round(mix.param_count() / 1e9, 1) == 46.7
    assert round(qwen.param_count() / 1e9, 1) == 30.5
    assert round(2 * qwen.param_count() / 1e9, 1) == 61.1    # bf16 GB
    assert qwen.active_param_count() < qwen.param_count() / 8


def test_expert_leaves_start_at_the_references_scale():
    """The reference's dense_init takes fan_in = shape[0]: E for an (E, d,
    f) expert leaf, so its experts start at std 1/√E; the router (d, E) at
    1/√d."""
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32",
                              num_layers=1)
    moe = T.init_params(cfg, seed=0, device="cpu")["blocks"]["l0"]["moe"]
    E, d = cfg.num_experts, cfg.d_model
    for k in ("w_gate", "w_in", "w_out"):
        assert moe[k].shape[1] == E
        assert abs(float(moe[k].std()) - 1 / np.sqrt(E)) < 0.01, k
    assert moe["router"].dtype == torch.float32
    assert abs(float(moe["router"].std()) - 1 / np.sqrt(d)) < 0.005
    jm = JM.init_moe(jax.random.PRNGKey(0), jax_reduced(
        jax_get_config(ARCH)))
    for k in ("w_gate", "w_in", "w_out"):
        assert abs(float(jnp.std(jm[k].astype(jnp.float32)))
                   - 1 / np.sqrt(E)) < 0.01, k


def test_expert_parallelism_names_its_roadmap_item():
    _, tc, _, tm = _layer()
    assert M.ep_applicable(tc, None) is False
    assert M.ep_applicable(dataclasses.replace(tc, num_experts=0),
                           object()) is False
    with pytest.raises(NotImplementedError, match="A15"):
        M.ep_applicable(tc, object())
    with pytest.raises(NotImplementedError, match="A15"):
        M.moe_apply_ep(tm, torch.zeros(1, 2, tc.d_model), tc, object())
