"""The recurrent and hybrid families' training under the sharding plans:
reduced f32 rwkv6-7b and zamba2-2.7b, 2 SGD steps (lr 0.1) under dp, dp_tp
and dp_tp_sp. The port runs 4 ``gloo`` ranks on a (2, 2) ("data",
"model") ``DeviceMesh`` (``run_ranks``); the oracle is the JAX package's
``make_train_step(cfg, opt, plan)`` of the same plan under ``run_multidev``
at 4 fake devices on a mesh made by ``repro.launch.mesh._make_mesh`` (Auto
axes), on a state placed by ``state_shardings``. Params (the JAX
``init_params``) and batches are made once in the test process and handed
to both sides through an npz; both launches run at once. Each planned
port step is also held to the unplanned port step from the same params.

The scans run on each rank's own heads through ``parallelism.local_call``.
An argument replicated over a mesh dim on which the scan's results are
split (rwkv6's bonus ``u`` over the batch ranks; Mamba2's B and C, shared
by the heads, over the head ranks) takes a gradient that is a partial sum
over that dim: before it was summed there, every rank kept its own share
(rwkv6's ``u`` was 7.8 off after one step; zamba2's ``conv_w`` 8e-3 after
two). Under dp_tp rwkv6's channel mix and decay LoRA take ``cm_r`` and
``w_lora_b`` split by column, their gradients gathered.

For zamba2 the JAX oracle runs with ``repro.models.ssm._ssd_chunk``
replaced by the masked-exponent form of test_torch_recurrent_train.py
(the reference's own gives non-finite gradients; no file of the reference
is edited).

SGD runs at lr 0.1, as test_torch_recurrent_train.py's rwkv6 steps do:
at lr 0.5 the reference's own rwkv6 plans differ from each other by up to
1.0e-3 after two steps (embedding rows; dp_tp against dp), and the port
from each by as much, planned or not; at 0.1 by 1e-5.

Tolerances (float32): losses rtol 1e-5; params atol 1e-4 (the largest
difference, rwkv6's embedding rows against the reference's dp step, is
1.4e-5); every rank's params equal rank 0's.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest

from conftest import run_multidev
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import transformer as JT
from test_torch_collectives import run_ranks

pytestmark = pytest.mark.port

ARCHS = ("rwkv6-7b", "zamba2-2.7b")
PLANS = ("dp", "dp_tp", "dp_tp_sp")
STEPS, B, S, LR = 2, 4, 64, 0.1

COMMON = """
import dataclasses
import numpy as np
def unflat(z, prefix):
    tree = {{}}
    for k in z.files:
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        *head, last = k[len(prefix) + 1:].split("/")
        for h in head:
            node = node.setdefault(h, {{}})
        node[last] = z[k]
    return tree
def params_of(arch):
    # with its empty layers: zamba2's shared-attention position holds no
    # params, so the npz has no entry for it
    tree = unflat(z, arch)
    tree["blocks"] = {{str(k): tree["blocks"].get(str(k), {{}})
                      for k in z[arch + ":blocks"]}}
    return tree
z = np.load({npz!r})
LR = {lr!r}
"""

JAX_CODE = COMMON + """
import jax, jax.numpy as jnp
from repro.configs.base import get_config, reduced
from repro.core import parallelism as par
from repro.launch.mesh import _make_mesh
from repro.models import ssm as SSM
from repro.optim import make_optimizer
from repro.train import trainer
def masked_ssd_chunk(xh, Bm, Cm, la, dtv, S0):
    Cl = xh.shape[0]
    tri = jnp.tril(jnp.ones((Cl, Cl), bool))
    G = jnp.exp(jnp.where(tri, la[:, None] - la[None, :], -jnp.inf))
    M = (Cm @ Bm.T) * G * dtv[None, :]
    y = M @ xh + jnp.exp(la)[:, None] * (Cm @ S0.T)
    w_end = jnp.exp(la[-1] - la) * dtv
    S1 = jnp.exp(la[-1]) * S0 + jnp.einsum("c,ch,cs->hs", w_end, xh, Bm)
    return y, S1
SSM._ssd_chunk = masked_ssd_chunk
mesh = _make_mesh((2, 2), ("data", "model"))
out = {{}}
for arch in {archs!r}:
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    for name in {plans!r}:
        tag = arch + "/" + name
        try:
            plan = par.make_plan(name, mesh)
            params = jax.tree.map(jnp.asarray, params_of(arch))
            opt = make_optimizer("sgd", lr=LR)
            state = {{"params": params, "opt": opt.init(params)}}
            state = jax.device_put(state, trainer.state_shardings(state,
                                                                  plan))
            f = jax.jit(trainer.make_train_step(cfg, opt, plan))
            losses = []
            for t in z[arch + ":tokens"]:
                batch = {{"tokens": t[:, :-1], "labels": t[:, 1:]}}
                state, m = f(state, jax.device_put(
                    batch, plan.batch_shardings(batch)))
                losses.append(float(m["loss"]))
        except Exception as e:
            out[tag + "/error"] = np.array(type(e).__name__)
            continue
        out[tag + "/loss"] = np.array(losses)
        for p, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
            out[tag + "/" + "/".join(k.key for k in p)] = np.asarray(v)
np.savez({out!r}, **out)
print("PASS")
"""

PORT_CODE = COMMON + """
import logging, warnings
warnings.filterwarnings("ignore")
logging.disable(logging.WARNING)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import parallelism as par
from repro_torch.optim import make_optimizer
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path
torch.set_num_threads(1)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {{}}
for arch in {archs!r}:
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    for plan in (None,) + {plans!r}:
        params = params_from_jax(params_of(arch), cfg, "cpu")
        opt = make_optimizer("sgd", lr=LR)
        state = {{"params": params, "opt": opt.init(params)}}
        if plan is None:
            step = trainer.make_train_step(cfg, opt)
        else:
            step, state, _ = trainer.jit_train_step(
                cfg, opt, par.make_plan(plan, mesh), state)
        losses = []
        for t in z[arch + ":tokens"]:
            state, m = step(state, {{"tokens": t[:, :-1],
                                     "labels": t[:, 1:]}})
            losses.append(float(m["loss"]))
        tag = arch + "/" + (plan or "none")
        out[tag + "/loss"] = np.array(losses)
        for p, v in leaves_with_path(state["params"]):
            out[tag + "/" + "/".join(p)] = par.full(v).numpy()
np.savez(OUT + "/rank%d.npz" % RANK, **out)
"""


def _flat(prefix, tree):
    return {prefix + "/" + "/".join(k.key for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's outputs, each port rank's outputs)."""
    d = tmp_path_factory.mktemp("recurrent_plans")
    rng = np.random.default_rng(0)
    arrays = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                  dtype="float32")
        params = JT.init_params(cfg, jax.random.PRNGKey(0))
        arrays.update(_flat(arch, params))
        arrays[arch + ":blocks"] = np.array(list(params["blocks"]))
        arrays[arch + ":tokens"] = rng.integers(
            0, cfg.vocab_size, (STEPS, B, S + 1), dtype=np.int32)
    np.savez(d / "inputs.npz", **arrays)
    fmt = dict(npz=str(d / "inputs.npz"), archs=ARCHS, plans=PLANS, lr=LR)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_multidev, JAX_CODE.format(
            out=str(d / "jax.npz"), **fmt), devices=4, timeout=300)
        port_run = pool.submit(run_ranks, PORT_CODE.format(**fmt), 4, d,
                               timeout=300)
        jax_run.result()
        port_run.result()
    return (dict(np.load(d / "jax.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(4)])


def _params(out, tag):
    return {k[len(tag):]: v for k, v in out.items()
            if k.startswith(tag) and not k.endswith("/loss")}


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_planned_training_equals_unplanned(runs, arch, plan):
    ranks = runs[1]
    out = ranks[0]
    np.testing.assert_allclose(out[f"{arch}/{plan}/loss"],
                               out[f"{arch}/none/loss"], rtol=1e-5)
    want = _params(out, f"{arch}/none/")
    got = _params(out, f"{arch}/{plan}/")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    for other in ranks[1:]:
        for k, v in _params(other, f"{arch}/{plan}/").items():
            np.testing.assert_array_equal(v, got[k], err_msg=k)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_planned_training_matches_jax_same_plan(runs, arch, plan):
    want, ranks = runs
    assert f"{arch}/{plan}/error" not in want, want.get(
        f"{arch}/{plan}/error")
    wp = _params(want, f"{arch}/{plan}/")
    assert len(wp) > 10
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{arch}/{plan}/loss"],
                                   want[f"{arch}/{plan}/loss"], rtol=1e-5,
                                   err_msg=f"rank {r}")
        got = _params(out, f"{arch}/{plan}/")
        assert sorted(got) == sorted(wp)
        for k in wp:
            np.testing.assert_allclose(got[k], wp[k], rtol=0, atol=1e-4,
                                       err_msg=f"{k} rank {r}")
