"""Port parity of the sharding plans where the tensor ranks do not divide
the query heads or the experts, across 4 ranks against the JAX package's
same plans at 4 devices (as ``test_torch_plans.py``: 4 ``gloo`` ranks on a
(2, 2) ("data", "model") ``DeviceMesh``; the oracle under ``run_multidev``
on a mesh from ``repro.launch.mesh._make_mesh``; params from the JAX
``init_params``, batches made once and handed to both through an npz; both
launches at once).

Cases (reduced f32 configs, batch 4 x 32):
  * yi-9b with 2 query heads and 1 kv head under tp: 2 heads over 4 tensor
    ranks. Attention splits the heads over 'data' and the batch over
    'model'; the projections' columns split over both, within a head.
  * qwen3-moe with 6 experts under tp: the experts' F dim splits over the
    4 tensor ranks, every rank runs every expert on its own columns.
  * qwen3-moe with 3 experts under dp_tp: the F dim splits over 'model',
    and the dispatch buffer's capacity over 'data'.

Each runs 3 Adam steps (lr 1e-3) and, from the same params, 2 SGD steps
(lr 0.5); the MoE configs at capacity factor 1.0, where assignments
drop. Tolerances (float32), as test_torch_plans.py's: losses rtol 1e-5;
params after the SGD steps atol 1e-5."""
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
from test_torch_plans import _flat, _hold

pytestmark = pytest.mark.port

STEPS, SGD_STEPS, B, S = 3, 2, 4, 32
OPTS = {"adam": dict(lr=1e-3), "sgd": dict(lr=0.5)}
# name: (arch, config changes, plan)
CASES = {
    "yi2": ("yi-9b", dict(num_heads=2, num_kv_heads=1), "tp"),
    "moe6": ("qwen3-moe-30b-a3b", dict(num_experts=6, capacity_factor=1.0),
             "tp"),
    "moe3": ("qwen3-moe-30b-a3b", dict(num_experts=3, capacity_factor=1.0),
             "dp_tp"),
}

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
z = np.load({npz!r})
OPTS = {opts!r}
CASES = {cases!r}
out = {{}}
"""

JAX_CODE = COMMON + """
import jax, jax.numpy as jnp
from repro.configs.base import get_config, reduced
from repro.core import parallelism as par
from repro.launch.mesh import _make_mesh
from repro.optim import make_optimizer
from repro.train import trainer
mesh = _make_mesh((2, 2), ("data", "model"))
def train(cfg, prefix, plan_name, opt_name, steps):
    plan = par.make_plan(plan_name, mesh)
    params = jax.tree.map(jnp.asarray, unflat(z, prefix))
    opt = make_optimizer(opt_name, **OPTS[opt_name])
    tag = prefix if opt_name == "adam" else prefix + "_" + opt_name
    state = {{"params": params, "opt": opt.init(params)}}
    state = jax.device_put(state, trainer.state_shardings(state, plan))
    f = jax.jit(trainer.make_train_step(cfg, opt, plan))
    losses = []
    for i in range(steps):
        batch = {{"tokens": z["tokens"][i], "labels": z["labels"][i]}}
        batch = jax.device_put(batch, plan.batch_shardings(batch))
        state, m = f(state, batch)
        losses.append(float(m["loss"]))
    out[tag + "/" + plan_name + "/loss"] = np.array(losses)
    for p, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
        key = "/".join(k.key for k in p)
        out[tag + "/" + plan_name + "/" + key] = np.asarray(v)
for name, (arch, kw, plan) in CASES.items():
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              **kw)
    train(cfg, name, plan, "adam", {steps})
    train(cfg, name, plan, "sgd", {sgd_steps})
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
def train(cfg, prefix, plan_name, opt_name, steps):
    plan = par.make_plan(plan_name, mesh)
    params = params_from_jax(unflat(z, prefix), cfg, "cpu")
    opt = make_optimizer(opt_name, **OPTS[opt_name])
    tag = prefix if opt_name == "adam" else prefix + "_" + opt_name
    state = {{"params": params, "opt": opt.init(params)}}
    step, state, _ = trainer.jit_train_step(cfg, opt, plan, state)
    losses = []
    for i in range(steps):
        batch = {{"tokens": z["tokens"][i], "labels": z["labels"][i]}}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out[tag + "/" + plan_name + "/loss"] = np.array(losses)
    for p, v in leaves_with_path(state["params"]):
        out[tag + "/" + plan_name + "/" + "/".join(p)] = \\
            par.full(v).numpy()
for name, (arch, kw, plan) in CASES.items():
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              **kw)
    train(cfg, name, plan, "adam", {steps})
    train(cfg, name, plan, "sgd", {sgd_steps})
np.savez(os.path.join(OUT, f"rank{{RANK}}.npz"), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("uneven_plans")
    rng = np.random.default_rng(0)
    arrays = {}
    for i, (name, (arch, kw, _)) in enumerate(CASES.items()):
        cfg = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                  dtype="float32", **kw)
        arrays.update(_flat(name, JT.init_params(cfg,
                                                 jax.random.PRNGKey(i))))
    vocab = jax_reduced(jax_get_config("yi-9b")).vocab_size
    arrays["tokens"] = rng.integers(0, vocab, (STEPS, B, S), dtype=np.int32)
    arrays["labels"] = rng.integers(0, vocab, (STEPS, B, S), dtype=np.int32)
    np.savez(d / "inputs.npz", **arrays)
    fmt = dict(npz=str(d / "inputs.npz"), opts=OPTS, cases=CASES,
               steps=STEPS, sgd_steps=SGD_STEPS)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_multidev, JAX_CODE.format(
            out=str(d / "jax.npz"), **fmt), devices=4, timeout=420)
        port_run = pool.submit(run_ranks, PORT_CODE.format(**fmt), 4, d,
                               timeout=420)
        jax_run.result()
        port_run.result()
    return (dict(np.load(d / "jax.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_uneven_plan_matches_jax_same_plan(runs, name):
    want, ranks = runs
    plan = CASES[name][2]
    assert np.all(np.isfinite(want[f"{name}/{plan}/loss"]))
    _hold(want, ranks, name, plan, plan)
