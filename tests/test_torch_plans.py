"""Port parity of the sharding plans (``repro_torch.core.parallelism`` on
DTensor) across 4 ranks against the JAX package's same plans at 4 devices.

The port runs 4 ``gloo`` ranks (``run_ranks``: a FileStore under the
test's directory, a time limit per launch, a collective timeout per rank)
on a (2, 2) ("data", "model") ``DeviceMesh`` (a (4,) "stage" mesh for the
pipeline). The oracle runs under ``run_multidev`` at 4 fake devices on
meshes made by ``repro.launch.mesh._make_mesh`` (Auto axes: on jax 0.9 an
Explicit-axis mesh refuses the reference's sharding constraints). Params
(the JAX ``init_params``), batches and inputs are made once in the test
process and handed to both sides through an npz. Both launches run at
once, each once for the whole file.

Cases (reduced f32 configs, batch 4 x 32):
  * yi-9b, under every plan against JAX's ``make_train_step
    (cfg, opt, plan)`` on a state placed by ``state_shardings``. dp_tp_seq
    names 'data' for the batch and the sequence; JAX refuses that
    constraint (``DuplicateSpecError``, asserted), the port keeps the axis
    for the batch, which is dp_tp's constraint, so it is held to JAX's
    dp_tp.
  * qwen3-moe at capacity factor 1.0 with an overflow asserted: under
    dp_tp the experts split over 'model' (expert parallelism, per-shard
    capacity) against JAX's EP step; under dp against JAX's dp step
    (global capacity).
  * ``moe_apply_ep`` alone: the forward at capacity factor 1.0 against
    JAX's; at factor 8 (nothing dropped) its gradients against the
    unplanned ``moe_apply``'s, which catches a backward summed ``ep``
    times.
  * ``pipeline_forward``, 4 stages x 8 microbatches, against JAX's and the
    sequential stack; the hops counted are M + S - 1.
  * B6's ``local_map`` route: a dp_tp step with ``attention._attend_full``
    pointed at ``ops.flash_attention`` (its CPU branch is the plain
    version), which must see plain local tensors.
  * ``jit_serve_step`` under dp_tp against the unplanned step and JAX's
    ``jit_serve_step``; ``Engine(plan="dp_tp")`` tokens against the
    unplanned engine's and the JAX ``Engine(plan=)``'s.
  * The launcher's ``--plan dp_tp --tp 2`` at 4 ranks (finite losses, equal
    params on every rank), and at one rank, where ``dp_tp`` falls back to
    ``dp``, equal to the unplanned launcher; ``--plan dp_tp_zero1`` at one
    rank (a (1, 1) mesh) close to it.

Each training case runs 3 Adam steps (lr 1e-3) and, from the same params,
2 SGD steps (lr 0.5). Tolerances (float32): losses rtol 1e-5; params after
the SGD steps atol 1e-5. The params after Adam are not held: Adam moves a
weight by about lr·sign(g), so where a gradient sums to near its rounding
noise the two packages' reduction orders move it differently (1 of yi-9b's
131,072 ``wq`` elements differs by 7.4e-4, most of a step; as in
test_torch_train.py, params are held under SGD); logits atol 1e-4; the EP
layer and its gradients rtol 1e-5 with atol 1e-5 · max(1, max|ref|) (its
outputs reach ~1e3: the experts start at std 1/√E); the pipeline rtol
2e-4, atol 2e-5 (as test_pipeline.py); tokens equal.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import run_multidev
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.launch import train as launcher
from test_torch_collectives import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

PLANS = ("dp", "tp", "dp_tp", "dp_tp_zero1", "dp_tp_seq", "dp_tp_sp",
         "dp_tp_sp_zero1")
MOE_PLANS = ("dp_tp", "dp")
STEPS, SGD_STEPS, B, S = 3, 2, 4, 32
OPTS = {"adam": dict(lr=1e-3), "sgd": dict(lr=0.5)}
PROMPTS = (5, 12, 17, 9)
NEW = 6
SERVE_STEPS = 4

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
PROMPTS = [z["prompt%d" % i] for i in range({n_prompts})]
"""

JAX_CODE = COMMON + """
import jax, jax.numpy as jnp
from repro.configs.base import get_config, reduced
from repro.core import parallelism as par
from repro.core.pipeline import pipeline_forward
from repro.launch.mesh import _make_mesh
from repro.models import moe as M
from repro.models import transformer as T
from repro.optim import make_optimizer
from repro.serving import serve
from repro.serving.engine import Engine, EngineConfig
from repro.train import trainer
mesh = _make_mesh((2, 2), ("data", "model"))
yi = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
moe = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                          dtype="float32", capacity_factor=1.0)
out = {{}}
def train(cfg, prefix, plan_name, opt_name="adam", steps={steps}):
    plan = par.make_plan(plan_name, mesh)
    params = jax.tree.map(jnp.asarray, unflat(z, prefix))
    opt = make_optimizer(opt_name, **OPTS[opt_name])
    prefix = prefix if opt_name == "adam" else prefix + "_" + opt_name
    state = {{"params": params, "opt": opt.init(params)}}
    state = jax.device_put(state, trainer.state_shardings(state, plan))
    f = jax.jit(trainer.make_train_step(cfg, opt, plan))
    losses = []
    for i in range(steps):
        batch = {{"tokens": z["tokens"][i], "labels": z["labels"][i]}}
        batch = jax.device_put(batch, plan.batch_shardings(batch))
        state, m = f(state, batch)
        losses.append(float(m["loss"]))
    out[prefix + "/" + plan_name + "/loss"] = np.array(losses)
    for p, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
        key = "/".join(k.key for k in p)
        out[prefix + "/" + plan_name + "/" + key] = np.asarray(v)
for name in {plans!r}:
    try:
        train(yi, "yi", name)
        train(yi, "yi", name, "sgd", {sgd_steps})
    except Exception as e:
        out["yi/" + name + "/error"] = np.array(type(e).__name__)
for name in {moe_plans!r}:
    train(moe, "moe", name)
    train(moe, "moe", name, "sgd", {sgd_steps})
# moe_apply_ep alone, forward at capacity factor 1.0
plan = par.make_plan("dp_tp", mesh)
lp = jax.tree.map(jnp.asarray, unflat(z, "ep"))
out["ep/fwd"] = np.asarray(jax.jit(lambda p, x: M.moe_apply_ep(
    p, x, moe, plan))(lp, jnp.asarray(z["ep_x"])))
# pipeline, 4 stages x 8 microbatches
smesh = _make_mesh((4,), ("stage",))
def stage_fn(p, x):
    return jnp.tanh(x @ p["w"][0] + p["b"][0]) if p["w"].ndim == 3 \\
        else jnp.tanh(x @ p["w"] + p["b"])
out["pipe"] = np.asarray(pipeline_forward(
    stage_fn, {{"w": jnp.asarray(z["pipe_w"]), "b": jnp.asarray(z["pipe_b"])}},
    jnp.asarray(z["pipe_x"]), smesh))
# serving: the planned one-token step and the planned engine
params = jax.tree.map(jnp.asarray, unflat(z, "yi"))
cache = T.init_decode_state(yi, {b}, {serve_len})
inputs = {{"token": jnp.asarray(z["serve_tokens"][0])}}
step = serve.jit_serve_step(yi, plan, params, cache, inputs)
for i in range({serve_steps}):
    lg, cache = step(params, cache, {{"token": jnp.asarray(
        z["serve_tokens"][i])}}, jnp.int32(i))
    out["serve/%d" % i] = np.asarray(lg)
eng = Engine(yi, params, EngineConfig(**{engine_kw!r}), plan=plan)
rids = [eng.add_request(p, {new}) for p in PROMPTS]
outs = eng.drain()
for i, r in enumerate(rids):
    out["engine/%d" % i] = np.asarray(outs[r])
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
from repro_torch.core import pipeline as PL
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch import train as launcher
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.serving import serve
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path
torch.set_num_threads(1)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
yi = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
moe = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                          dtype="float32", capacity_factor=1.0)
out = {{}}
# an overflow must occur: spy on the slot assignment (under EP the last
# expert id is the discard bin, not an expert)
drops = {{"n": 0}}
_slots = M._slots
def spy(flat_e, E, C):
    expert, slot, keep = _slots(flat_e, E, C)
    real = flat_e < E - 1 if par.current_plan() is not None and \\
        M.ep_applicable(moe, par.current_plan()) else torch.ones_like(keep)
    drops["n"] += int(torch.sum(real & ~par.full(keep)))
    return expert, slot, keep
M._slots = spy
def train(cfg, prefix, plan_name, opt_name="adam", steps={steps}, tag=None):
    tag = tag or (prefix if opt_name == "adam" else prefix + "_" + opt_name)
    plan = par.make_plan(plan_name, mesh)
    params = params_from_jax(unflat(z, prefix), cfg, "cpu")
    opt = make_optimizer(opt_name, **OPTS[opt_name])
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
for name in {plans!r}:
    train(yi, "yi", name)
    train(yi, "yi", name, "sgd", {sgd_steps})
for name in {moe_plans!r}:
    drops["n"] = 0
    train(moe, "moe", name)
    out["moe/" + name + "/drops"] = np.array(drops["n"])
    train(moe, "moe", name, "sgd", {sgd_steps})
M._slots = _slots
# moe_apply_ep alone
plan = par.make_plan("dp_tp", mesh)
lp = {{k: torch.from_numpy(v) for k, v in unflat(z, "ep").items()}}
x = torch.from_numpy(z["ep_x"])
dlp = par.shard_tree(lp, plan.param_specs({{"moe": lp}})["moe"], mesh)
dx = par.shard_tree({{"x": x}}, {{"x": par.P("data")}}, mesh)["x"]
with par.plan_context(plan):
    out["ep/fwd"] = par.full(M.moe_apply_ep(dlp, dx, moe, plan)).numpy()
# gradients at capacity factor 8 (nothing dropped) against moe_apply's
wide = dataclasses.replace(moe, capacity_factor=8.0)
dlp = {{k: v.detach().requires_grad_() for k, v in dlp.items()}}
dx = dx.detach().requires_grad_()
ct = par.shard_tree({{"c": torch.from_numpy(z["ep_ct"])}},
                    {{"c": par.P("data")}}, mesh)["c"]
with par.plan_context(plan):
    y = M.moe_apply_ep(dlp, dx, wide, plan)
    (y * ct).sum().backward()
out["ep/fwd8"] = par.full(y).detach().numpy()
out["ep/dx"] = par.full(dx.grad).numpy()
for k, v in dlp.items():
    out["ep/d" + k] = par.full(v.grad).numpy()
# B6's local_map route: the kernel wrapper sees plain local tensors
seen = []
def kernel_route(q, k, v, n_rep, scale, chunk, window):
    seen.append(par.is_dtensor(q) or par.is_dtensor(k))
    return FA.flash_attention(q, k, v, causal=True, window=window)
A._attend_full = kernel_route
train(yi, "yi", "dp_tp", tag="b6")
out["b6/dtensor_seen"] = np.array(any(seen))
out["b6/calls"] = np.array(len(seen))
# pipeline on a (4,) stage mesh
smesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])
out["pipe"] = PL.pipeline_forward(
    stage_fn, {{"w": torch.from_numpy(z["pipe_w"]),
               "b": torch.from_numpy(z["pipe_b"])}},
    torch.from_numpy(z["pipe_x"]), smesh).numpy()
out["pipe/hops"] = np.array(PL.counts["hops"])
# serving
params = params_from_jax(unflat(z, "yi"), yi, "cpu")
cache = T.init_decode_state(yi, {b}, {serve_len}, device="cpu")
step, dparams, dcache, _ = serve.jit_serve_step(
    yi, plan, params, cache, {{"token": torch.from_numpy(
        z["serve_tokens"][0])}})
plain = serve.make_serve_step(yi)
pcache = T.init_decode_state(yi, {b}, {serve_len}, device="cpu")
for i in range({serve_steps}):
    tok = torch.from_numpy(z["serve_tokens"][i])
    lg, dcache = step(dparams, dcache, {{"token": tok}}, i)
    out["serve/%d" % i] = par.full(lg).numpy()
    lg0, pcache = plain(params, pcache, {{"token": tok}}, i)
    out["serve0/%d" % i] = lg0.numpy()
for tag, pl in (("engine", plan), ("engine0", None)):
    eng = Engine(yi, params, EngineConfig(**{engine_kw!r}), plan=pl,
                 device="cpu")
    rids = [eng.add_request(p, {new}) for p in PROMPTS]
    outs = eng.drain()
    for i, r in enumerate(rids):
        out[tag + "/%d" % i] = np.asarray(outs[r])
# the launcher under 4 ranks
state = launcher.main(["--arch", "yi-9b", "--preset", "reduced", "--steps",
                       "2", "--batch", "4", "--seq", "32", "--plan", "dp_tp",
                       "--tp", "2", "--device", "cpu", "--log-every", "1"])
for p, v in leaves_with_path(state["params"]):
    out["launch/" + "/".join(p)] = par.full(v).float().numpy()
np.savez(os.path.join(OUT, f"rank{{RANK}}.npz"), **out)
"""

ENGINE_KW = dict(block_size=8, num_blocks=48, max_blocks_per_seq=6,
                 max_slots=4, prefill_chunk=16)
SERVE_LEN = 8


def _flat(prefix, tree):
    return {prefix + "/" + "/".join(k.key for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("plans")
    yi = dataclasses.replace(jax_reduced(jax_get_config("yi-9b")),
                             dtype="float32")
    moe = dataclasses.replace(jax_reduced(
        jax_get_config("qwen3-moe-30b-a3b")), dtype="float32",
        capacity_factor=1.0)
    rng = np.random.default_rng(0)
    arrays = {**_flat("yi", JT.init_params(yi, jax.random.PRNGKey(0))),
              **_flat("moe", JT.init_params(moe, jax.random.PRNGKey(1))),
              **_flat("ep", JM.init_moe(jax.random.PRNGKey(2), moe))}
    arrays["tokens"] = rng.integers(0, yi.vocab_size, (STEPS, B, S),
                                    dtype=np.int32)
    arrays["labels"] = rng.integers(0, yi.vocab_size, (STEPS, B, S),
                                    dtype=np.int32)
    arrays["ep_x"] = rng.standard_normal((4, 16, moe.d_model)).astype(
        np.float32)
    arrays["ep_ct"] = rng.standard_normal((4, 16, moe.d_model)).astype(
        np.float32)
    arrays["pipe_w"] = (rng.standard_normal((4, 16, 16)) * 0.3).astype(
        np.float32)
    arrays["pipe_b"] = (rng.standard_normal((4, 16)) * 0.1).astype(
        np.float32)
    arrays["pipe_x"] = rng.standard_normal((8, 4, 16)).astype(np.float32)
    arrays["serve_tokens"] = rng.integers(0, yi.vocab_size,
                                          (SERVE_STEPS, B), dtype=np.int32)
    for i, n in enumerate(PROMPTS):
        arrays[f"prompt{i}"] = rng.integers(0, yi.vocab_size, n,
                                            dtype=np.int32)
    np.savez(d / "inputs.npz", **arrays)
    fmt = dict(npz=str(d / "inputs.npz"), n_prompts=len(PROMPTS),
               steps=STEPS, sgd_steps=SGD_STEPS, opts=OPTS, plans=PLANS, moe_plans=MOE_PLANS, b=B,
               serve_len=SERVE_LEN, serve_steps=SERVE_STEPS,
               engine_kw=ENGINE_KW, new=NEW)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_multidev, JAX_CODE.format(
            out=str(d / "jax.npz"), **fmt), devices=4, timeout=420)
        port_run = pool.submit(run_ranks, PORT_CODE.format(**fmt), 4, d,
                               timeout=420)
        jax_run.result()
        port_run.result()
    return (arrays, dict(np.load(d / "jax.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(4)])


def _params(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix) and not k.endswith(("/loss", "/drops"))}


@pytest.mark.parametrize("plan", PLANS)
def test_yi_plans_match_jax_same_plan(runs, plan):
    _, want, ranks = runs
    ref = plan
    if plan == "dp_tp_seq":
        assert str(want["yi/dp_tp_seq/error"]) == "DuplicateSpecError"
        ref = "dp_tp"
    _hold(want, ranks, "yi", plan, ref)


def _hold(want, ranks, model, plan, ref):
    """Adam losses, SGD losses and SGD params of one plan."""
    wp = _params(want, f"{model}_sgd/{ref}/")
    assert len(wp) > 10
    for r, got in enumerate(ranks):
        for opt in ("", "_sgd"):
            np.testing.assert_allclose(got[f"{model}{opt}/{plan}/loss"],
                                       want[f"{model}{opt}/{ref}/loss"],
                                       rtol=1e-5, err_msg=f"rank {r}")
        gp = _params(got, f"{model}_sgd/{plan}/")
        assert set(gp) == set(wp)
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], atol=1e-5, rtol=0,
                                       err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("plan", MOE_PLANS)
def test_moe_plans_match_jax_same_plan(runs, plan):
    """dp_tp engages expert parallelism (per-shard capacity) and dp keeps
    global capacity, each as the JAX step of the same plan does."""
    _, want, ranks = runs
    for got in ranks:
        assert int(got[f"moe/{plan}/drops"]) > 0, "no assignment dropped"
    _hold(want, ranks, "moe", plan, plan)
    # per-shard capacity drops other assignments than global capacity
    assert not np.array_equal(want["moe/dp_tp/loss"], want["moe/dp/loss"])


def _close(got, want, err_msg=""):
    """rtol 1e-5 with atol 1e-5 · max(1, max|want|): the experts start at
    std 1/√E, so the layer's outputs reach ~1e3 on unit inputs."""
    np.testing.assert_allclose(
        got, want, rtol=1e-5,
        atol=1e-5 * max(1.0, float(np.max(np.abs(want)))), err_msg=err_msg)


def test_moe_apply_ep_forward_matches_jax(runs):
    _, want, ranks = runs
    for got in ranks:
        _close(got["ep/fwd"], want["ep/fwd"])


def test_moe_apply_ep_gradients_equal_moe_apply(runs):
    """With nothing dropped EP computes moe_apply; its gradients must be
    moe_apply's (a backward that all-reduced the output's gradient over
    the 2 'model' ranks would double them)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe as M
    arrays, _, ranks = runs
    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                              dtype="float32", capacity_factor=8.0)
    lp = {k[3:]: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in arrays.items() if k.startswith("ep/")}
    x = torch.from_numpy(arrays["ep_x"]).requires_grad_()
    y = M.moe_apply(lp, x, cfg)
    (y * torch.from_numpy(arrays["ep_ct"])).sum().backward()
    for got in ranks:
        _close(got["ep/fwd8"], y.detach().numpy())
        _close(got["ep/dx"], x.grad.numpy())
        for k, v in lp.items():
            _close(got["ep/d" + k], v.grad.numpy(), err_msg=k)


def test_pipeline_matches_jax_and_sequential(runs):
    arrays, want, ranks = runs
    ref = arrays["pipe_x"]
    for s in range(4):
        ref = np.tanh(ref @ arrays["pipe_w"][s] + arrays["pipe_b"][s])
    for got in ranks:
        np.testing.assert_allclose(got["pipe"], ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["pipe"], want["pipe"], rtol=2e-4,
                                   atol=2e-5)
        assert int(got["pipe/hops"]) == 8 + 4 - 1


def test_flash_attention_route_sees_local_tensors(runs):
    _, _, ranks = runs
    for got in ranks:
        assert not bool(got["b6/dtensor_seen"])
        # two layers, three steps
        assert int(got["b6/calls"]) == 2 * STEPS
        np.testing.assert_allclose(got["b6/dp_tp/loss"],
                                   got["yi/dp_tp/loss"], rtol=1e-5)


def test_serve_step_matches_unplanned_and_jax(runs):
    _, want, ranks = runs
    for got in ranks:
        for i in range(SERVE_STEPS):
            np.testing.assert_allclose(got[f"serve/{i}"], got[f"serve0/{i}"],
                                       atol=1e-4, rtol=0)
            np.testing.assert_allclose(got[f"serve/{i}"], want[f"serve/{i}"],
                                       atol=1e-4, rtol=0)


def test_engine_tokens_match_unplanned_and_jax(runs):
    _, want, ranks = runs
    for got in ranks:
        for i in range(len(PROMPTS)):
            np.testing.assert_array_equal(got[f"engine/{i}"],
                                          got[f"engine0/{i}"])
            np.testing.assert_array_equal(got[f"engine/{i}"],
                                          want[f"engine/{i}"])


def test_launcher_plan_dp_tp_on_four_ranks(runs):
    _, _, ranks = runs
    keys = [k for k in ranks[0] if k.startswith("launch/")]
    assert len(keys) > 10
    for got in ranks:
        for k in keys:
            assert np.all(np.isfinite(got[k])), k
            np.testing.assert_array_equal(got[k], ranks[0][k])


def test_launcher_plans_on_one_rank():
    """dp_tp on one rank falls back to dp, the unplanned step; dp_tp_zero1
    runs planned on a one-rank (1, 1) mesh and computes the same step."""
    args = ["--arch", "yi-9b", "--preset", "reduced", "--steps", "2",
            "--batch", "2", "--seq", "32", "--device", "cpu"]
    from repro_torch.core import parallelism as par
    from repro_torch.tree import leaves_with_path
    base = launcher.main(args)
    for plan, atol in (("dp_tp", 0.0), ("dp_tp_zero1", 1e-5)):
        got = launcher.main(args + ["--plan", plan])
        for (p, a), (_, b) in zip(leaves_with_path(base["params"]),
                                  leaves_with_path(got["params"])):
            np.testing.assert_allclose(par.full(b).float().numpy(),
                                       a.float().numpy(),
                                       atol=atol, rtol=0, err_msg=str(p))
