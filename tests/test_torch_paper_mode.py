"""Port parity of the paper-mode trainer (``repro_torch.train.trainer.
make_paper_train_step``: explicit data-parallel SGD with a survey §2.5
allreduce schedule and §6.3 gradient compression with error feedback)
against the JAX ``make_paper_train_step`` under ``shard_map`` at 4 fake
devices, and the launcher's ``--paper-mode`` in-process.

The params (the JAX ``init_params``) and batches (the JAX ``SyntheticLM``,
whose seeding differs between processes) are made once in the test process
and handed to both sides through an npz. The port runs 4 ``gloo`` ranks
(``run_ranks``: a FileStore under the test's directory, a time limit per
launch and a collective timeout per rank).

Tolerances (float32, 5 SGD steps): losses rtol 1e-5 (the two packages'
per-shard gradients sum the same products in another order; the ring and
butterfly sums then agree bit for bit); params atol 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_multidev
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_dp_group
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path
from test_torch_collectives import run_ranks

pytestmark = pytest.mark.port

CFG = dict(name="t", family="dense", num_layers=1, d_model=32, num_heads=2,
           num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=32, loss_chunk=32,
           attn_chunk=32, remat=False, dtype="float32")
ALGS = ["ring", "butterfly"]
COMPRESS = ["none", "onebit", "topk"]
STEPS = 5

JAX_CODE = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig
from repro.core.compression import make_compressor
from repro.launch.mesh import make_host_mesh
from repro.optim import make_optimizer
from repro.train import trainer
cfg = ModelConfig(**{cfg!r})
z = np.load({params!r})
params = {{}}
for k in z.files:
    node = params
    *head, last = k.split("/")
    for h in head:
        node = node.setdefault(h, {{}})
    node[last] = jnp.asarray(z[k])
b = np.load({batches!r})
mesh = make_host_mesh((4,), ('data',))
out = {{}}
for alg in {algs!r}:
    for comp in {compress!r}:
        opt = make_optimizer('sgd', lr=1e-2)
        c = None if comp == 'none' else make_compressor(comp)
        f = jax.jit(trainer.make_paper_train_step(cfg, opt, mesh,
                                                  algorithm=alg,
                                                  compression=c))
        state = {{'params': params, 'opt': opt.init(params)}}
        res = (trainer.zero_residual(params) if c
               else {{'_': jnp.zeros((1,), jnp.float32)}})
        losses = []
        for i in range({steps}):
            batch = {{'tokens': b['tokens'][i], 'labels': b['labels'][i]}}
            state, m, res = f(state, batch, res)
            losses.append(float(m['loss']))
        out[f'{{alg}}/{{comp}}/loss'] = np.array(losses)
        for p, v in jax.tree_util.tree_flatten_with_path(state['params'])[0]:
            key = '/'.join(k.key for k in p)
            out[f'{{alg}}/{{comp}}/{{key}}'] = np.asarray(v)
np.savez({out!r}, **out)
print('PASS')
"""

PORT_CODE = """
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import make_compressor
from repro_torch.optim import make_optimizer
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path
cfg = ModelConfig(**{cfg!r})
z = np.load(os.path.join(OUT, "params.npz"))
tree = {{}}
for k in z.files:
    node = tree
    *head, last = k.split("/")
    for h in head:
        node = node.setdefault(h, {{}})
    node[last] = z[k]
b = np.load(os.path.join(OUT, "batches.npz"))
out = {{}}
for alg in {algs!r}:
    for comp in {compress!r}:
        opt = make_optimizer("sgd", lr=1e-2)
        c = None if comp == "none" else make_compressor(comp)
        params = params_from_jax(tree, cfg, "cpu")
        state = {{"params": params, "opt": opt.init(params)}}
        step = trainer.make_paper_train_step(cfg, opt, group, algorithm=alg,
                                             compression=c)
        res = trainer.zero_residual(params) if c else None
        losses = []
        for i in range({steps}):
            batch = {{"tokens": b["tokens"][i], "labels": b["labels"][i]}}
            state, m, res = step(state, batch, res)
            losses.append(float(m["loss"]))
        out[f"{{alg}}/{{comp}}/loss"] = np.array(losses)
        for p, v in leaves_with_path(state["params"]):
            out[f"{{alg}}/{{comp}}/" + "/".join(p)] = v.numpy()
try:
    step(state, {{"tokens": b["tokens"][0][:6], "labels": b["labels"][0][:6]}},
         res)
    raise AssertionError("a batch of 6 rows ran on 4 ranks")
except ValueError:
    pass
np.savez(os.path.join(OUT, f"rank{{RANK}}.npz"), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("paper")
    jp = JT.init_params(JaxModelConfig(**CFG), jax.random.PRNGKey(0))
    flat = {"/".join(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    np.savez(d / "params.npz", **flat)
    batches = list(JaxSyntheticLM(CFG["vocab_size"], 32, noise=0.05)
                   .batches(8, STEPS))
    np.savez(d / "batches.npz",
             tokens=np.stack([b["tokens"] for b in batches]),
             labels=np.stack([b["labels"] for b in batches]))
    fmt = dict(cfg=CFG, algs=ALGS, compress=COMPRESS, steps=STEPS)
    run_multidev(JAX_CODE.format(params=str(d / "params.npz"),
                                 batches=str(d / "batches.npz"),
                                 out=str(d / "jax.npz"), **fmt),
                 devices=4, timeout=300)
    run_ranks(PORT_CODE.format(**fmt), 4, d, timeout=180)
    return (dict(np.load(d / "jax.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("comp", COMPRESS)
@pytest.mark.parametrize("alg", ALGS)
def test_four_ranks_match_the_jax_paper_step(runs, alg, comp):
    want, ranks = runs
    keys = [k for k in want if k.startswith(f"{alg}/{comp}/")]
    assert len(keys) > 2
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{alg}/{comp}/loss"],
                                   want[f"{alg}/{comp}/loss"], rtol=1e-5,
                                   err_msg=f"rank {r}")
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                       err_msg=f"{k} rank {r}")
            # the replicas stay equal: every rank applies the same average
            np.testing.assert_array_equal(got[k], ranks[0][k])


def test_one_rank_paper_step_equals_the_plain_step():
    """At one rank the allreduce returns each gradient and the mean divides
    by 1, so the paper step without compression is the plain step."""
    cfg = ModelConfig(**CFG)
    jp = JT.init_params(JaxModelConfig(**CFG), jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jp)
    batches = list(JaxSyntheticLM(CFG["vocab_size"], 32).batches(4, 3))
    group = make_dp_group("cpu")
    try:
        sides = []
        for paper in (False, True):
            opt = make_optimizer("adam", lr=1e-2, grad_clip=1.0)
            params = params_from_jax(tree, cfg, "cpu")
            state = {"params": params, "opt": opt.init(params)}
            losses = []
            if paper:
                step = trainer.make_paper_train_step(cfg, opt, group)
                for b in batches:
                    state, m, res = step(state, b, None)
                    assert res is None
                    losses.append(float(m["loss"]))
            else:
                step = trainer.make_train_step(cfg, opt)
                for b in batches:
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
            sides.append((losses, state["params"]))
    finally:
        dist.destroy_process_group()
    assert sides[0][0] == sides[1][0]
    for (p, a), (_, b) in zip(leaves_with_path(sides[0][1]),
                              leaves_with_path(sides[1][1])):
        assert torch.equal(a, b), p


def test_zero_residual_is_f32_zeros_of_every_param():
    cfg = dataclasses.replace(ModelConfig(**CFG), dtype="bfloat16")
    params = T.init_params(cfg, seed=0, device="cpu")
    res = trainer.zero_residual(params)
    pairs = list(zip(leaves_with_path(params), leaves_with_path(res)))
    assert len(pairs) > 3
    for (pp, p), (rp, r) in pairs:
        assert pp == rp and r.shape == p.shape and r.dtype == torch.float32
        assert not r.any()


@pytest.mark.parametrize("compress", ["int8", "none"])
def test_launcher_paper_mode_trains_in_process(compress, capsys, tmp_path):
    ck = str(tmp_path / "paper.npz")
    state = launcher.main(["--arch", "yi-9b", "--preset", "reduced",
                           "--batch", "2", "--seq", "64", "--steps", "2",
                           "--log-every", "1", "--device", "cpu",
                           "--paper-mode", "--algorithm", "ring",
                           "--compress", compress, "--checkpoint", ck])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert state["opt"]["step"] == 2 and f"saved {ck}" in out
    assert not dist.is_initialized()          # the launcher's group is gone
