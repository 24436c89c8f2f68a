"""Port parity of the MoE family (reduced mixtral-8x7b: sliding-window
ring layers; reduced qwen3-moe-30b-a3b: full attention; 4 experts, top 2,
f32) against the JAX package on the CPU, with converted weights: the loss
and its gradients, three Adam steps, the serving engine (plain, n-gram
speculation k = 4, int8 pools, one forced preemption), ``serve.generate``
in both prefill modes, and the launcher.

Each path is compared with the SAME path of the reference, never across
paths: an MoE layer's capacity counts every row of the step's padded batch
(inactive slots and padding included), so the engine, the batched and the
loop ``generate`` may drop different assignments and give different
tokens, in the reference too. Every engine case asserts that some
assignment overflowed its expert's capacity.

Tolerances (f32, as test_torch_train.py): loss 1e-5, gradients 2e-6,
Adam losses per step 1e-5; tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import parallelism as par
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serving import serve as JS
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import KVQuantConfig as JaxKVQuantConfig
from repro.serving.engine import OversubConfig as JaxOversubConfig
from repro.serving.engine import SpecConfig as JaxSpecConfig
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as launcher
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.serving import serve as TS
from repro_torch.serving.engine import (Engine, EngineConfig, KVQuantConfig,
                                        OversubConfig, SpecConfig)
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path, tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

ARCHS = ["mixtral-8x7b", "qwen3-moe-30b-a3b"]
ENGINE_KW = dict(block_size=4, num_blocks=64, max_blocks_per_seq=12,
                 max_slots=3, prefill_chunk=8)
SLO_OFF = dict(ttft_slo_s=1e9, tpot_slo_s=1e9)
LENS = (5, 17, 9, 30)            # 30 + 12 passes mixtral's reduced window 32
NEWS = (8, 6, 10, 12)
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jc = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                 dtype="float32")
        tc = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        jp = JT.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        _MODELS[arch] = jc, tc, jp, tp
    return _MODELS[arch]


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.fixture
def drops(monkeypatch):
    """Counts the assignments the port's MoE layers drop."""
    seen = []
    slots = M._slots

    def spy(flat_e, E, C):
        out = slots(flat_e, E, C)
        seen.append(int((~out[2]).sum()))
        return out
    monkeypatch.setattr(M, "_slots", spy)
    return seen


# ------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch, drops):
    """At capacity factor 1.0, where some expert overflows in this batch."""
    jc, tc, jp, tp = _model(arch)
    jc, tc = (dataclasses.replace(c, capacity_factor=1.0) for c in (jc, tc))
    batch = _batch(tc, 2, 64, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, batch)))(jp)
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    paths, leaves = zip(*leaves_with_path(live))
    loss = T.loss_fn(tc, live, {k: torch.from_numpy(v.copy())
                                for k, v in batch.items()})
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert sum(drops) > 0
    jmap = {tuple(k.key for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(jmap) == set(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jmap[path]),
                                   atol=2e-6, rtol=0, err_msg=str(path))
    assert float(np.abs(np.asarray(jmap[("blocks", "l0", "moe",
                                         "router")])).max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adam_steps_match_reference_losses(arch):
    jc, tc, jp, tp = _model(arch)
    batches = [_batch(tc, 4, 64, seed=4 + i) for i in range(3)]
    opt = jax_make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    step = jax.jit(jtrainer.make_train_step(
        jc, opt, par.make_plan("dp", make_host_mesh())))
    state = {"params": jp, "opt": opt.init(jp)}
    want = []
    for b in batches:
        state, m = step(state, b)
        want.append(float(m["loss"]))
    topt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    p = tree_map(lambda t: t.clone(), tp)
    tstate = {"params": p, "opt": topt.init(p)}
    tstep = trainer.make_train_step(tc, topt)
    got = []
    for b in batches:
        tstate, m = tstep(tstate, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_two_steps(arch, capsys):
    state = launcher.main(["--arch", arch, "--preset", "reduced", "--batch",
                           "2", "--seq", "64", "--steps", "2",
                           "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert state["opt"]["step"] == 2


# -------------------------------------------------------------- serving
def _engines(arch, variant):
    jc, tc, jp, tp = _model(arch)
    kw = {"ngram": dict(spec=(JaxSpecConfig(k=4), SpecConfig(k=4))),
          "int8": dict(kv_quant=(JaxKVQuantConfig(), KVQuantConfig())),
          "preempted": dict(oversub=(JaxOversubConfig(**SLO_OFF),
                                     OversubConfig(**SLO_OFF)))}.get(variant,
                                                                     {})
    jeng = JaxEngine(jc, jp, JaxEngineConfig(
        **ENGINE_KW, **{k: v[0] for k, v in kw.items()}))
    teng = Engine(tc, tp, EngineConfig(
        **ENGINE_KW, **{k: v[1] for k, v in kw.items()}), device="cpu")
    return jeng, teng


def _serve(eng, prompts, preempt):
    """Staggered requests; with `preempt`, request 0 is preempted once
    after its second token."""
    rids = []
    for p, m in zip(prompts, NEWS):
        rids.append(eng.add_request(p, m))
        eng.step()
    pending = preempt
    while eng.scheduler.has_work:
        eng.step()
        req = eng.requests[rids[0]]
        if pending and req.state == "decoding" and len(req.out_tokens) >= 2:
            assert eng.preempt_request(rids[0])
            pending = False
    assert not pending
    got = eng.drain()
    return [got[r].tolist() for r in rids]


@pytest.mark.parametrize("variant", ["plain", "ngram", "int8", "preempted"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_reference_engine(arch, variant, drops):
    _, tc, _, _ = _model(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tc.vocab_size, n).astype(np.int32)
               for n in LENS]
    jeng, teng = _engines(arch, variant)
    preempt = variant == "preempted"
    want = _serve(jeng, prompts, preempt)
    got = _serve(teng, prompts, preempt)
    assert got == want
    assert sum(drops) > 0
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert teng.stats["resumes"] == int(preempt)
    assert teng.block_pool.num_free == ENGINE_KW["num_blocks"]


@pytest.mark.parametrize("mode", ["batched", "loop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference_generate(arch, mode, drops):
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(2)
    batch = rng.integers(0, tc.vocab_size, (3, 7)).astype(np.int32)
    want = np.asarray(JS.generate(jc, jp, jnp.asarray(batch), 6,
                                  prefill_mode=mode))
    got = TS.generate(tc, tp, batch, 6, prefill_mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(drops) > 0
