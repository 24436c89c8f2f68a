"""Port parity of the last three configs of the registry (ROADMAP A17):
qwen2-vl-2b (M-RoPE, vision stub, tied embeddings), musicgen-medium (MHA,
audio stub) and phi4-mini-3.8b (dense GQA), reduced and f32, against the
JAX package on the CPU with converted weights; and the registry, the input
shapes and the cost model against the reference's copies.

Serving: the continuous-batching engine (plain, n-gram speculation k = 4,
int8 pools; qwen2-vl also with one forced preemption) and ``serve.generate``
give the reference's tokens. They take token ids, and their M-RoPE
positions are the text position in all three streams, as the reference's
verbs broadcast it. The stub frontends (musicgen's audio, qwen2-vl's
vision): ``forward`` over "embeds" and ``decode_step`` over an "embed";
and musicgen's two Adam steps on embeds (the untied token table off the
loss's path). The launcher trains each
config.

Tolerances (f32): tokens equal; hidden states and logits atol 2e-5 (as
test_torch_train.py and the dense-cache logits of test_torch_serve.py);
losses 1e-5 relative; the cost model's floats 1e-12 relative (the same formulas in the same
order); configs and shapes equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.core import costmodel as JC
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
from repro_torch.configs import base as B
from repro_torch.convert import params_from_jax
from repro_torch.core import costmodel as C
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.serving import serve as TS
from repro_torch.serving.engine import (Engine, EngineConfig, KVQuantConfig,
                                        OversubConfig, SpecConfig)
from repro_torch.train import trainer
from repro_torch.tree import tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

ARCHS = ["qwen2-vl-2b", "musicgen-medium", "phi4-mini-3.8b"]
ENGINE_KW = dict(block_size=4, num_blocks=64, max_blocks_per_seq=12,
                 max_slots=3, prefill_chunk=8)
SLO_OFF = dict(ttft_slo_s=1e9, tpot_slo_s=1e9)
LENS = (5, 17, 9, 30)
NEWS = (8, 6, 10, 12)
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jc = dataclasses.replace(JB.reduced(JB.get_config(arch)),
                                 dtype="float32")
        tc = dataclasses.replace(B.reduced(B.get_config(arch)),
                                 dtype="float32")
        jp = JT.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        _MODELS[arch] = jc, tc, jp, tp
    return _MODELS[arch]


# ------------------------------------------------------------ registry
def test_registry_equals_reference():
    assert B.list_configs() == JB.list_configs()
    assert len(B.list_configs()) == 10
    assert B.ARCH_MODULES == JB.ARCH_MODULES
    assert ({k: dataclasses.asdict(v) for k, v in B.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()})
    assert ([f.name for f in dataclasses.fields(B.ModelConfig)]
            == [f.name for f in dataclasses.fields(JB.ModelConfig)])


@pytest.mark.parametrize("cut", ["full", "reduced"])
@pytest.mark.parametrize("name", sorted(JB.list_configs()))
def test_config_equals_reference(name, cut):
    tc, jc = B.get_config(name), JB.get_config(name)
    if cut == "reduced":
        tc, jc = B.reduced(tc), JB.reduced(jc)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.is_attention_free == jc.is_attention_free
    assert tc.sub_quadratic == jc.sub_quadratic
    assert tc.resolved_head_dim == jc.resolved_head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_and_counts(arch):
    """Leaf for leaf through params_from_jax (qwen2-vl ties its embeddings:
    no lm_head); the counts equal the reference's, and the leaves' less the
    final norm (which the analytical count leaves out, in both packages)."""
    jc, tc, jp, tp = _model(arch)
    assert ("lm_head" in tp) == (not tc.tie_embeddings)
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert tc.param_count() == jc.param_count() == n - tc.d_model
    assert tc.active_param_count() == jc.active_param_count()
    full = B.get_config(arch)
    assert full.param_count() == JB.get_config(arch).param_count()


# --------------------------------------------------------- cost model
def test_costmodel_equals_reference():
    for P in (2, 4, 8, 64):
        for m in (1, 1000, 2**20):
            for Lat in (0.0, 1e-6, 5e-5):
                for G in (1e-10, 2.5e-12):
                    for f in ("t_tree", "t_butterfly", "t_pipeline",
                              "t_rabenseifner", "t_lower_bound",
                              "t_parameter_server"):
                        np.testing.assert_allclose(
                            getattr(C, f)(P, m, Lat, G, 2),
                            getattr(JC, f)(P, m, Lat, G, 2), rtol=1e-12)
                    assert (C.best_allreduce(P, m, Lat, G)[0]
                            == JC.best_allreduce(P, m, Lat, G)[0])
    assert C.dp_comm_bytes(10**9) == JC.dp_comm_bytes(10**9)
    assert (C.tp_comm_bytes_fc(8, 4096, 1024, 3)
            == JC.tp_comm_bytes_fc(8, 4096, 1024, 3))
    assert (C.hybrid_comm_bytes(10**6, 10**7, 32, 4096)
            == JC.hybrid_comm_bytes(10**6, 10**7, 32, 4096))
    for s, mb in ((4, 1), (4, 16), (8, 32)):
        assert (C.pipeline_bubble_fraction(s, mb)
                == JC.pipeline_bubble_fraction(s, mb))
    assert dataclasses.asdict(C.V5E) == dataclasses.asdict(JC.V5E)
    for hw in (C.V5E, C.H100):
        terms = C.roofline_terms(1e15, 1e12, 1e10, 4, hw)
        jhw = JC.HW(**dataclasses.asdict(hw))
        assert terms == JC.roofline_terms(1e15, 1e12, 1e10, 4, jhw)
        assert C.dominant_term(terms) == JC.dominant_term(terms)
    assert C.H100.peak_flops == 989e12 and C.H100.hbm_bw == 3.35e12
    assert C.model_flops(3.8e9, 4096) == JC.model_flops(3.8e9, 4096)


# ------------------------------------------------------------ serving
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


@pytest.mark.parametrize("arch,variant", [
    (a, v) for a in ARCHS for v in ("plain", "ngram", "int8")]
    + [("qwen2-vl-2b", "preempted")])
def test_engine_equals_reference_engine(arch, variant):
    _, tc, _, _ = _model(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tc.vocab_size, n).astype(np.int32)
               for n in LENS]
    jeng, teng = _engines(arch, variant)
    preempt = variant == "preempted"
    want = _serve(jeng, prompts, preempt)
    got = _serve(teng, prompts, preempt)
    assert got == want
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert teng.stats["resumes"] == int(preempt)
    assert teng.block_pool.num_free == ENGINE_KW["num_blocks"]


@pytest.mark.parametrize("mode", ["batched", "loop"])
def test_generate_equals_reference_generate(mode):
    jc, tc, jp, tp = _model("qwen2-vl-2b")
    rng = np.random.default_rng(2)
    batch = rng.integers(0, tc.vocab_size, (3, 7)).astype(np.int32)
    want = np.asarray(JS.generate(jc, jp, jnp.asarray(batch), 6,
                                  prefill_mode=mode))
    got = TS.generate(tc, tp, batch, 6, prefill_mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ the stub frontends
@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-2b"])
def test_stub_embeds_forward_and_decode_match_reference(arch):
    """The two stub frontends: embeddings (musicgen's sum of the 4
    codebook embeddings; qwen2-vl's patch embeddings, at the text
    positions) through ``forward``, then a dense cache filled by
    ``decode_step`` one "embed" at a time: hidden states and logits within
    2e-5 of JAX's."""
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(3)
    emb = (rng.standard_normal((2, 6, tc.d_model)) * 0.5).astype(np.float32)
    want, _ = jax.jit(lambda p, e: JT.forward(jc, p, {"embeds": e}))(jp, emb)
    got, _ = T.forward(tc, tp, {"embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    jstep = jax.jit(lambda p, s, e, i: JT.decode_step(jc, p, s, {"embed": e},
                                                      i))
    jst = JT.init_decode_state(jc, 2, 8)
    tst = T.init_decode_state(tc, 2, 8, device="cpu")
    for i in range(emb.shape[1]):
        jl, jst = jstep(jp, jst, emb[:, i], jnp.int32(i))
        tl, tst = T.decode_step(tc, tp, tst,
                                {"embed": torch.from_numpy(emb[:, i])}, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                   rtol=0, err_msg=f"position {i}")


def test_musicgen_trains_on_embeds_like_reference():
    """Two Adam steps on frame embeddings: the untied token embedding is
    not on the path (its gradient is zeros in both packages, so Adam
    leaves it as it was); losses 1e-5 relative, that table equal."""
    jc, tc, jp, tp = _model("musicgen-medium")
    rng = np.random.default_rng(4)
    batches = [{"embeds": (rng.standard_normal((2, 64, tc.d_model)) * 0.5
                           ).astype(np.float32),
                "labels": rng.integers(0, tc.vocab_size, (2, 64)
                                       ).astype(np.int32)} for _ in range(2)]
    opt = jax_make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    jstep = jax.jit(jtrainer.make_train_step(
        jc, opt, par.make_plan("dp", make_host_mesh())))
    state = {"params": jp, "opt": opt.init(jp)}
    want = []
    for b in batches:
        state, m = jstep(state, b)
        want.append(float(m["loss"]))
    topt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    p = tree_map(lambda t: t.clone(), tp)
    tstate = {"params": p, "opt": topt.init(p)}
    got = []
    for b in batches:
        tstate, m = trainer.make_train_step(tc, topt)(tstate, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert torch.equal(tstate["params"]["embed"]["table"],
                       tp["embed"]["table"])


# ------------------------------------------------------------ launcher
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
