"""The port's examples (``examples/*_torch.py``) on the CPU: each ``main``
runs to its end at a small size with ``--device cpu`` and prints its
lines (the pipeline on 4 gloo ranks, the compression comparison on 2), and
each refuses to run without a card unless asked for the CPU. Against the
reference: serve_demo's waves, from an f32 copy model trained a few steps
by the reference's trainer on the same ``copy_task`` batches and carried
across with ``params_from_jax`` (the hybrid wave's params too), give the
tokens of the same waves through the reference's ``Engine`` / ``generate``;
quickstart's first 3 losses on batches handed in are within 1e-4 of the
reference's train step in f32, and its checkpoint round trip is exact; the
compression comparison's ratios and wire MB a step are the reference
compressors' ``ratio()`` over its config's ``param_count()``."""
import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.compression import make_compressor as jax_make_compressor
from repro.data.pipeline import copy_task
from repro.models import transformer as JT
from repro.optim import make_optimizer as jax_make_optimizer
from repro.serving import serve as JS
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import OversubConfig as JaxOversubConfig
from repro.serving.engine import SpecConfig as JaxSpecConfig
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
# the spawned ranks import the examples by name
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)

COPY_STEPS = 60          # enough for the copy (and the n-gram drafts) to land


def example(name):
    return importlib.import_module(f"{name}_torch")


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "an example left its process group"


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("serve_demo", []), ("pipeline_training", []),
    ("compression_comparison", ["--ranks", "1"])])
def test_examples_refuse_the_cpu_without_asking(name, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="cpu"):
        example(name).main(argv)


def test_quickstart_main_runs(capsys):
    out = example("quickstart").main(
        ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
         "--new", "3"])
    text = capsys.readouterr().out
    assert "arch=yi-9b-reduced params=" in text
    assert "step   0  loss " in text
    assert "checkpoint roundtrip ok (step 3)" in text
    assert "greedy continuation: [" in text
    assert text.rstrip().splitlines()[-1].startswith("kernels: B1=0 ")
    assert out["tokens"].shape == (1, 3)


def test_quickstart_matches_reference_train_step():
    """f32, the reference's params carried across: 3 losses within 1e-4
    of the reference's ``make_train_step`` (Adam, grad_clip 1.0) on the
    same batches; the restored checkpoint equals the trained state."""
    qs = example("quickstart")
    args = qs.parse(["--device", "cpu", "--new", "2"])
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("yi-9b")),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    data = SyntheticLM(cfg.vocab_size, seq_len=32, noise=0.05)
    batches = list(data.batches(batch_size=4, steps=3))

    jopt = jax_make_optimizer("adam", lr=3e-3, grad_clip=1.0)
    jstate = jtrainer.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jstate["params"]),
                              cfg, "cpu")
    opt = make_optimizer("adam", lr=3e-3, grad_clip=1.0)
    out = qs.run(args, cfg, batches,
                 {"params": tparams, "opt": opt.init(tparams)})

    jstep = jax.jit(jtrainer.make_train_step(jcfg, jopt, None, donate=False))
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(out["losses"], want, rtol=0, atol=1e-4)

    assert out["step"] == 3
    flat = dict(_leaves(out["state"]))
    back = dict(_leaves(out["restored"]))
    assert sorted(flat) == sorted(back)
    for k, v in flat.items():
        if torch.is_tensor(v):
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
        else:
            assert back[k] == v, k


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_serve_demo_main_runs(capsys):
    res = example("serve_demo").main(["--device", "cpu", "--steps",
                                      str(COPY_STEPS)])
    text = capsys.readouterr().out
    for line in ("legacy static batch: copy accuracy",
                 "engine (mixed lengths x4): copy accuracy",
                 "engine replay with prefix caching:",
                 "distinct step signatures:",
                 "JSONL trace:", "(TTFTs match live)",
                 "prometheus snapshot excerpt:",
                 'engine_request_ttft_seconds{quantile="0.5"}',
                 "engine oversubscription wave x4:",
                 "was evicted mid-flight and resumed",
                 "engine speculative wave (n-gram self-drafting, k=6) x4:",
                 "engine hybrid wave (mamba2 slabs + paged shared "
                 "attention) x4: outputs bit-identical"):
        assert line in text, line
    assert text.rstrip().splitlines()[-1].startswith("kernels: B1=0 ")
    assert res["static"].shape == (4, 8)


def _reference_waves(cfg, params, hcfg, hparams):
    """The demo's waves through the reference's engine and generator:
    the tokens only."""
    sd = example("serve_demo")
    res = {}
    test = copy_task(4, sd.SEQ, cfg.vocab_size, seed=9999)
    half = sd.SEQ // 2
    keep = half // 2
    res["static"] = np.asarray(JS.generate(
        cfg, params, jnp.asarray(test["tokens"][:, :half + keep]),
        max_new=keep, temperature=0.0))
    keeps = [keep, keep // 2, keep - 2, 3]
    prompts = [test["tokens"][b, :half + kp] for b, kp in enumerate(keeps)]

    def engine(**kw):
        base = dict(block_size=8, num_blocks=64, max_blocks_per_seq=8,
                    max_slots=4, prefill_chunk=16)
        return JaxEngine(cfg, params, JaxEngineConfig(**{**base, **kw}))

    eng = engine()
    rids = []
    for p, kp in zip(prompts, keeps):
        rids.append(eng.add_request(p, max_new=kp))
        eng.step()
    outs = eng.drain()
    res["engine"] = [outs[r] for r in rids]
    rids2 = [eng.add_request(p, max_new=kp) for p, kp in zip(prompts, keeps)]
    outs2 = eng.drain()
    res["replay"] = [outs2[r] for r in rids2]
    ov = engine(num_blocks=24, oversub=JaxOversubConfig())
    ov_rids = [ov.add_request(p, max_new=kp, priority=b % 2)
               for b, (p, kp) in enumerate(zip(prompts, keeps))]
    for _ in range(3):
        ov.step()
    assert any(ov.preempt_request(r) for r in ov_rids)
    ov_outs = ov.drain()
    res["oversub"] = [ov_outs[r] for r in ov_rids]
    sp = engine(spec=JaxSpecConfig(k=6))
    sp_rids = [sp.add_request(p, max_new=kp) for p, kp in zip(prompts, keeps)]
    sp_outs = sp.drain()
    res["spec"] = [sp_outs[r] for r in sp_rids]
    rng = np.random.default_rng(0)
    hprompts = [rng.integers(0, 32, size=int(n)).astype(np.int32)
                for n in (5, 11, 8, 3)]
    res["hybrid"] = JS.engine_generate(
        hcfg, hparams, hprompts, [6, 4, 9, 7],
        engine_cfg=JaxEngineConfig(block_size=8, num_blocks=32,
                                   max_blocks_per_seq=8, max_slots=4,
                                   prefill_chunk=8))
    return res


def test_serve_demo_waves_match_reference():
    """Every wave's tokens equal the reference's on the same f32 params
    (the copy model trained by the reference's trainer on the demo's
    ``copy_task`` batches; the hybrid's ``init_params(PRNGKey(7))``)."""
    sd = example("serve_demo")
    cfg = dataclasses.replace(sd.COPY, dtype="float32")
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    jhcfg = JaxModelConfig(**dataclasses.asdict(sd.HYBRID))
    jopt = jax_make_optimizer("adam", lr=2e-3, grad_clip=1.0)
    jstate = jtrainer.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jopt, None))
    for i in range(COPY_STEPS):
        jstate, _ = jstep(jstate, copy_task(32, sd.SEQ, cfg.vocab_size,
                                            seed=i))
    jp = jstate["params"]
    jhp = JT.init_params(jhcfg, jax.random.PRNGKey(7))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    thp = params_from_jax(jax.tree.map(np.asarray, jhp), sd.HYBRID, "cpu")

    got = sd.waves(cfg, tp, thp, "cpu")
    want = _reference_waves(jcfg, jp, jhcfg, jhp)
    np.testing.assert_array_equal(got["static"], want["static"])
    for wave in ("engine", "replay", "oversub", "spec", "hybrid"):
        assert len(got[wave]) == len(want[wave]) == 4, wave
        for a, b in zip(got[wave], want[wave]):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=wave)


def test_pipeline_main_runs_on_four_gloo_ranks(capsys):
    res = example("pipeline_training").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "ran 4 stages on 4 gloo ranks on the host" in text
    assert "pipeline output matches sequential: maxerr=" in text
    assert ("stages=4 microbatches=8: 11 rounds, bubble=0.273 "
            "(paper model: 0.273)") in text
    assert text.rstrip().splitlines()[-1].startswith("kernels: B1=0 ")
    assert res["rounds"] == 11 and res["hops"] == 11
    assert res["err"] < 1e-5


def test_compression_main_runs_on_two_gloo_ranks(capsys):
    """Two gloo ranks, 6 batches of 4; the ratios and wire MB a step are
    the reference compressors' over the reference config's params."""
    cc = example("compression_comparison")
    out = cc.main(["--device", "cpu", "--ranks", "2", "--batches", "6",
                   "--batch", "4"])
    text = capsys.readouterr().out
    assert "2 data-parallel rank(s), gloo on the host, 6 batches" in text
    jcfg = JaxModelConfig(**dataclasses.asdict(cc.CFG))
    for name in cc.COMPRESSORS:
        ratio = (1.0 if name == "none"
                 else jax_make_compressor(name, frac=0.01).ratio())
        wire = jcfg.param_count() * 4 / ratio / 1e6
        assert out[name]["ratio"] == ratio, name
        assert out[name]["wire_mb"] == wire, name
        assert len(out[name]["losses"]) == 6
        assert f"{name:8s} first5=" in text
        assert f"wire={wire:.2f}MB/step ({ratio:.0f}x compression)" in text
    assert text.rstrip().splitlines()[-1].startswith("kernels: B1=0 ")
