"""Port parity of the training path: ``attention_train``, ``forward``,
``loss_fn`` and their gradients, ``make_train_step`` (SGD and Adam, with
and without gradient accumulation), checkpoints in both directions, the
data pipeline and the launcher, against the JAX package on reduced yi-9b
(full attention, 4 heads over 1 kv head) and reduced gemma3-12b (one local
sliding-window layer and one global layer), float32, remat on and off. The
weights are the JAX ``init_params`` converted with ``params_from_jax``; the
inputs are numpy arrays handed to both packages. On the CPU the port's
attention takes the reference's own strategies (naive / chunked); the
flash-attention kernel is held against them on the card by chip_smoke.py.

Tolerances (float32): attention and hidden states atol 2e-5, losses atol
1e-5, gradients atol 2e-6 (largest gradients ~0.5; the two packages sum
the same products in another order), params after 3 SGD steps atol 2e-6,
Adam losses per step atol 1e-5 (Adam's first steps move each weight by
about lr·sign(g), so the params are held under SGD).
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
from repro.data import pipeline as JD
from repro.launch.mesh import make_host_mesh
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as D
from repro_torch.launch import train as launcher
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path, tree_map
from torch_threads import jitted, one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

ARCHS = ["yi-9b", "gemma3-12b"]


def _cfgs(arch, remat=False, dtype="float32", **kw):
    jc = dataclasses.replace(jax_reduced(jax_get_config(arch)), dtype=dtype,
                             remat=remat, **kw)
    tc = dataclasses.replace(reduced(get_config(arch)), dtype=dtype,
                             remat=remat, **kw)
    return jc, tc


def _setup(arch, remat=False, dtype="float32", seed=0, **kw):
    jc, tc = _cfgs(arch, remat, dtype, **kw)
    jp = JT.init_params(jc, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tree_pairs(jtree, ttree):
    """(numpy f32 JAX leaf, numpy f32 port leaf) by key path."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    jmap = {tuple(k.key for k in p): v for p, v in jl}
    tl = leaves_with_path(ttree)
    assert set(jmap) == {p for p, _ in tl}
    return [(p, _f32(jmap[p]), _f32(v)) for p, v in tl]


# ------------------------------------------------------------ the forward
@pytest.mark.parametrize("S", [64, 40])
@pytest.mark.parametrize("impl", ["chunked", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_train_matches_reference(arch, impl, S):
    """S = 64 takes the chunked path (attn_chunk 32), S = 40 the naive one
    (40 % 32 != 0), as in the reference's dispatch; each with the full
    mask and with the reduced configs' window of 32."""
    jc, tc, jp, tp = _setup(arch)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S)).astype(np.int32)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["attn"])
    tl = {k: v[0] for k, v in tp["blocks"]["l0"]["attn"].items()}
    for window in (None, tc.window_size):
        want = jitted(JA.attention_train, (3,), ("window", "impl"))(
            jl, jnp.asarray(x), jnp.asarray(pos), jc, window=window,
            impl=impl)
        got = A.attention_train(tl, torch.from_numpy(x.copy()),
                                torch.from_numpy(pos.copy()), tc,
                                window=window, impl=impl)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("S", [64, 40])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, remat, S):
    jc, tc, jp, tp = _setup(arch, remat, loss_chunk=64 if S == 64 else 40)
    batch = _batch(tc, 2, S)
    jh, jaux = jitted(JT.forward, (0,))(jc, jp, {"tokens": batch["tokens"]})
    th, taux = T.forward(tc, tp, _tb(batch))
    np.testing.assert_allclose(_f32(th), _f32(jh), atol=2e-5, rtol=0)
    assert float(taux) == float(jaux) == 0.0
    jl = jitted(JT.loss_fn, (0,))(jc, jp, batch)
    tl = T.loss_fn(tc, tp, _tb(batch))
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert abs(float(tl) - float(jl)) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_from_embeddings_matches_reference(arch):
    """The frontend-stub input: embeddings in place of token ids."""
    jc, tc, jp, tp = _setup(arch)
    x = np.random.default_rng(7).standard_normal(
        (2, 40, tc.d_model)).astype(np.float32)
    jh, _ = jitted(JT.forward, (0,))(jc, jp, {"embeds": jnp.asarray(x)})
    th, _ = T.forward(tc, tp, {"embeds": torch.from_numpy(x.copy())})
    np.testing.assert_allclose(_f32(th), _f32(jh), atol=2e-5, rtol=0)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_value_and_grad(arch, remat):
    jc, tc, jp, tp = _setup(arch, remat)
    batch = _batch(tc, 2, 64, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, batch)))(jp)
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    paths, leaves = zip(*leaves_with_path(live))
    loss = T.loss_fn(tc, live, _tb(batch))
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    for path, want, _ in _tree_pairs(jg, tp):
        np.testing.assert_allclose(_f32(grads[path]), want, atol=2e-6, rtol=0,
                                   err_msg=str(path))


def test_loss_refuses_a_length_the_chunk_does_not_divide():
    _, tc, _, tp = _setup("yi-9b")
    with pytest.raises(ValueError, match="loss_chunk"):
        T.loss_fn(tc, tp, _tb(_batch(tc, 1, 96)))


_KIND_ARCH = {"moe_attn": "qwen3-moe-30b-a3b", "rwkv": "rwkv6-7b",
              "mamba": "zamba2-2.7b", "shared_attn": "zamba2-2.7b"}


@pytest.mark.parametrize("kind,item", [("moe_attn", "A13"), ("rwkv", "A9"),
                                       ("mamba", "A9"),
                                       ("shared_attn", "A9")])
def test_unported_layer_kinds_raise(kind, item):
    """The layer kinds that ROADMAP `item` brought to training (they raised
    before it): each kind's train layer returns a finite x of the input's
    shape and a finite aux (the load-balancing loss, > 0, for MoE; 0
    otherwise). Parity with the reference: test_torch_moe_model.py and
    test_torch_recurrent_train.py."""
    arch = _KIND_ARCH[kind]
    tc = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    params = T.init_params(tc, seed=0, device="cpu")
    i = T._layer_kinds(tc).index(kind)
    lp = (params["shared_attn"] if kind == "shared_attn"
          else T._at(params["blocks"], 0)[f"l{i}"])
    x = torch.randn(1, 32, tc.d_model,
                    generator=torch.Generator().manual_seed(0))
    y, aux = T._apply_layer_train(kind, lp, x, torch.arange(32)[None], tc)
    assert y.shape == x.shape and bool(torch.isfinite(y).all()), item
    assert not torch.equal(y, x)
    aux = torch.as_tensor(aux)
    assert bool(torch.isfinite(aux))
    assert (float(aux) > 0) == (kind == "moe_attn")


# ------------------------------------------------------------ train steps
def _jax_steps(jc, jp, opt_args, batches, accum):
    opt = jax_make_optimizer(*opt_args[0], **opt_args[1])
    plan = par.make_plan("dp", make_host_mesh())
    step = jax.jit(jtrainer.make_train_step(jc, opt, plan, accum_steps=accum))
    state = {"params": jp, "opt": opt.init(jp)}
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def _port_steps(tc, tp, opt_args, batches, accum):
    opt = make_optimizer(*opt_args[0], **opt_args[1])
    state = {"params": tp, "opt": opt.init(tp)}
    step = trainer.make_train_step(tc, opt, accum_steps=accum)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_sgd_steps_match_reference_params(arch, accum):
    jc, tc, jp, tp = _setup(arch, remat=arch == "gemma3-12b")
    batches = list(JD.SyntheticLM(tc.vocab_size, 64, seed=3).batches(4, 3))
    args = (("sgd",), dict(lr=0.5, grad_clip=1.0))
    jstate, jl = _jax_steps(jc, jp, args, batches, accum)
    tstate, tl = _port_steps(tc, tp, args, batches, accum)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    for path, want, got in _tree_pairs(jstate["params"], tstate["params"]):
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0,
                                   err_msg=str(path))
    assert tstate["opt"]["step"] == int(jstate["opt"]["step"]) == 3


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_adam_steps_match_reference_losses(arch, accum):
    jc, tc, jp, tp = _setup(arch, remat=arch == "yi-9b")
    batches = list(JD.SyntheticLM(tc.vocab_size, 64, seed=4).batches(4, 3))
    args = (("adam",), dict(lr=3e-4, grad_clip=1.0))
    _, jl = _jax_steps(jc, jp, args, batches, accum)
    _, tl = _port_steps(tc, tp, args, batches, accum)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulation_equals_the_full_batch(arch):
    """accum_steps=4 gives the update of one full batch (same mean
    gradient up to f32 accumulation order; tests/test_accum_and_dryrun.py)."""
    _, tc, _, tp = _setup(arch)
    batch = _batch(tc, 8, 64, seed=5)
    out = {}
    for accum in (1, 4):
        opt = make_optimizer("sgd", lr=1e-2)
        p = tree_map(lambda t: t.clone(), tp)
        state, m = trainer.make_train_step(tc, opt, accum_steps=accum)(
            {"params": p, "opt": opt.init(p)}, batch)
        out[accum] = (float(m["loss"]), state["params"])
    assert out[1][0] == pytest.approx(out[4][0], abs=1e-5)
    for (_, a), (_, b) in zip(leaves_with_path(out[1][1]),
                              leaves_with_path(out[4][1])):
        np.testing.assert_allclose(_f32(b), _f32(a), atol=1e-6, rtol=0)


def test_synthetic_data_equals_reference_within_one_process():
    ref = list(JD.SyntheticLM(97, 33, seed=2).batches(3, 2))
    got = list(D.SyntheticLM(97, 33, seed=2).batches(3, 2))
    for r, g in zip(ref, got):
        assert set(r) == set(g) == {"tokens", "labels"}
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])
            assert g[k].dtype == np.int32
    for k, v in JD.copy_task(4, 10, 50, seed=1).items():
        np.testing.assert_array_equal(D.copy_task(4, 10, 50, seed=1)[k], v)


# ------------------------------------------------------------ checkpoints
def _states(arch, dtype):
    """The same trained-for-one-step Adam state in both packages."""
    jc, tc, jp, tp = _setup(arch, dtype=dtype)
    batches = list(JD.SyntheticLM(tc.vocab_size, 64, seed=6).batches(2, 1))
    args = (("adam",), dict(lr=1e-3))
    jstate, _ = _jax_steps(jc, jp, args, batches, 1)
    tstate, _ = _port_steps(tc, tp, args, batches, 1)
    return jc, tc, jstate, tstate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_the_port(arch, dtype, tmp_path):
    jc, tc, jstate, tstate = _states(arch, dtype)
    path = jckpt.save(str(tmp_path / "jax.npz"), jstate, step=7)
    template = {"params": T.init_params(tc, seed=9, device="cpu"),
                "opt": make_optimizer("adam").init(
                    T.init_params(tc, seed=9, device="cpu"))}
    got, step = ckpt.restore(path, template)
    assert step == 7 and got["opt"]["step"] == 1
    assert got["params"]["embed"]["table"].dtype == getattr(torch, dtype)
    for path_, want, have in _tree_pairs(jstate, got):
        np.testing.assert_array_equal(have, want, err_msg=str(path_))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(arch, dtype, tmp_path):
    jc, tc, jstate, tstate = _states(arch, dtype)
    path = ckpt.save(str(tmp_path / "port.npz"), tstate, step=5)
    template = jtrainer.init_state(jc, jax_make_optimizer("adam"),
                                   jax.random.PRNGKey(3))
    got, step = jckpt.restore(path, template)
    assert step == 5 and int(got["opt"]["step"]) == 1
    assert got["params"]["embed"]["table"].dtype == template["params"][
        "embed"]["table"].dtype
    for path_, have, want in _tree_pairs(got, tstate):
        np.testing.assert_array_equal(have, want, err_msg=str(path_))


def test_restore_refuses_other_shapes_and_missing_leaves(tmp_path):
    _, tc, _, tp = _setup("yi-9b")
    path = ckpt.save(str(tmp_path / "a.npz"), {"params": tp}, step=1)
    other = dataclasses.replace(tc, d_ff=tc.d_ff * 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(path, {"params": T.init_params(other, device="cpu")})
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(path, {"params": tp, "opt": {"step": 0}})


# --------------------------------------------------------------- launcher
def _launch(*args):
    return launcher.main(["--arch", "yi-9b", "--preset", "reduced",
                          "--batch", "2", "--seq", "64", "--log-every", "1",
                          "--device", "cpu", *args])


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    first = str(tmp_path / "a.npz")
    state = _launch("--steps", "2", "--checkpoint", first)
    out = capsys.readouterr().out
    assert "step 1: loss=" in out and "step 2: loss=" in out
    assert f"saved {first}" in out and state["opt"]["step"] == 2
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert all(np.isfinite(losses))
    second = str(tmp_path / "b.npz")
    resumed = _launch("--steps", "1", "--resume", first, "--checkpoint",
                      second)
    out = capsys.readouterr().out
    assert f"resumed from {first} at step 2" in out and "step 3: loss=" in out
    assert resumed["opt"]["step"] == 3
    # the launcher's checkpoint restores into the JAX launcher's state
    jc = dataclasses.replace(jax_reduced(jax_get_config("yi-9b")))
    template = jtrainer.init_state(jc, jax_make_optimizer("adam"),
                                   jax.random.PRNGKey(0))
    got, step = jckpt.restore(second, template)
    assert step == 3 and int(got["opt"]["step"]) == 3
    for path_, have, want in _tree_pairs(got["params"], resumed["params"]):
        np.testing.assert_array_equal(have, want, err_msg=str(path_))


@pytest.mark.parametrize("args", [["--plan", "tp"], ["--plan", "dp_tp_zero1"],
                                  ["--plan", "dp_tp"]])
def test_launcher_refuses_multi_device_modes(args):
    """The sharding plans other than dp come with core/parallelism.py; the
    paper mode runs (test_torch_paper_mode.py)."""
    with pytest.raises(NotImplementedError):
        _launch("--steps", "1", *args)
