"""Port parity of training the recurrent (rwkv6-7b) and hybrid (zamba2-2.7b:
one mamba2 layer and the shared attention block a superblock) families
against the JAX package on the CPU, reduced f32 configs with converted
weights: the loss and its gradients against ``jax.value_and_grad``, three
SGD steps (params) and three Adam steps (losses) against the JAX
``make_train_step``, remat on against off, the per-chunk checkpoint on
against off, and the launcher.

Mamba2's gradients. The reference's ``_ssd_chunk`` masks exp(la_t - la_i)
after the exp; above the diagonal the exp overflows to inf and the
backward pass takes 0 · inf = NaN. The port masks inside the exponent. For
zamba2 the JAX oracle runs with ``repro.models.ssm._ssd_chunk`` replaced,
inside the test, by that masked-exponent form (no file of the reference is
edited); one test shows that the replacement leaves the reference's loss
bit for bit and that without it the reference's gradients are not finite.

Tolerances (f32): losses 1e-5; gradients 2e-6 plus 1e-5 of each leaf's
largest magnitude (the rwkv6 chunk's factorised decays, e^±40 factors,
move its gradients by ~1e-5 relative, as test_torch_ssm.py holds the
mix); each leaf's update over 3 SGD steps at lr 0.1 within 1% of its
largest entry plus 2e-6 (rwkv6's bonus u, zero at the start, moves by
~0.02 and the packages differ by up to 3.1e-5 there, varying from run to
run with the CPU's threading); Adam losses per step 1e-5.
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
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as launcher
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path, tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

ARCHS = ["rwkv6-7b", "zamba2-2.7b"]
_MODELS = {}


def _masked_ssd_chunk(xh, Bm, Cm, la, dtv, S0):
    """The reference's ``_ssd_chunk`` with the mask inside the exponent."""
    Cl = xh.shape[0]
    tri = jnp.tril(jnp.ones((Cl, Cl), bool))
    G = jnp.exp(jnp.where(tri, la[:, None] - la[None, :], -jnp.inf))
    M = (Cm @ Bm.T) * G * dtv[None, :]
    y = M @ xh + jnp.exp(la)[:, None] * (Cm @ S0.T)
    w_end = jnp.exp(la[-1] - la) * dtv
    S1 = jnp.exp(la[-1]) * S0 + jnp.einsum("c,ch,cs->hs", w_end, xh, Bm)
    return y, S1


@pytest.fixture
def oracle(monkeypatch):
    monkeypatch.setattr(JSSM, "_ssd_chunk", _masked_ssd_chunk)


def _model(arch, remat=False):
    if (arch, remat) not in _MODELS:
        jc = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                 dtype="float32", remat=remat)
        tc = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                                 remat=remat)
        jp = JT.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        _MODELS[arch, remat] = jc, tc, jp, tp
    return _MODELS[arch, remat]


def _batch(cfg, B=2, S=64, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _grads(cfg, params, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    paths, leaves = zip(*leaves_with_path(live))
    loss = T.loss_fn(cfg, live, _tb(batch))
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, leaves)))


def _jax_value_and_grad(jc, jp, batch):
    """The reference's loss and gradients, traced anew at each call (so a
    replaced ``_ssd_chunk`` takes effect)."""
    return jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(jc, p, batch)))(jp)


def _by_path(tree):
    return {tuple(k.key for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_leaf(got, want, path):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 + 1e-5 * scale,
                               err_msg=str(path))


# ------------------------------------------------------------- the loss
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch, oracle):
    jc, tc, jp, tp = _model(arch)
    batch = _batch(tc)
    jl, jg = _jax_value_and_grad(jc, jp, batch)
    loss, grads = _grads(tc, tp, batch)
    assert abs(float(loss) - float(jl)) <= 1e-5
    want = _by_path(jg)
    assert set(want) == set(grads)
    for path, g in grads.items():
        assert bool(torch.isfinite(g).all()), path
        _close_leaf(g.numpy(), want[path], path)
    if arch == "zamba2-2.7b":          # the shared block gathers every
        assert ("shared_attn", "attn", "wq") in grads     # superblock's


def test_reference_mamba2_gradients_need_the_masked_exponent(monkeypatch):
    """The reference's own ``_ssd_chunk`` gives non-finite gradients on
    reduced zamba2; the masked-exponent replacement gives the same loss
    bit for bit and finite gradients."""
    jc, tc, jp, _ = _model("zamba2-2.7b")
    batch = _batch(tc)
    jl, jg = _jax_value_and_grad(jc, jp, batch)
    bad = {p for p, v in _by_path(jg).items() if not np.isfinite(v).all()}
    assert ("blocks", "l0", "mamba", "A_log") in bad
    monkeypatch.setattr(JSSM, "_ssd_chunk", _masked_ssd_chunk)
    ml, mg = _jax_value_and_grad(jc, jp, batch)
    assert float(ml) == float(jl)
    assert all(np.isfinite(v).all() for v in _by_path(mg).values())


def _old_ssd_chunk(xh, Bm, Cm, la, dtv, S0):
    """The port's ``_ssd_chunk`` as it was: the mask after the exp."""
    Cl = xh.shape[-2]
    G = torch.exp(la[..., :, None] - la[..., None, :])
    tri = torch.tril(torch.ones((Cl, Cl), dtype=torch.bool))
    M = (Cm @ Bm.transpose(-1, -2)) * torch.where(tri, G, 0.0) \
        * dtv[..., None, :]
    y = M @ xh + torch.exp(la)[..., None] * (Cm @ S0.transpose(-1, -2))
    w_end = torch.exp(la[..., -1:] - la) * dtv
    S1 = (torch.exp(la[..., -1])[..., None, None] * S0
          + (xh * w_end[..., None]).transpose(-1, -2) @ Bm)
    return y, S1


def test_mamba2_mix_gradients_finite_and_forward_unchanged(monkeypatch):
    """The masked exponent: forward bit for bit the earlier form's, every
    gradient finite (the earlier form's are not)."""
    _, tc, _, tp = _model("zamba2-2.7b")
    mp = {k: v[0] for k, v in tp["blocks"]["l0"]["mamba"].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, tc.d_model)).astype(np.float32))

    def run():
        live = {k: v.clone().requires_grad_() for k, v in mp.items()}
        y, st = S.mamba2_mix(live, x, tc)
        grads = torch.autograd.grad(y.square().sum(), list(live.values()))
        return y.detach(), st["S"], dict(zip(live, grads))
    y, st, grads = run()
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    monkeypatch.setattr(S, "_ssd_chunk", _old_ssd_chunk)
    y0, st0, grads0 = run()
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert not all(bool(torch.isfinite(g).all()) for g in grads0.values())


# ------------------------------------------------------------ remat
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_chunk_checkpoints_change_nothing(arch, monkeypatch):
    """remat=True (each superblock and layer checkpointed) against
    remat=False, and the per-chunk checkpoint against none: the same loss
    and gradients (the recomputation repeats the same sums; within 1e-6 of
    each leaf's scale, since the CPU's threaded embedding backward may add
    in another order from run to run)."""
    _, tc, _, tp = _model(arch)
    batch = _batch(tc, seed=2)
    base = _grads(tc, tp, batch)
    runs = [_grads(dataclasses.replace(tc, remat=True), tp, batch)]
    monkeypatch.setattr(S, "_run_chunk", lambda fn, *args: fn(*args))
    runs.append(_grads(tc, tp, batch))
    for loss, grads in runs:
        assert abs(float(loss) - float(base[0])) <= 1e-6
        for path, g in grads.items():
            want = base[1][path].numpy()
            np.testing.assert_allclose(
                g.numpy(), want, rtol=0,
                atol=1e-6 * max(1.0, float(np.abs(want).max())),
                err_msg=str(path))


def test_chunks_checkpoint_only_under_autograd():
    """A chunk reruns in the backward pass only when autograd records a
    graph through it: not under no_grad, not for inputs that need no
    gradient (serving), once for a training input."""
    calls = []

    def fn(a):
        calls.append(torch.is_grad_enabled())
        return a * a
    a = torch.full((3,), 3.0, requires_grad=True)
    with torch.no_grad():
        S._run_chunk(fn, a)
    S._run_chunk(fn, a.detach())
    assert calls == [False, True]
    S._run_chunk(fn, a).sum().backward()
    assert calls == [False, True, True, True]   # the forward and its rerun
    assert torch.equal(a.grad, torch.full((3,), 6.0))


# ------------------------------------------------------------ train steps
def _jax_steps(jc, jp, opt_args, batches):
    opt = jax_make_optimizer(*opt_args[0], **opt_args[1])
    step = jax.jit(jtrainer.make_train_step(
        jc, opt, par.make_plan("dp", make_host_mesh())))
    state = {"params": jp, "opt": opt.init(jp)}
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def _port_steps(tc, tp, opt_args, batches):
    opt = make_optimizer(*opt_args[0], **opt_args[1])
    p = tree_map(lambda t: t.clone(), tp)
    state = {"params": p, "opt": opt.init(p)}
    step = trainer.make_train_step(tc, opt)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_reference(arch, opt, oracle):
    """SGD (lr 0.1): losses and the params' 3-step updates; Adam: the
    losses per step (Adam's first steps move each weight by about lr ·
    sign(g)). The rwkv6 gradients agree to ~1e-5 of their scale, so SGD
    runs at lr 0.1, not test_torch_train.py's 0.5: at 0.5 the third rwkv6
    loss moves by 1.1e-5."""
    jc, tc, jp, tp = _model(arch)
    batches = [_batch(tc, 2, 64, seed=3 + i) for i in range(3)]
    args = ((opt,), dict(lr=0.1 if opt == "sgd" else 3e-4, grad_clip=1.0))
    jstate, jl = _jax_steps(jc, jp, args, batches)
    tstate, tl = _port_steps(tc, tp, args, batches)
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    if opt == "sgd":
        want, start = _by_path(jstate["params"]), _by_path(jp)
        for path, got in leaves_with_path(tstate["params"]):
            update = want[path] - start[path]
            np.testing.assert_allclose(
                got.numpy() - start[path], update, rtol=0,
                atol=2e-6 + 1e-2 * float(np.abs(update).max()),
                err_msg=str(path))


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
