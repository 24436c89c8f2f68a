"""Port parity of M-RoPE (Qwen2-VL's multimodal rotary embedding) and of
the training path under it, against the JAX package on the CPU: the
rotation itself at head dims 64, 72, 80, 88 and 128 with distinct t / h / w
streams (88 rescales its sections 11/16/17 by rounding half to even, where
rounding half up would give 11/17/16), equal streams against the port's
``apply_rope``, then reduced f32 qwen2-vl-2b (12/2 heads → 4/1, hd 64,
tied embeddings) fed stub patch embeddings with Qwen2-VL's 3-D position
ids: ``forward``, ``loss_fn`` and its gradients, and ``make_train_step``
with ``accum_steps=2``, whose microbatches must cut the (3, B, S)
positions on axis 1 as the reference's do.

Only distinct streams test M-RoPE: the serving verbs broadcast the text
position to all three, where it equals plain RoPE bit for bit
(test_torch_a17_configs.py holds those paths).

Tolerances (f32): the rotation atol 1e-5 (outputs of order 1; the two
packages' cos / sin differ in the last bit); equal streams bit for bit;
hidden states atol 2e-5 (as test_torch_train.py); losses 1e-5 relative;
gradients 1e-5 · max|ref| per leaf; losses of the accumulated steps 1e-5
relative.
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.train import trainer
from repro_torch.tree import leaves_with_path, tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

ARCH = "qwen2-vl-2b"
GRID = 4                 # a 1 x 4 x 4 patch grid a row
_MODELS = {}


def _model():
    if ARCH not in _MODELS:
        jc = dataclasses.replace(jax_reduced(jax_get_config(ARCH)),
                                 dtype="float32")
        tc = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
        jp = JT.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        _MODELS[ARCH] = jc, tc, jp, tp
    return _MODELS[ARCH]


def vl_positions(B, S, grid=GRID):
    """(3, B, S) Qwen2-VL position ids (arXiv:2409.12191 §2.1): row b
    holds b text tokens, a 1 x grid x grid image (t = b, h = b + row, w =
    b + column) and text whose three ids continue at the image's max + 1."""
    r, c = np.divmod(np.arange(grid * grid), grid)
    out = np.empty((3, B, S), np.int32)
    for b in range(B):
        img = b + np.stack([np.zeros_like(r), r, c])
        tail = img.max() + 1 + np.arange(S - b - grid * grid)
        lead = np.broadcast_to(np.arange(b), (3, b))
        out[:, b] = np.concatenate(
            [lead, img, np.broadcast_to(tail, (3, len(tail)))], axis=1)
    return out


def _vl_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"embeds": (rng.standard_normal((B, S, cfg.d_model)) * 0.5
                       ).astype(np.float32),
            "positions": vl_positions(B, S),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            batch.items()}


# ------------------------------------------------------------ the rotation
@pytest.mark.parametrize("hd,sections", [(64, (8, 12, 12)),
                                         (72, (9, 14, 13)),
                                         (80, (10, 15, 15)),
                                         (88, (11, 16, 17)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_jax(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 9)).astype(np.int32)
    want = np.asarray(jax.jit(JL.apply_mrope)(jnp.asarray(x),
                                              jnp.asarray(pos)))
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert tuple(L.mrope_sections(hd)) == sections


@pytest.mark.parametrize("hd", [64, 88, 128])
def test_equal_streams_are_apply_rope(hd):
    rng = np.random.default_rng(hd)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3, hd)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 4096, (2, 9))).long()
    assert torch.equal(L.apply_mrope(x, pos[None].expand(3, 2, 9)),
                       L.apply_rope(x, pos))


def test_vl_positions_layout():
    pos = vl_positions(2, 24)
    assert pos.shape == (3, 2, 24)
    np.testing.assert_array_equal(pos[:, 0, :3], [[0, 0, 0], [0, 0, 0],
                                                  [0, 1, 2]])
    np.testing.assert_array_equal(pos[:, 0, 16], [4, 4, 4])   # max + 1
    np.testing.assert_array_equal(pos[:, 1, 0], [0, 0, 0])    # text first
    np.testing.assert_array_equal(pos[:, 1, 1], [1, 1, 1])    # image at 1
    np.testing.assert_array_equal(pos[:, 1, 17], [5, 5, 5])


# -------------------------------------------------- forward, loss, grads
@pytest.mark.parametrize("inputs", ["embeds", "tokens"])
def test_forward_matches_jax(inputs):
    """Stub embeddings with distinct streams; token ids with the default
    positions (the text position in all three streams)."""
    jc, tc, jp, tp = _model()
    batch = _vl_batch(tc, 2, 32, seed=1)
    if inputs == "tokens":
        batch = {"tokens": batch["labels"]}
    want, waux = jax.jit(lambda p, b: JT.forward(jc, p, b))(jp, batch)
    got, aux = T.forward(tc, tp, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    assert float(aux) == float(waux) == 0.0


def test_loss_and_gradients_match_jax_value_and_grad():
    jc, tc, jp, tp = _model()
    batch = _vl_batch(tc, 2, 64, seed=2)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, batch)))(jp)
    live = tree_map(lambda p: p.detach().requires_grad_(), tp)
    paths, leaves = zip(*leaves_with_path(live))
    loss = T.loss_fn(tc, live, _torch(batch))
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    jmap = {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(jmap) == set(grads) and ("lm_head", "w") not in grads
    for path, g in grads.items():
        ref = jmap[path]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=str(path))


def test_positions_change_the_loss():
    """The streams reach the rotation: the grid's positions give another
    loss than the text positions broadcast."""
    _, tc, _, tp = _model()
    batch = _torch(_vl_batch(tc, 2, 64, seed=2))
    flat = dict(batch, positions=batch["positions"][0:1].expand(3, 2, 64))
    assert abs(float(T.loss_fn(tc, tp, batch))
               - float(T.loss_fn(tc, tp, flat))) > 1e-4


# --------------------------------------------------- accumulation split
def test_microbatch_rows_cut_positions_on_axis_1():
    batch = _torch(_vl_batch(_model()[1], 4, 24, seed=3))
    assert trainer._batch_rows(batch) == 4
    micro = trainer._rows(batch, 2, 4)
    assert tuple(micro["positions"].shape) == (3, 2, 24)
    assert torch.equal(micro["positions"], batch["positions"][:, 2:4])
    assert torch.equal(micro["embeds"], batch["embeds"][2:4])


def test_accumulated_steps_match_reference():
    """Two Adam steps, the first with accum_steps=2, on a batch of 4 rows
    whose positions differ row by row, against the reference's
    make_train_step(..., accum_steps=2) and (1)."""
    jc, tc, jp, tp = _model()
    batches = [_vl_batch(tc, 4, 32, seed=10 + i) for i in range(2)]
    opt = jax_make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    plan = par.make_plan("dp", make_host_mesh())
    jsteps = [jax.jit(jtrainer.make_train_step(jc, opt, plan, accum_steps=a))
              for a in (2, 1)]
    state = {"params": jp, "opt": opt.init(jp)}
    want = []
    for jstep, b in zip(jsteps, batches):
        state, m = jstep(state, b)
        want.append(float(m["loss"]))
    topt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    p = tree_map(lambda t: t.clone(), tp)
    tstate = {"params": p, "opt": topt.init(p)}
    got = []
    for a, b in zip((2, 1), batches):
        tstate, m = trainer.make_train_step(tc, topt, accum_steps=a)(tstate, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
