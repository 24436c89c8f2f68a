"""Training steps (counterpart of ``repro.train.trainer``).

``make_train_step`` differentiates ``transformer.loss_fn`` with autograd and
applies an ``optim`` rule in place. With ``accum_steps > 1`` the global batch
is split into microbatches run one after another with f32 gradient
accumulation, which shrinks the activations' live range by about
``accum_steps``. Given a sharding plan (``core.parallelism``; the
reference's pjit mode) the step runs on DTensors: the params and optimizer
state placed by `state_shardings`, the batch by the plan's batch specs,
forward and backward inside ``plan_context``; each gradient takes its
parameter's placements (the reduction GSPMD inserts). `jit_train_step`
places a state and a batch and returns the step.

The paper mode (``make_paper_train_step``) is data-parallel SGD with an
explicit gradient allreduce over a ``torch.distributed`` process group —
one of the survey's ring/tree/butterfly/Rabenseifner schedules
(``core.collectives``) — with optional gradient compression and error
feedback (``core.compression``): the survey's distributed-SGD pipeline made
concrete (§5.1, §2.5, §6.3).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import collectives as coll
from repro_torch.core import parallelism as par
from repro_torch.data.pipeline import shard_batch
from repro_torch.models import transformer as T
from repro_torch.tree import leaves_with_path, tree_from_leaves, tree_map


def init_state(cfg, optimizer, *, seed: int = 0, device="cuda"):
    """{"params", "opt"}: seeded random params (``transformer.init_params``)
    on `device` and the optimizer's state for them. Runs on the card unless
    the caller asks for ``device="cpu"``; raises where there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_state runs on the card by default and this "
                           "machine has none; pass device='cpu' to train on "
                           "the CPU")
    params = T.init_params(cfg, seed=seed, device=device)
    return {"params": params, "opt": optimizer.init(params)}


def _on(batch, device):
    """A host (numpy) or device batch on `device`, integer arrays (tokens,
    labels, positions) as int64."""
    out = {}
    for k, v in batch.items():
        t = v if par.is_dtensor(v) else torch.as_tensor(v, device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def state_shardings(state, plan):
    """The specs of a train state {"params", "opt"} under `plan`: the
    params by ``plan.param_specs``; every optimizer entry shaped like the
    params by ``plan.opt_specs`` (ZeRO-1 splits these over 'data'); any
    other entry (the step count) replicated. ``par.shard_tree(state, specs,
    mesh)`` places a state by them."""
    params = state["params"]
    p_specs = plan.param_specs(params)
    o_specs = plan.opt_specs(params)

    def structure(tree):
        return tree_map(lambda _: None, tree)

    def opt_entry(v):
        if structure(v) == structure(params):
            return o_specs
        return tree_map(lambda _: par.P(), v)

    return {"params": p_specs,
            "opt": {k: opt_entry(v) for k, v in state["opt"].items()}}


def _batch_rows(batch):
    """The batch size B: the rows of the labels (or the tokens / embeds),
    never of M-RoPE's (3, B, S) positions."""
    for k in ("labels", "tokens", "embeds"):
        if k in batch:
            return batch[k].shape[0]
    raise KeyError(f"batch has none of labels, tokens, embeds: "
                   f"{sorted(batch)}")


def _rows(batch, lo, hi):
    """Rows lo:hi of every batch entry: axis 0, but axis 1 of M-RoPE's
    (3, B, S) positions (the reference's microbatch split)."""
    return {k: v[:, lo:hi] if k == "positions" and v.dim() == 3 else v[lo:hi]
            for k, v in batch.items()}


def _device(params):
    return leaves_with_path(params)[0][1].device


def _grads_of(cfg, params, batch):
    """(loss, gradient tree) of ``loss_fn`` by autograd. A leaf the loss
    does not reach gets zeros, as ``jax.value_and_grad`` gives it: the
    token embedding of an untied model fed "embeds" (musicgen's stub).
    On DTensor params each gradient is put in its parameter's placements
    and the loss is returned whole, as a plain tensor."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    paths, leaves = zip(*leaves_with_path(live))
    loss = T.loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    if par.is_dtensor(loss):
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if par.is_dtensor(g) else g for g, p in zip(grads, leaves)]
        loss = par.full(loss)
    return loss.detach(), tree_from_leaves(zip(paths, grads))


def make_train_step(cfg, optimizer, plan=None, *, accum_steps: int = 1):
    """train_step(state, batch) -> (state, {"loss": f32 scalar tensor}).
    batch: {"tokens" or "embeds", "labels"} (B, S[, D]) and optional
    "positions" ((3, B, S) under M-RoPE), numpy or tensors, B divisible by
    `accum_steps`. The params and optimizer state are updated in place.

    With a `plan` (``core.parallelism.ShardingPlan`` on a ``DeviceMesh``)
    the step runs under ``plan_context(plan)``: a batch that is not yet
    DTensors is placed by the plan's batch specs (``shard_batch``), the
    state is used as it is placed (`jit_train_step` places it)."""

    def train_step(state, batch):
        params = state["params"]
        device = _device(params)
        if plan is not None:
            batch = shard_batch(_on(batch, device), plan)
        batch = _on(batch, device)
        with par.plan_context(plan):
            if accum_steps == 1:
                loss, grads = _grads_of(cfg, params, batch)
            else:
                mb = _batch_rows(batch) // accum_steps
                loss = torch.zeros((), dtype=torch.float32, device=device)
                grads = tree_map(
                    lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
                for i in range(accum_steps):
                    micro = _rows(batch, i * mb, (i + 1) * mb)
                    loss_i, g_i = _grads_of(cfg, params, micro)
                    loss = loss + loss_i
                    tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
                loss = loss / accum_steps
                grads = tree_map(lambda g: g / accum_steps, grads)
            params, opt = optimizer.update(grads, state["opt"], params)
        return {"params": params, "opt": opt}, {"loss": loss}

    return train_step


def jit_train_step(cfg, optimizer, plan, state, batch=None, *,
                   accum_steps: int = 1):
    """(step, state, batch): the planned step of `make_train_step`, and
    `state` (equal on every rank) placed on the plan's mesh by
    `state_shardings` and `batch` by the plan's batch specs (None stays
    None). The reference's production entry point of the same name."""
    from repro_torch.data.pipeline import shard_batch
    step = make_train_step(cfg, optimizer, plan, accum_steps=accum_steps)
    state = par.shard_tree(state, state_shardings(state, plan), plan.mesh)
    if batch is not None:
        batch = shard_batch(_on(batch, _device(state["params"])), plan)
    return step, state, batch


# ------------------------------------------------------------- paper mode
def make_paper_train_step(cfg, optimizer, group=None, *, algorithm="ring",
                          compression=None):
    """step(state, batch, residual) -> (state, {"loss"}, residual): explicit
    data-parallel SGD over the process group `group` (None: the default
    group) — the counterpart of the reference's ``shard_map`` over the
    mesh's data axis (survey §5.1 + §6.3).

    Each rank takes its contiguous slice of the global batch's rows
    (``P("data")``; axis 1 of M-RoPE's (3, B, S) positions, where the
    reference's ``P("data")`` would cut the stream axis), computes its
    gradients with autograd, compresses them with error feedback when
    `compression` (a ``core.compression.Compressor``) is given — each sent
    leaf cast to its gradient's dtype, the f32 residual, this rank's own,
    updated in place — averages each leaf with ``allreduce_mean(algorithm)``
    (ring|tree|butterfly|rabenseifner|psum) and the loss with ``psum``, and
    applies the optimizer in place.
    `residual` is ``zero_residual(params)`` with a compressor, else unused.
    """

    def step(state, batch, residual):
        params = state["params"]
        P, rank = dist.get_world_size(group), dist.get_rank(group)
        batch = _on(batch, _device(params))
        B = _batch_rows(batch)
        if B % P:
            raise ValueError(f"batch size {B} does not divide into {P} ranks")
        n = B // P
        local = _rows(batch, rank * n, (rank + 1) * n)
        loss, grads = _grads_of(cfg, params, local)
        if compression is not None:
            grads, residual = compression.compress_with_feedback(grads,
                                                                 residual)
        grads = tree_map(lambda g: coll.allreduce_mean(g, group, algorithm),
                         grads)
        loss = coll.allreduce_mean(loss, group, "psum")
        params, opt = optimizer.update(grads, state["opt"], params)
        return {"params": params, "opt": opt}, {"loss": loss}, residual

    return step


def zero_residual(params):
    """The error-feedback residual: f32 zeros of every param's shape."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
