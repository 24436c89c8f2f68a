"""Training step builder (counterpart of ``repro.train.trainer``'s pjit
mode on one device).

``make_train_step`` differentiates ``transformer.loss_fn`` with autograd and
applies an ``optim`` rule in place. With ``accum_steps > 1`` the global batch
is split into microbatches run one after another with f32 gradient
accumulation, which shrinks the activations' live range by about
``accum_steps``.

The paper mode (``make_paper_train_step``) is data-parallel SGD with an
explicit gradient allreduce over a ``torch.distributed`` process group —
one of the survey's ring/tree/butterfly/Rabenseifner schedules
(``core.collectives``) — with optional gradient compression and error
feedback (``core.compression``): the survey's distributed-SGD pipeline made
concrete (§5.1, §2.5, §6.3).

Left out: the sharding plan (``state_shardings``, ``jit_train_step``),
which comes with ``core/parallelism.py`` (ROADMAP A15).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import collectives as coll
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
        t = torch.as_tensor(v, device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


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
    token embedding of an untied model fed "embeds" (musicgen's stub)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    paths, leaves = zip(*leaves_with_path(live))
    loss = T.loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_from_leaves(zip(paths, grads))


def make_train_step(cfg, optimizer, *, accum_steps: int = 1):
    """train_step(state, batch) -> (state, {"loss": f32 scalar tensor}).
    batch: {"tokens" or "embeds", "labels"} (B, S[, D]) and optional
    "positions" ((3, B, S) under M-RoPE), numpy or tensors, B divisible by
    `accum_steps`. The params and optimizer state are updated in place."""

    def train_step(state, batch):
        params = state["params"]
        device = _device(params)
        batch = _on(batch, device)
        if accum_steps == 1:
            loss, grads = _grads_of(cfg, params, batch)
        else:
            mb = _batch_rows(batch) // accum_steps
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=device), params)
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
