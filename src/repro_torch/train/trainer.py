"""Training step builder (counterpart of ``repro.train.trainer``'s pjit
mode on one device).

``make_train_step`` differentiates ``transformer.loss_fn`` with autograd and
applies an ``optim`` rule in place. With ``accum_steps > 1`` the global batch
is split into microbatches run one after another with f32 gradient
accumulation, which shrinks the activations' live range by about
``accum_steps``.

Left out: the sharding plan (``state_shardings``, ``jit_train_step``) —
the port trains on one device — and the paper mode with explicit
collectives and gradient compression (``make_paper_train_step``,
``zero_residual``), which comes with ``torch.distributed`` (ROADMAP A15).
"""
from __future__ import annotations

import torch

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


def make_train_step(cfg, optimizer, *, accum_steps: int = 1):
    """train_step(state, batch) -> (state, {"loss": f32 scalar tensor}).
    batch: {"tokens", "labels"} (B, S), numpy or tensors, B divisible by
    `accum_steps`. The params and optimizer state are updated in place."""

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        paths, leaves = zip(*leaves_with_path(live))
        loss = T.loss_fn(cfg, live, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_from_leaves(zip(paths, grads))

    def train_step(state, batch):
        params = state["params"]
        device = next(iter(leaves_with_path(params)))[1].device
        batch = _on(batch, device)
        if accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            mb = B // accum_steps
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=device), params)
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, g_i = grads_of(params, micro)
                loss = loss + loss_i
                tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, grads)
        params, opt = optimizer.update(grads, state["opt"], params)
        return {"params": params, "opt": opt}, {"loss": loss}

    return train_step
