"""Model-consistency spectrum (survey §6.1): sync / stale-sync / async
(counterpart of ``repro.core.consistency``).

The semantics are simulated deterministically: K virtual training agents
step round-robin; each agent computes its gradient against a parameter copy
that is `staleness` updates old (a bounded gradient-delay queue). This
reproduces the survey's staleness-vs-convergence trade-off (Fig 28):

  staleness = 0              synchronous data-parallel SGD
  staleness <= s (bounded)   stale-synchronous parallel (SSP) [Ho et al. 2013]
  staleness ~ K (unbounded)  asynchronous / Downpour-style [Dean et al. 2012]

The reference's ``lax.scan`` is a Python loop here, and its
``jax.value_and_grad`` is ``torch.autograd.grad``. Params are trees of
tensors (nested dicts); batches are tensors stacked on axis 0.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves_with_path, tree_from_leaves, tree_map


def _value_and_grad(loss_fn, params, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    paths, leaves = zip(*leaves_with_path(live))
    loss = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_from_leaves(zip(paths, grads))


def _sgd(params, grads, lr):
    return tree_map(lambda p, g: p.detach() - lr * g, params, grads)


def simulate_stale_sgd(loss_fn, params0, batches, *, lr=0.1, staleness=0,
                       agents=4):
    """Run len(batches) SGD updates where each gradient is computed at the
    parameter version from `staleness` steps ago (survey §6.1's w^(t−τ)).

    loss_fn(params, batch) -> scalar. Returns (final params, losses per
    step as one tensor)."""
    params = params0
    hist = [params0] * (staleness + 1)          # oldest first
    losses = []
    for batch in batches:
        loss, grads = _value_and_grad(loss_fn, hist[0], batch)
        params = _sgd(params, grads, lr)
        hist = hist[1:] + [params]
        losses.append(loss)
    return params, torch.stack(losses)


def simulate_async_agents(loss_fn, params0, batches, *, lr=0.1, agents=4):
    """Downpour-style simulation: `agents` workers each hold a local copy
    fetched when they last pushed; pushes happen round-robin, so every
    gradient arrives exactly `agents−1` versions stale. Returns (params,
    losses)."""
    params = params0
    local = [params0] * agents
    losses = []
    for t, batch in enumerate(batches):
        a = t % agents
        loss, grads = _value_and_grad(loss_fn, local[a], batch)
        params = _sgd(params, grads, lr)                        # push
        local[a] = params                                       # fetch
        losses.append(loss)
    return params, torch.stack(losses)
