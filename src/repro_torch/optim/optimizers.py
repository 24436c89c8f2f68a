"""Weight update rules — survey Table 3 (counterpart of
``repro.optim.optimizers``).

Each rule is an ``Optimizer(name, init, update)`` over nested dicts of
tensors. Master weights and moments are f32 whatever the params' dtype
(mixed-precision training); params are the master cast back to their dtype.

Unlike the reference's pure functions, ``update(grads, state, params)``
works IN PLACE under ``torch.no_grad()``: it rewrites the f32 state tensors
and copies the new master into the param tensors, and returns the same
``params`` and ``state`` objects. At full width that saves a second copy of
the f32 state. ``state["step"]`` is a Python int (no device sync).

Table 3 rules:
  sgd        w ← w − η·g
  adaptive   w ← w − η_t·g                       (η_t decays)
  momentum   w ← w + μ(w − w_prev) − η·g          [Qian 1999]
  nesterov   v ← μv − η·∇ℓ(w + μv);  w ← w + v    [Nesterov 1983]
  adagrad    A += g²;  w ← w − η·g/√(A+ε)         [Duchi et al. 2011]
  rmsprop    A' = βA' + (1−β)g²;  w ← w − η·g/√(A'+ε)   [Hinton 2012]
  adam       m̂, v̂ bias-corrected first/second moments  [Kingma & Ba 2015]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import leaves_with_path, tree_leaves, tree_map


def _f32(tree):
    return tree_map(lambda p: p.detach().float().clone(), tree)


def _zeros(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable     # params -> state
    update: Callable   # (grads, state, params) -> (params, state), in place


def make_optimizer(name: str, lr: float = 1e-3, *, momentum: float = 0.9,
                   beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                   decay_steps: int = 10_000, weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> Optimizer:
    """Build an update rule. `grad_clip` applies global-norm clipping
    (survey §3.2, gradient clipping for RNNs / async updates)."""

    def each(fn, state, grads, *keys):
        """fn(master, g, *state leaves) per leaf, one leaf at a time, with
        g the leaf's gradient in f32, scaled by min(1, clip / ‖g‖) under
        global-norm clipping (a leaf's f32 gradient lives only while that
        leaf is updated)."""
        scale = None
        if grad_clip:
            gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                for g in tree_leaves(grads)))
            scale = torch.clamp(grad_clip / (gn + 1e-12), max=1.0)
        trees = [state["master"]] + [state[k] for k in keys]
        for path, g in leaves_with_path(grads):
            g = g.float() if scale is None else g.float() * scale
            leaves = [_get(t, path) for t in trees]
            fn(leaves[0], g, *leaves[1:])

    def finish(params, state):
        for path, p in leaves_with_path(params):
            p.copy_(_get(state["master"], path))
        state["step"] += 1
        return params, state

    # ------------------------------------------------------------------ rules
    if name in ("sgd", "adaptive"):
        def init(params):
            return {"master": _f32(params), "step": 0}

        @torch.no_grad()
        def update(grads, state, params):
            rate = lr
            if name == "adaptive":
                rate = lr / (1.0 + state["step"] / decay_steps)

            def rule(w, g):
                w.copy_(w - rate * g)
            each(rule, state, grads)
            return finish(params, state)

    elif name == "momentum":
        def init(params):
            return {"master": _f32(params), "prev": _f32(params), "step": 0}

        @torch.no_grad()
        def update(grads, state, params):
            def rule(w, g, wp):
                new = w + momentum * (w - wp) - lr * g
                wp.copy_(w)
                w.copy_(new)
            each(rule, state, grads, "prev")
            return finish(params, state)

    elif name == "nesterov":
        def init(params):
            return {"master": _f32(params), "vel": _zeros(params), "step": 0}

        @torch.no_grad()
        def update(grads, state, params):
            # the caller evaluates grads at the lookahead point w + μv by
            # reading `lookahead(state)`; on plain grads this is momentum
            def rule(w, g, vel):
                vel.copy_(momentum * vel - lr * g)
                w.copy_(w + vel)
            each(rule, state, grads, "vel")
            return finish(params, state)

    elif name in ("adagrad", "rmsprop"):
        def init(params):
            return {"master": _f32(params), "accum": _zeros(params),
                    "step": 0}

        @torch.no_grad()
        def update(grads, state, params):
            def rule(w, g, a):
                if name == "adagrad":
                    a.copy_(a + torch.square(g))
                    w.copy_(w - lr * g / torch.sqrt(a + eps))
                else:
                    a.copy_(beta2 * a + (1 - beta2) * torch.square(g))
                    w.copy_(w - lr * g / (torch.sqrt(a) + eps))
            each(rule, state, grads, "accum")
            return finish(params, state)

    elif name == "adam":
        def init(params):
            return {"master": _f32(params), "m": _zeros(params),
                    "v": _zeros(params), "step": 0}

        @torch.no_grad()
        def update(grads, state, params):
            t = state["step"] + 1.0
            bc1 = 1.0 - beta1 ** t
            bc2 = 1.0 - beta2 ** t

            def rule(w, g, m, v):
                m.copy_(beta1 * m + (1 - beta1) * g)
                v.copy_(beta2 * v + (1 - beta2) * torch.square(g))
                step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if weight_decay:
                    step = step + lr * weight_decay * w
                w.copy_(w - step)
            each(rule, state, grads, "m", "v")
            return finish(params, state)

    else:
        raise ValueError(f"unknown optimizer {name!r}")

    return Optimizer(name, init, update)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def lookahead(state, momentum=0.9):
    """Nesterov lookahead point w + μv (Table 3's ∇ℓ(w^(t) − μ·v_t, z))."""
    return tree_map(lambda w, v: w + momentum * v, state["master"],
                    state["vel"])


OPTIMIZERS = ("sgd", "adaptive", "momentum", "nesterov", "adagrad", "rmsprop",
              "adam")
