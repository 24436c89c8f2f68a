"""Model consolidation — survey §6.4: the inconsistent end of the parameter-
consistency spectrum (Fig 28) (counterpart of ``repro.core.consolidation``).

* Ensemble learning (§6.4.1): separately trained members, averaged
  predictions — "a completely parallel process, requiring no communication
  between the agents".
* Knowledge distillation (§6.4.1) [Ba & Caruana; Hinton et al.]: a student
  trained to mimic ensemble logits.
* Model averaging (§6.4.2): one-shot (ParallelSGD [Zinkevich et al.]) and
  periodic averaging; Elastic Averaging SGD [Zhang et al. 2015] with the
  elastic force ρ(w_i − w̄) between agents and the center variable.

Params are trees of tensors (nested dicts); gradients come from
``torch.autograd.grad``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.consistency import _sgd, _value_and_grad
from repro_torch.tree import tree_map


# ------------------------------------------------------------------ ensembles
def ensemble_logits(apply_fn, members, x):
    """Average member predictions: f(x) = 1/m Σ f_{w_i}(x) (§6.4.1)."""
    return torch.mean(torch.stack([apply_fn(w, x) for w in members]), dim=0)


def average_params(members):
    """One-shot parameter averaging (ParallelSGD consolidation)."""
    return tree_map(lambda *ws: sum(ws) / len(ws), *members)


# --------------------------------------------------------------- distillation
def distill_loss(student_logits, teacher_logits, temperature=2.0):
    """KL(teacher‖student) at temperature T (Hinton et al. 2015), up to the
    teacher's entropy."""
    t = F.softmax(teacher_logits / temperature, dim=-1)
    ls = F.log_softmax(student_logits / temperature, dim=-1)
    return -torch.mean(torch.sum(t * ls, dim=-1)) * temperature ** 2


# ---------------------------------------------------------------------- EASGD
def easgd_round(agents, center, grads, *, lr=0.1, rho=0.1):
    """One EASGD update for every agent and the center variable w̄:

        w_i ← w_i − lr·(g_i + ρ(w_i − w̄))
        w̄   ← w̄ + lr·ρ·Σ_i (w_i − w̄)

    The elastic force lets agents explore away from the center while pulling
    the ensemble together — communication happens only through w̄ (a PS).
    """
    new_agents = []
    pull = tree_map(torch.zeros_like, center)
    for w, g in zip(agents, grads):
        diff = tree_map(lambda a, c: a - c, w, center)
        new_agents.append(tree_map(lambda a, g_, d: a - lr * (g_ + rho * d),
                                   w, g, diff))
        pull = tree_map(lambda p, d: p + d, pull, diff)
    new_center = tree_map(lambda c, p: c + lr * rho * p, center, pull)
    return new_agents, new_center


def periodic_average_sgd(loss_fn, params0, batches, *, agents=4, lr=0.1,
                         avg_every=10):
    """§6.4.2 periodic model averaging: m independent SGD streams averaged
    every k steps. Returns (final averaged params, per-step mean losses)."""
    ws = [params0 for _ in range(agents)]
    losses = []
    for t, batch in enumerate(batches):
        step_losses = []
        for i in range(agents):
            li, gi = _value_and_grad(loss_fn, ws[i], batch)
            ws[i] = _sgd(ws[i], gi, lr)
            step_losses.append(float(li))
        losses.append(sum(step_losses) / agents)
        if (t + 1) % avg_every == 0:
            avg = average_params(ws)
            ws = [avg for _ in range(agents)]
    return average_params(ws), losses
