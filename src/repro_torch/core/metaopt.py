"""Meta-optimization — survey §6.5: hyper-parameter search as embarrassingly
parallel training agents.

* `grid_search` (§6.5.2 "the prominent method … parameter sweeps"):
  exhaustive sweep, trivially parallel (each config is an independent agent).
* `random_search`: samples log-uniform configs.
* `population_based_training` (Jaderberg et al. 2017, Fig 29): a population
  of agents trains in parallel; every `ready` steps an agent *exploits* (a
  random opponent's weights+hypers replace its own if the opponent is
  better) and *explores* (perturbs the copied hyper-parameters). Decentral,
  nondeterministic-communication topology — the survey's closing example of
  concurrency in meta-optimization.

All utilities take a `train_eval(hypers, steps, state) -> (state, score)`
callback, so they compose with any substrate trainer. NumPy only: the port's
own copy of ``repro.core.metaopt``, so that the port imports nothing of the
JAX package.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np


def grid_search(train_eval, grid: dict, steps: int):
    """grid: {name: [values]}. Returns (best_hypers, best_score, table)."""
    keys = list(grid)
    table = []
    best = (None, -math.inf)
    for combo in itertools.product(*(grid[k] for k in keys)):
        hypers = dict(zip(keys, combo))
        _, score = train_eval(hypers, steps, None)
        table.append((hypers, score))
        if score > best[1]:
            best = (hypers, score)
    return best[0], best[1], table


def random_search(train_eval, space: dict, steps: int, trials: int, seed=0):
    """space: {name: (lo, hi)} sampled log-uniformly."""
    rng = np.random.default_rng(seed)
    best = (None, -math.inf)
    table = []
    for _ in range(trials):
        hypers = {k: float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
                  for k, (lo, hi) in space.items()}
        _, score = train_eval(hypers, steps, None)
        table.append((hypers, score))
        if score > best[1]:
            best = (hypers, score)
    return best[0], best[1], table


@dataclass
class PBTAgent:
    hypers: dict
    state: object
    score: float = -math.inf


def population_based_training(train_eval, init_hypers, *, population=4,
                              rounds=5, steps_per_round=10, perturb=1.25,
                              seed=0):
    """Fig 29's explore/exploit loop. init_hypers: list of dicts (len =
    population). Returns (best agent, history)."""
    rng = np.random.default_rng(seed)
    agents = [PBTAgent(dict(h), None) for h in init_hypers]
    history = []
    for r in range(rounds):
        for a in agents:
            a.state, a.score = train_eval(a.hypers, steps_per_round, a.state)
        ranked = sorted(agents, key=lambda a: a.score)
        history.append([(dict(a.hypers), a.score) for a in agents])
        # bottom quartile exploits a random top-quartile agent, then explores
        q = max(1, population // 4)
        for loser in ranked[:q]:
            winner = ranked[-1 - rng.integers(q)]
            loser.state = winner.state
            loser.hypers = {
                k: v * (perturb if rng.random() < 0.5 else 1.0 / perturb)
                for k, v in winner.hypers.items()}
    best = max(agents, key=lambda a: a.score)
    return best, history
