"""Port parity of the survey §6 core off the kernel path: the consistency
spectrum (``repro_torch.core.consistency``, §6.1), model consolidation
(``consolidation``, §6.4) and meta-optimization (``metaopt``, §6.5) against
``repro.core`` on the reference tests' quadratic problems, plus the
reference's own convergence claims run on the port.

Tolerances (float32): trajectories rtol 1e-5 / atol 1e-6 (the quadratic's
gradient sums a 20-term product in another order on each side; the
iterations are contractions at these learning rates, so the differences
stay at rounding level); metaopt is numpy on both sides and gives equal
picks and tables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consistency as JCONS
from repro.core import consolidation as JCON
from repro.core import metaopt as JMO
from repro_torch.core import consistency as CONS
from repro_torch.core import consolidation as CON
from repro_torch.core import metaopt as MO

pytestmark = pytest.mark.port

TOL = dict(rtol=1e-5, atol=1e-6)


def quadratic(n_steps=200, dim=20, seed=0):
    """tests/test_consistency.py's problem, as numpy: (A, b, batches, w*)."""
    A = np.diag(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (dim,), minval=0.5, maxval=3.0)))
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (dim,)))
    batches = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                           (n_steps, dim)) * 0.05)
    return A, b, batches, np.linalg.solve(A, b)


def _losses(A, b):
    jA, jb, tA, tb = jnp.asarray(A), jnp.asarray(b), torch.tensor(A), \
        torch.tensor(b)

    def jloss(params, batch):
        w = params["w"]
        return 0.5 * w @ jA @ w - (jb + batch) @ w

    def tloss(params, batch):
        w = params["w"]
        return 0.5 * w @ tA @ w - (tb + batch) @ w

    return jloss, tloss


# --------------------------------------------------------------- §6.1
@pytest.mark.parametrize("staleness,lr", [(0, 0.1), (2, 0.1), (4, 0.05),
                                          (8, 0.1)])
def test_stale_sgd_matches_the_reference(staleness, lr):
    A, b, batches, opt = quadratic(n_steps=150)
    jloss, tloss = _losses(A, b)
    jw, jl = JCONS.simulate_stale_sgd(jloss, {"w": jnp.zeros(20)},
                                      jnp.asarray(batches), lr=lr,
                                      staleness=staleness)
    tw, tl = CONS.simulate_stale_sgd(tloss, {"w": torch.zeros(20)},
                                     torch.tensor(batches), lr=lr,
                                     staleness=staleness)
    np.testing.assert_allclose(tw["w"].numpy(), np.asarray(jw["w"]), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_async_agents_match_the_reference():
    A, b, batches, opt = quadratic(n_steps=300)
    jloss, tloss = _losses(A, b)
    jw, jl = JCONS.simulate_async_agents(jloss, {"w": jnp.zeros(20)},
                                         jnp.asarray(batches), lr=0.05,
                                         agents=4)
    tw, tl = CONS.simulate_async_agents(tloss, {"w": torch.zeros(20)},
                                        torch.tensor(batches), lr=0.05,
                                        agents=4)
    np.testing.assert_allclose(tw["w"].numpy(), np.asarray(jw["w"]), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert np.linalg.norm(tw["w"].numpy() - opt) < 0.5


def test_staleness_spectrum_holds_on_the_port():
    """The reference's §6.1 claims: sync converges, bounded staleness still
    converges, more staleness is worse at a fixed lr, and stale gradients at
    an aggressive lr diverge where synchronous ones do not."""
    A, b, batches, opt = quadratic(n_steps=150)
    _, tloss = _losses(A, b)

    def err(lr, s):
        w, _ = CONS.simulate_stale_sgd(tloss, {"w": torch.zeros(20)},
                                       torch.tensor(batches), lr=lr,
                                       staleness=s)
        return float(np.linalg.norm(w["w"].numpy() - opt))

    assert err(0.1, 0) < 0.2 and err(0.05, 4) < 0.4
    errs = [err(0.1, s) for s in (0, 2, 8)]
    assert errs[0] <= errs[1] * 1.05 and errs[1] <= errs[2] * 1.05
    stale = err(0.55, 8)
    assert stale > 2 * err(0.55, 0) or not np.isfinite(stale)


# --------------------------------------------------------------- §6.4
def test_ensemble_average_and_distill_match_the_reference():
    rng = np.random.default_rng(0)
    members = [{"w": rng.standard_normal(8).astype(np.float32)}
               for _ in range(5)]
    x = rng.standard_normal((16, 8)).astype(np.float32)
    jm = [{"w": jnp.asarray(m["w"])} for m in members]
    tm = [{"w": torch.tensor(m["w"])} for m in members]
    np.testing.assert_allclose(
        CON.ensemble_logits(lambda w, x_: x_ @ w["w"], tm,
                            torch.tensor(x)).numpy(),
        np.asarray(JCON.ensemble_logits(lambda w, x_: x_ @ w["w"], jm,
                                        jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(CON.average_params(tm)["w"].numpy(),
                               np.asarray(JCON.average_params(jm)["w"]),
                               **TOL)
    s, t = (rng.standard_normal((4, 10)).astype(np.float32) for _ in "st")
    for temp in (1.0, 2.0):
        np.testing.assert_allclose(
            float(CON.distill_loss(torch.tensor(s), torch.tensor(t), temp)),
            float(JCON.distill_loss(jnp.asarray(s), jnp.asarray(t), temp)),
            **TOL)


def test_easgd_rounds_match_the_reference():
    A, b, _, sol = quadratic(dim=12)
    jA, tA = jnp.asarray(A), torch.tensor(A)
    jb, tb = jnp.asarray(b), torch.tensor(b)
    jag = [{"w": jnp.zeros(12) + 0.5 * i} for i in range(4)]
    tag = [{"w": torch.zeros(12) + 0.5 * i} for i in range(4)]
    jc, tc = {"w": jnp.zeros(12)}, {"w": torch.zeros(12)}
    for _ in range(300):
        jgr = [{"w": jA @ w["w"] - jb} for w in jag]
        tgr = [{"w": tA @ w["w"] - tb} for w in tag]
        jag, jc = JCON.easgd_round(jag, jc, jgr, lr=0.1, rho=0.05)
        tag, tc = CON.easgd_round(tag, tc, tgr, lr=0.1, rho=0.05)
    np.testing.assert_allclose(tc["w"].numpy(), np.asarray(jc["w"]), **TOL)
    for ja, ta in zip(jag, tag):
        np.testing.assert_allclose(ta["w"].numpy(), np.asarray(ja["w"]),
                                   **TOL)
    assert np.linalg.norm(tc["w"].numpy() - sol) < 0.3


def test_periodic_averaging_matches_the_reference():
    A, b, batches, sol = quadratic(n_steps=60, dim=12)
    jloss, tloss = _losses(A, b)
    jw, jl = JCON.periodic_average_sgd(jloss, {"w": jnp.zeros(12)},
                                       jnp.asarray(batches), agents=3,
                                       lr=0.1, avg_every=10)
    tw, tl = CON.periodic_average_sgd(tloss, {"w": torch.zeros(12)},
                                      torch.tensor(batches), agents=3,
                                      lr=0.1, avg_every=10)
    np.testing.assert_allclose(tw["w"].numpy(), np.asarray(jw["w"]), **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert np.linalg.norm(tw["w"].numpy() - sol) < 0.4 and tl[-1] < tl[0]


# --------------------------------------------------------------- §6.5
def _train_eval():
    """A numpy trainer on the quadratic: the same callback for both
    packages' searches."""
    A, b, _, _ = quadratic(dim=12)

    def loss(w):
        return 0.5 * w @ A @ w - b @ w

    def train_eval(hypers, steps, state):
        w = np.zeros(12) if state is None else state
        for _ in range(steps):
            w = w - hypers["lr"] * (A @ w - b)
        return w, -float(loss(w))

    return train_eval


def test_grid_search_picks_as_the_reference():
    te = _train_eval()
    grid = {"lr": [1e-4, 1e-2, 0.2, 2.0], "unused": [1, 2]}
    got = MO.grid_search(te, grid, steps=40)
    want = JMO.grid_search(te, grid, steps=40)
    assert got[0] == want[0] and got[0]["lr"] == 0.2
    assert got[1] == want[1] and got[2] == want[2]


@pytest.mark.parametrize("seed", [0, 3])
def test_random_search_picks_as_the_reference(seed):
    te = _train_eval()
    got = MO.random_search(te, {"lr": (1e-4, 1.0)}, steps=30, trials=8,
                           seed=seed)
    want = JMO.random_search(te, {"lr": (1e-4, 1.0)}, steps=30, trials=8,
                             seed=seed)
    assert got == want and len(got[2]) == 8


def test_population_based_training_picks_as_the_reference():
    te = _train_eval()
    init = [{"lr": v} for v in (1e-4, 1e-3, 0.05, 0.3)]
    best, hist = MO.population_based_training(te, init, population=4,
                                              rounds=6, steps_per_round=15)
    jbest, jhist = JMO.population_based_training(te, init, population=4,
                                                 rounds=6, steps_per_round=15)
    assert hist == jhist
    assert best.hypers == jbest.hypers and best.score == jbest.score
    assert max(s for _, s in hist[-1]) >= max(s for _, s in hist[0])
    assert min(h["lr"] for h, _ in hist[-1]) > 1e-4
