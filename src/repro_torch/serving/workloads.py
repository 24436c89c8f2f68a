"""Synthetic serving workloads (the port's copy of ``repro.serving.workloads``):
chat-shaped mixed lengths, a common system-prompt prefix with unique
suffixes (the prefix-cache sweet spot), repetition-heavy decode traffic for
speculation, and an open-loop Poisson arrival process for overload studies
(lognormal prompt and output lengths, two priority classes; arrival times
in engine-step units).

Seeded and pure: one numpy rng per call, so a (seed, params) pair gives the
identical request list in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Arrival", "mixed_workload", "shared_prefix_workload",
           "spec_workload", "open_loop_arrivals"]


def mixed_workload(n: int = 24, seed: int = 0, vocab: int = 256):
    """Chat-shaped mixed lengths: short prompts (4-31 tokens), skewed
    generation budgets (70% short 8-23, 30% long 48-95). Returns
    (prompts, max_news)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, 32, size=n)
    news = np.where(rng.random(n) < 0.3, rng.integers(48, 96, size=n),
                    rng.integers(8, 24, size=n))
    prompts = [rng.integers(0, vocab, size=int(l)).astype(np.int32)
               for l in lens]
    return prompts, [int(m) for m in news]


def shared_prefix_workload(n: int = 24, seed: int = 0, prefix_len: int = 96,
                           vocab: int = 256):
    """Shared-prefix traffic: one common system prompt + short unique
    suffixes, short generations (prefill-dominated). Returns (prompts,
    max_news, prefix)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=prefix_len).astype(np.int32)
    prompts, news = [], []
    for _ in range(n):
        tail = rng.integers(0, vocab,
                            size=int(rng.integers(4, 17))).astype(np.int32)
        prompts.append(np.concatenate([prefix, tail]))
        news.append(int(rng.integers(8, 17)))
    return prompts, news, prefix


def spec_workload(n: int = 8, seed: int = 0, vocab: int = 256):
    """Speculation-friendly decode-heavy traffic: short prompts built from
    small repeating token patterns (period 2-4) and long generation budgets,
    so the run is dominated by decode steps and the n-gram drafter's
    prompt-lookahead has literal earlier occurrences to extend. Returns
    (prompts, max_news)."""
    rng = np.random.default_rng(seed)
    prompts, news = [], []
    for _ in range(n):
        period = int(rng.integers(2, 5))
        pat = rng.integers(0, vocab, size=period).astype(np.int32)
        length = int(rng.integers(8, 17))
        prompts.append(np.tile(pat, length // period + 1)[:length])
        news.append(int(rng.integers(48, 97)))
    return prompts, news


@dataclass(frozen=True)
class Arrival:
    """One open-loop request: submit `prompt` for `max_new` tokens at
    priority `priority` once the engine reaches step `step`."""
    step: int
    prompt: np.ndarray
    max_new: int
    priority: int


def _lognormal_len(rng, mean: float, lo: int, hi: int, sigma: float) -> int:
    """Heavy-tailed length with the requested mean: lognormal keeps a long
    right tail (the occasional huge request that ties resources up) while
    most draws sit well below the mean."""
    mu = np.log(mean) - 0.5 * sigma * sigma   # E[lognormal(mu, s)] = mean
    return int(np.clip(round(rng.lognormal(mu, sigma)), lo, hi))


def open_loop_arrivals(n: int, *, seed: int = 0, overload: float = 2.0,
                       max_slots: int = 8, prompt_mean: float = 12.0,
                       prompt_max: int = 32, out_mean: float = 24.0,
                       out_max: int = 96, sigma: float = 0.7,
                       hi_priority_frac: float = 0.2,
                       vocab: int = 256) -> list:
    """Poisson arrivals at `overload` times the engine's decode capacity.

    The arrival rate in requests/step is ``overload * max_slots /
    out_mean`` — each request will eventually demand ~`out_mean` decode
    tokens and the engine can emit at most `max_slots` tokens/step, so
    `overload` > 1 means the offered token load exceeds what decode can
    drain and a backlog must form. Prompt/output lengths are lognormal
    (heavy-tailed) with the given means; `hi_priority_frac` of requests are
    class 0 (interactive), the rest class 1 (batch). Returns Arrivals
    sorted by step."""
    if overload <= 0:
        raise ValueError(f"overload must be positive, got {overload}")
    rng = np.random.default_rng(seed)
    rate = overload * max_slots / out_mean          # requests per step
    t = 0.0
    out = []
    for _ in range(n):
        t += rng.exponential(1.0 / rate)
        prompt_len = _lognormal_len(rng, prompt_mean, 1, prompt_max, sigma)
        out.append(Arrival(
            step=int(t),
            prompt=rng.integers(0, vocab, size=prompt_len).astype(np.int32),
            max_new=_lognormal_len(rng, out_mean, 1, out_max, sigma),
            priority=0 if rng.random() < hi_priority_frac else 1))
    return out
