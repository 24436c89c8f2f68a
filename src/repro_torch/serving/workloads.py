"""Synthetic serving workloads (the port's copy of the closed-loop generators
in ``repro.serving.workloads``): chat-shaped mixed lengths, and a common
system-prompt prefix with unique suffixes (the prefix-cache sweet spot).

Seeded and pure: one numpy rng per call, so a (seed, params) pair gives the
identical request list in both packages.
"""
from __future__ import annotations

import numpy as np

__all__ = ["mixed_workload", "shared_prefix_workload"]


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
