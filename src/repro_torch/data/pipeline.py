"""Deterministic synthetic data pipeline (the port's copy of
``repro.data.pipeline``, numpy only; ``shard_batch`` is left out: the port
trains on one device).

Two sources:
  * `SyntheticLM` — a seeded Markov-ish token stream with learnable structure
    (each token is a noisy function of the previous ones), so small models
    show a *decreasing* loss curve — needed to validate convergence claims
    (minibatch effect Fig 7, compression §6.3, staleness §6.1).
  * `copy_task`   — sequence copy; sanity-checkable exactly.

Batches are `{"tokens": (B, S) int32, "labels": (B, S) int32}`, labels being
the next-token shift. Iteration is epoch-based with per-epoch shuffling
(survey §2.1: "shuffling the dataset S before the loop").
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    """Order-2 synthetic language: t_{i+1} = (a·t_i + b·t_{i-1} + noise) mod V."""

    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 noise: float = 0.1, num_docs: int = 4096):
        self.vocab = vocab_size
        self.seq = seq_len
        self.noise = noise
        self.num_docs = num_docs
        self.rng = np.random.default_rng(seed)
        self.a, self.b = 31, 17

    def _doc(self, rng):
        t = np.empty(self.seq + 1, np.int64)
        t[0] = rng.integers(self.vocab)
        t[1] = rng.integers(self.vocab)
        for i in range(1, self.seq):
            nxt = (self.a * t[i] + self.b * t[i - 1]) % self.vocab
            if rng.random() < self.noise:
                nxt = rng.integers(self.vocab)
            t[i + 1] = nxt
        return t

    def batches(self, batch_size: int, steps: int):
        """Yield `steps` batches deterministically within one process: batch
        s is seeded with ``hash(("batch", s))``, which Python randomises per
        process unless PYTHONHASHSEED is set (as in the reference)."""
        for s in range(steps):
            rng = np.random.default_rng((hash(("batch", s)) & 0xFFFFFFFF))
            docs = np.stack([self._doc(rng) for _ in range(batch_size)])
            yield {
                "tokens": docs[:, :-1].astype(np.int32),
                "labels": docs[:, 1:].astype(np.int32),
            }


def copy_task(batch_size: int, seq_len: int, vocab: int, seed: int = 0):
    """tokens = [pattern, pattern]; labels shifted — learnable by one layer."""
    rng = np.random.default_rng(seed)
    half = seq_len // 2
    pat = rng.integers(1, vocab, (batch_size, half))
    tokens = np.concatenate([pat, pat], axis=1).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels}

