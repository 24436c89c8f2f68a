"""The general traffic generators. A traffic mix is a JSON file of
parameters under ``bench/traffic/``; its ``driver`` key names the code in
``bench/drivers/`` that offers it to the program.

Every seed gets the same schedule of sizes: the lengths and their order
are drawn once from the mix's own ``size_seed``, and the run's seed draws
the token ids, so runs with different seeds do the same amount of work.
"""
from __future__ import annotations

import numpy as np


def lognormal_len(rng, mean: float, sigma: float, lo: int, hi: int) -> int:
    """A heavy-tailed length with mean `mean` before clipping to [lo, hi]:
    lognormal keeps the long right tail while most draws sit below the
    mean."""
    mu = np.log(mean) - 0.5 * sigma * sigma   # E[lognormal(mu, s)] = mean
    return int(np.clip(round(rng.lognormal(mu, sigma)), lo, hi))


def median_len(rng, spec: dict) -> int:
    """A length from the lognormal of `spec` ({"median", "sigma", "min",
    "max"}), clipped."""
    s = spec["sigma"]
    return lognormal_len(rng, spec["median"] * np.exp(0.5 * s * s), s,
                         spec["min"], spec["max"])


class ChatSessions:
    """Conversations for a closed loop of `clients`. Every request of a
    conversation carries the whole conversation so far: the earlier turns'
    messages and the answers served to them, then the new message. So a
    turn's prompt starts with the last turn's prompt, which the program's
    prefix cache may still hold.

    Each client sends its conversations `interleaved` at a time, one turn
    of each in rotation: a user's next turn waits while the client's other
    conversations take theirs, which stands for the user's think time and
    sets how long a conversation's history has to stay cached. A
    conversation has `turns` turns and ends early where its next turn and
    answer would pass `max_context` tokens.

    Each client starts at a point of its schedule drawn uniformly, so the
    first requests already have the schedule's mix of turns; a turn whose
    conversation has no history yet (it began before the run) gets a
    history of the planned length in random token ids, which no cache
    holds. The client's first answer is cut to a uniform share, so the
    clients fall out of step during the warm-up.

    The sizes, their order and the cuts come from the mix's ``size_seed``:
    every seed serves the same schedule of sizes, and the run's seed draws
    the token ids. After its last conversation a client starts its
    schedule again with new token ids."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), vocab
        rng = np.random.default_rng(mix["size_seed"])
        k = mix["interleaved"]
        # per client, in the order it sends them: (conversation, turn,
        # message length, answer length)
        self.plan = []
        for _ in range(mix["clients"]):
            convs = [self._conversation(rng)
                     for _ in range(mix["conversations_per_client"])]
            order = []
            for g in range(0, len(convs), k):
                group = convs[g:g + k]
                for t in range(max(map(len, group))):
                    order += [(g + i, t) + conv[t]
                              for i, conv in enumerate(group)
                              if t < len(conv)]
            self.plan.append(order)
        u = rng.random((mix["clients"], 2))
        self.start = [int(a * len(p)) for a, p in zip(u[:, 0], self.plan)]
        self.cut = u[:, 1]
        self.sent = [0] * mix["clients"]
        self.history: dict = {}

    def _conversation(self, rng) -> list:
        mix, out, context = self.mix, [], 0
        for t in range(mix["turns"]):
            msg = median_len(rng, mix["first_message" if t == 0
                                      else "next_message"])
            ans = median_len(rng, mix["answer"])
            if out and context + msg + ans > mix["max_context"]:
                break
            context += msg + ans
            out.append((msg, ans))
        return out

    def sizes(self, client: int, i: int):
        """(conversation, turn, message length, answer length, history
        length as planned) of the client's request i, i counted from its
        start in the schedule."""
        plan = self.plan[client]
        j = (self.start[client] + i) % len(plan)
        conv, turn, msg, ans = plan[j]
        past = sum(m + a for c, t, m, a in plan[:j] if c == conv)
        if i == 0:
            ans = max(self.mix["answer"]["min"], round(self.cut[client] * ans))
        return conv, turn, msg, ans, past

    def next_turn(self, client: int):
        """(key, prompt int32 array, answer length) of the client's next
        request: its conversation so far and a new message."""
        i = self.sent[client]
        self.sent[client] += 1
        conv, turn, msg, ans, planned = self.sizes(client, i)
        cycle = (self.start[client] + i) // len(self.plan[client])
        key = (client, cycle, conv)
        rng = np.random.default_rng([self.seed, 1, client, cycle, conv,
                                     turn])
        new = rng.integers(0, self.vocab, size=msg).astype(np.int32)
        past = self.history.pop(key, None)
        if past is None and turn:
            past = rng.integers(0, self.vocab, size=planned).astype(np.int32)
        prompt = new if past is None else np.concatenate([past, new])
        return key, prompt, ans

    def answered(self, key, prompt, tokens) -> None:
        """Keep the conversation's history: the prompt and the tokens
        served to it."""
        self.history[key] = np.concatenate(
            [prompt, np.asarray(tokens, np.int32)])


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             noise: float = 0.1) -> dict:
    """One training batch of the order-2 synthetic language of the port's
    ``SyntheticLM`` (t_{i+1} = 31 t_i + 17 t_{i-1} mod V, a uniform token
    with probability `noise`), every row its own document: {"tokens",
    "labels"} (batch, seq) int32, labels the next token. Seeded by (seed,
    step), so each step's rows differ from every other's."""
    rng = np.random.default_rng([int(seed), 2, int(step)])
    t = np.empty((batch, seq + 1), np.int64)
    t[:, :2] = rng.integers(vocab, size=(batch, 2))
    flip = rng.random((batch, seq + 1)) < noise
    fresh = rng.integers(vocab, size=(batch, seq + 1))
    for i in range(2, seq + 1):
        t[:, i] = np.where(flip[:, i], fresh[:, i],
                           (31 * t[:, i - 1] + 17 * t[:, i - 2]) % vocab)
    return {"tokens": t[:, :-1].astype(np.int32),
            "labels": t[:, 1:].astype(np.int32)}
