"""The traffic generators: one seed gives the same inputs, another seed
other inputs of the same sizes."""
import json
from collections import Counter

import numpy as np
import pytest

from bench import traffic
from bench.harness import BENCH

MIX = json.loads((BENCH / "traffic" / "chat-sessions64.json").read_text())
BIG = 2**31 + 987_654_321          # seeds past 32 signed bits


def served(seed, n=6):
    """Each client's first n prompts and answer lengths, the answers
    served as token id 7 repeated."""
    t = traffic.ChatSessions(MIX, seed, 32_000)
    out = []
    for c in range(MIX["clients"]):
        reqs = []
        for _ in range(n):
            key, prompt, n_new = t.next_turn(c)
            t.answered(key, prompt, [7] * n_new)
            reqs.append((key, prompt, n_new))
        out.append(reqs)
    return t, out


def test_chat_same_seed_same_turns():
    _, a = served(BIG)
    _, b = served(BIG)
    for ca, cb in zip(a, b):
        for (ka, pa, na), (kb, pb, nb) in zip(ca, cb):
            assert ka == kb and na == nb and np.array_equal(pa, pb)


def test_chat_other_seed_other_tokens_same_sizes():
    ta, a = served(BIG)
    tb, b = served(BIG + 1)
    assert ta.plan == tb.plan and ta.start == tb.start
    assert [[(k, len(p), n) for k, p, n in c] for c in a] == \
        [[(k, len(p), n) for k, p, n in c] for c in b]
    assert len(Counter(x[2:] for p in ta.plan for x in p)) > MIX["clients"]
    assert not np.array_equal(a[0][0][1][:8], b[0][0][1][:8])


def test_chat_sizes_within_the_mix_and_first_turn_cut():
    t = traffic.ChatSessions(MIX, BIG, 32_000)
    f, x, o = MIX["first_message"], MIX["next_message"], MIX["answer"]
    for c in range(MIX["clients"]):
        for i in range(2 * len(t.plan[c])):
            _, turn, msg, ans, past = t.sizes(c, i)
            lo, hi = (f if turn == 0 else x)["min"], (f if turn == 0
                                                     else x)["max"]
            assert lo <= msg <= hi and o["min"] <= ans <= o["max"]
            assert (past == 0) == (turn == 0)
            # a request's conversation and answer fit the context
            assert past + msg + ans <= MIX["max_context"]
        assert t.sizes(c, 0)[3] <= t.plan[c][t.start[c]][3]
        assert t.sizes(c, len(t.plan[c]))[3] == t.plan[c][t.start[c]][3]


def test_chat_turns_carry_their_conversation():
    t = traffic.ChatSessions(MIX, BIG, 32_000)
    history, again = {}, 0
    for i in range(3 * MIX["turns"]):
        key, prompt, n_new = t.next_turn(0)
        if key in history:
            # the earlier turns and their served answers, then a new message
            h = history[key]
            assert len(prompt) > len(h) and np.array_equal(prompt[:len(h)], h)
            again += 1
        answer = np.arange(n_new, dtype=np.int32) + i
        t.answered(key, prompt, answer)
        history[key] = np.concatenate([prompt, answer])
    assert again >= MIX["turns"]


def test_chat_schedule_has_the_trace_medians():
    # the Azure 2023 conversation trace's request medians: prompt 1020
    # tokens with the conversation's history, output 129
    t = traffic.ChatSessions(MIX, BIG, 32_000)
    prompts, answers = [], []
    for c in range(MIX["clients"]):
        for i in range(len(t.plan[c])):
            _, _, msg, ans, past = t.sizes(c, i + 1)
            prompts.append(past + msg)
            answers.append(ans)
    assert np.median(prompts) == pytest.approx(1020, rel=0.03)
    assert np.median(answers) == pytest.approx(129, rel=0.03)


def test_lognormal_lengths_have_their_mean():
    rng = np.random.default_rng(0)
    xs = [traffic.lognormal_len(rng, 1024, 0.8, 1, 10**9)
          for _ in range(20000)]
    assert np.mean(xs) == pytest.approx(1024, rel=0.03)


def test_lm_batch_seeded_and_rows_differ():
    a = traffic.lm_batch(BIG, 5, 4, 64, 64_000)
    b = traffic.lm_batch(BIG, 5, 4, 64, 64_000)
    c = traffic.lm_batch(BIG, 6, 4, 64, 64_000)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert len({r.tobytes() for r in a["tokens"]}) == 4
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    # the order-2 rule holds where no noise token was drawn
    t = a["tokens"].astype(np.int64)
    rule = (31 * t[:, 1:-1] + 17 * t[:, :-2]) % 64_000 == t[:, 2:]
    assert rule.mean() > 0.8
