"""Speculative decoding for the paged serving engine (port of
``repro.serving.engine.spec``).

Decode is a sequential-depth bottleneck on memory-bound hardware, so spend
redundant parallel work — verify K draft tokens in ONE multi-query
attention sweep — to cut depth by the accepted run length:

  * ``SpecConfig`` — engine-facing knob (``EngineConfig.spec``). Only ``k``
    reaches the device (verify width and ring slack); the drafter is
    host-only state.
  * ``Drafter`` protocol + implementations. Drafting is pure host work
    between device steps: ``propose(rid, context, n)`` guesses the next n
    tokens of a request's stream given every token known so far (prompt ++
    emitted). ``NgramDrafter`` is the self-drafting prompt-lookahead
    default (no second model); ``DraftModelDrafter`` drafts with a small
    model's greedy ``serve.generate``; ``ReplayDrafter`` replays known
    continuations (the high-acceptance limit).
  * ``verify_step`` — embed the K draft tokens, run the multi-query verify
    through every layer (``transformer.paged_verify_step``) and compute the
    greedy acceptance run on the device; nothing is read back. Paged KV
    needs no rollback: writes beyond the per-slot ``qlims`` horizon go to
    the scratch block, and the next verify step rewrites the positions a
    rejection left stale — masked in the interim by each query's causal
    bound — so pool contents stay canonical for the committed prefix.
    Recurrent slabs roll back exactly: the verify keeps the state after
    each draft, and ``state_providers.select_checkpoint`` writes the
    accepted one.

Acceptance rule (greedy): verify feeds ``[pending, d1 .. d_{K-1}]`` where
``pending`` is the last emitted (true) token and ``d_i`` are draft guesses.
With greedy outputs ``g_0 .. g_{K-1}``, the step emits ``g_0 .. g_{a-1}``
where ``a - 1`` is the longest prefix with ``d_i == g_{i-1}`` — one
guaranteed token plus every verified guess, so a ranges 1..K and greedy
streams equal one-token-at-a-time decoding.

Draft state (the per-request lookahead cursors) lives ONLY here, in each
drafter's ``_draft_state``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.models import state_providers as SP
from repro_torch.models import transformer as T


# ------------------------------------------------------------------ drafters
@runtime_checkable
class Drafter(Protocol):
    """Host-side draft-token source. ``context`` is every token of the
    request's stream known so far (prompt ++ emitted outputs, 1-D int
    array); ``propose`` returns exactly ``n`` int32 guesses for the next n
    stream positions. ``forget`` drops any per-request state (request
    finished — its stream may be re-drafted from scratch)."""

    def propose(self, rid: int, context, n: int) -> np.ndarray: ...

    def forget(self, rid: int) -> None: ...


class NgramDrafter:
    """Self-drafting n-gram / prompt-lookahead: find the most recent earlier
    occurrence of the stream's current n-gram suffix and propose the tokens
    that followed it. Falls back to repeating the last token (still
    verified, so wrong guesses only cost acceptance).

    ``_draft_state[rid]`` caches the source cursor of the last match so an
    accepted run keeps streaming from the same earlier span without
    re-scanning."""

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError(f"ngram order must be >= 1, got {n}")
        self.n = int(n)
        self._draft_state: dict = {}

    def _match_at(self, ctx, src: int, m: int) -> bool:
        return src >= m and np.array_equal(ctx[src - m:src], ctx[len(ctx) - m:])

    def propose(self, rid, context, n):
        ctx = np.asarray(context)
        L = len(ctx)
        out = np.full((n,), int(ctx[-1]), np.int32)
        m = min(self.n, L - 1)
        if m < 1:
            return out
        src = None
        hint = self._draft_state.get(rid)
        if hint is not None and hint < L and self._match_at(ctx, hint, m):
            src = hint
        if src is None:
            pat = ctx[L - m:]
            for e in range(L - 2, m - 2, -1):     # newest earlier match wins
                if e - m + 1 < 0:
                    break
                if np.array_equal(ctx[e - m + 1:e + 1], pat):
                    src = e + 1
                    break
        if src is None:
            self._draft_state.pop(rid, None)
            return out
        take = ctx[src:src + n]
        out[:len(take)] = take
        self._draft_state[rid] = src + n          # cursor if fully accepted
        return out

    def forget(self, rid):
        self._draft_state.pop(rid, None)


class DraftModelDrafter:
    """Draft with a small model's greedy continuation. Reference-grade:
    each call re-prefills the full context through ``serve.generate`` —
    correct and simple, but the n-gram drafter is the fast path. The draft
    model needs nothing in common with the target beyond the vocab; it
    runs on its params' device."""

    def __init__(self, cfg, params):
        self.cfg = cfg
        self.params = params
        self._draft_state: dict = {}

    def propose(self, rid, context, n):
        from repro_torch.serving import serve   # serve imports this package
        out = serve.generate(self.cfg, self.params,
                             np.asarray(context, np.int32)[None], max_new=n,
                             temperature=0.0)
        return out[0].cpu().numpy().astype(np.int32)

    def forget(self, rid):
        self._draft_state.pop(rid, None)


class ReplayDrafter:
    """Oracle drafter replaying known continuations — the high-acceptance
    limit of a perfectly aligned draft model: record each request's
    expected stream (prompt ++ reference output) with ``remember``, then
    every proposal is the true continuation."""

    def __init__(self):
        self._draft_state: dict = {}

    def remember(self, rid, stream):
        self._draft_state[rid] = np.asarray(stream, np.int32)

    def propose(self, rid, context, n):
        out = np.full((n,), int(np.asarray(context)[-1]), np.int32)
        full = self._draft_state.get(rid)
        L = len(context)
        if full is not None and L < len(full):
            take = full[L:L + n]
            out[:len(take)] = take
        return out

    def forget(self, rid):
        pass    # the remembered streams stay for a later replay


# ------------------------------------------------------------------- config
@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knob for ``EngineConfig.spec``.

    k        — tokens fed to each verify step: 1 pending (true) token plus
               k-1 draft guesses; each step advances a slot by 1..k tokens.
    drafter  — "ngram" (default) or any ``Drafter`` instance, e.g. a
               ``DraftModelDrafter(cfg, params)`` (a name cannot carry the
               draft model, so any other name raises, as the reference's).
    ngram    — suffix order for the built-in n-gram drafter."""
    k: int = 4
    drafter: object = "ngram"
    ngram: int = 3

    def __post_init__(self):
        if not 2 <= self.k <= 32:
            raise ValueError(f"spec k must be in [2, 32], got {self.k}")
        if isinstance(self.drafter, str):
            if self.drafter != "ngram":
                raise ValueError(f"unknown drafter name {self.drafter!r}")
        elif not isinstance(self.drafter, Drafter):
            raise TypeError("drafter must be 'ngram' or implement "
                            "propose/forget (the Drafter protocol)")
        if self.ngram < 1:
            raise ValueError(f"ngram order must be >= 1, got {self.ngram}")

    def build_drafter(self) -> Drafter:
        if isinstance(self.drafter, str):
            return NgramDrafter(self.ngram)
        return self.drafter


# -------------------------------------------------------------- verify step
def verify_step(cfg, params, pool, tokens, block_tables, seq_lens, active,
                qlims):
    """One speculative verify step over the full slot batch; the pools are
    updated in place.

    tokens:   (B, K) int32 — ``[pending, d1 .. d_{K-1}]`` per slot; draft j
              sits at absolute position ``seq_lens[b] + j``.
    seq_lens: (B,) tokens already processed per slot (rows of inactive
              slots are ignored via ``active``).
    qlims:    (B,) accept/write horizon: ``min(K, tokens the request may
              still emit)`` — caps both the KV writes (never past the
              sequence's block reservation) and the accepted count.

    Returns (greedy (B, K), accepts (B,), logits (B, K, V),
    new_seq_lens (B,), pool). ``accepts`` is 0 for inactive slots, else
    1..qlims; slot state (paged KV, ring cursors implied by seq_lens,
    recurrent slabs) advances by exactly ``accepts`` tokens."""
    base = torch.where(active, seq_lens, 0)
    qlims = torch.where(active, qlims, 0)
    lg, aux = T.paged_verify_step(cfg, params, pool, tokens, block_tables,
                                  base, qlims)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)              # (B, K)
    match = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)     # (B, K-1)
    run = torch.cumprod(match, dim=1)
    accepts = (1 + torch.sum(run, dim=1)).to(torch.int32)
    accepts = torch.minimum(accepts, qlims)                       # 0 if inactive
    for name, layer in pool.items():
        if aux[name] is not layer:      # recurrent: roll back to `accepts`
            new = SP.select_checkpoint(aux[name], accepts, layer)
            for k, a in layer.items():
                a.copy_(new[k])
    return greedy, accepts, lg, seq_lens + accepts, pool
