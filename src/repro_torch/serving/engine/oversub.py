"""Oversubscription policy for the continuous-batching engine: optimistic
admission, on-demand block growth, victim preemption, and SLO-aware
scheduling (the port's copy of ``repro.serving.engine.oversub``, host code).

The conservative scheduler reserves blocks for a request's ENTIRE
``prompt + max_new`` span at admission — safe (an admitted request always
runs to completion) but wildly pessimistic at load: a request that declares
``max_new=256`` and stops after 12 tokens parks 15 unused blocks for its
whole lifetime, and the pool admits a fraction of the sequences it could
actually hold. The paper's concurrency analysis (§5-6) frames serving as
exactly this scheduling trade — device saturation vs. bounded per-sample
latency — and the optimistic/rollback taxonomy applies verbatim: allocate
lazily, detect conflict (an append that finds the pool full), roll a victim
back, recompute cheaply.

With ``EngineConfig.oversub = OversubConfig(...)`` the engine switches to:

  * **Optimistic admission** — reserve only ``block_cost(prompt + 1)``
    blocks (the prompt KV plus the first decode write); the generation
    budget is NOT reserved. A watermark gates admission so a slice of the
    pool stays free for decode growth: new sequences are admitted only
    while post-admission utilization stays at or under ``admit_watermark``
    (always admitting into an idle engine, so a single over-watermark
    request cannot deadlock).
  * **Per-step growth** — before each decode dispatch the engine appends
    the block(s) a sequence's next token needs (``BlockPool.append``), in
    the policy's protection order (strongest request first).
  * **Victim preemption** — when an append cannot be satisfied, the policy
    picks victims in preemption order; the engine registers every fully
    written block of ``prompt + generated`` in the prefix index FIRST (so
    the freed blocks park content-intact on the cold end of the free list),
    then evicts the victim's blocks and rolls it back to WAITING. Resume
    re-prefills ``prompt + generated`` through the ordinary cached-prefix
    admission path — on an all-full-attention config the recompute is
    usually one tail chunk.
  * **SLO-aware step shaping** — ``SLOPolicy`` chooses prefill-vs-decode
    per step from two signals: the head-of-queue wait against the TTFT
    target, and the recent per-step latency (a 1-token/step proxy for TPOT)
    against the TPOT target. Under TPOT pressure or above-watermark pool
    utilization the engine runs decode-only steps; a starving queue head
    (TTFT at risk) overrides and forces prefill through.

Ordering discipline (this is what makes preemption livelock-free): the
policy defines ONE total order over running requests — priority class
first, then invested work (generated tokens), then age — used forwards to
pick who grows first and backwards to pick who is evicted first. The
maximal request under this order is never chosen as a victim while anything
else is running, so it strictly advances and the system always makes
progress; within a class the least-invested victim loses the least
recompute. Requests preempted mid-flight keep their original arrival id as
the age tie-break, so resumed work is senior to newer traffic of the same
class.

Per-provider rollback protocol (``models.state_providers``): preemption is
evict-and-recompute —

  * paged ``full`` KV: freed blocks ARE the rollback; fully written blocks
    are prefix-registered first so resume aliases them back.
  * ``ring`` KV: the write cursor is a pure function of the token count
    (``(p // bs) % R``, ``RingKVProvider.write_cursor``), so re-prefilling
    ``prompt + generated`` rebuilds the ring, wrap-for-wrap, at the
    identical cursor. An int8 pool re-quantizes the same K/V vectors to the
    same int8 values and scales.
  * recurrent slabs (``rwkv`` / ``mamba``): ``preempt_checkpoint`` copies
    the victim's slab rows to the host; on resume the engine restores the
    snapshot (``resume_restore``) and — when EVERY provider restored state
    (``OversubConfig.snapshot_resume``, pure-recurrent configs) — skips the
    token re-scan, resuming decode at the checkpointed length. Hybrids
    recompute instead: the attention KV must be rebuilt anyway, and the
    slab prefill loop rebuilds the recurrent state from zero.

What the step EWMA sees on the card. The engine feeds ``note_step`` the
host wall time of each ``step()``. With ``EngineConfig.step_timing`` every
device call is synchronized, so that time includes the step's device work.
Without it the host runs ahead of the card: a step's wall time is the
host's issue time, until the launch queue fills and the host waits, or a
host read (a stop token, a verify step's acceptance, a preemption's token
materialization) waits for the card. So a host-ahead EWMA reads low while
the queue fills and then tracks the device's step rate; a TPOT target is
held against that.

Everything here is host-side policy; device work stays in the Engine's
step functions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = ["OversubConfig", "SLOPolicy"]


@dataclass(frozen=True)
class OversubConfig:
    """Knobs for optimistic admission + preemption. Frozen, so it can ride
    inside the frozen ``EngineConfig`` (pure host policy)."""

    admit_watermark: float = 0.90   # admit while post-admission pool
                                    #   utilization stays <= this fraction
    ttft_slo_s: float = 0.5         # target time-to-first-token; a queue
                                    #   head older than this forces prefill
    tpot_slo_s: float = 0.05        # target per-token latency; step EWMA
                                    #   above it defers prefill (decode-only)
    priority_preemption: bool = True  # a blocked higher-class queue head may
                                    #   evict strictly-lower-class victims
    step_ewma: float = 0.2          # weight of the newest step duration in
                                    #   the TPOT-proxy moving average
    snapshot_resume: bool = True    # pure-recurrent configs restore slab
                                    #   snapshots instead of re-prefilling

    def __post_init__(self):
        if not 0.0 < self.admit_watermark <= 1.0:
            raise ValueError(
                f"admit_watermark {self.admit_watermark} outside (0, 1]")
        if not 0.0 < self.step_ewma <= 1.0:
            raise ValueError(f"step_ewma {self.step_ewma} outside (0, 1]")


class SLOPolicy:
    """Scheduling decisions under oversubscription. Pure host state: a
    step-duration EWMA (the TPOT proxy — the engine emits at most one token
    per slot per step, so per-step wall time bounds per-token latency) and
    the ordering/gating rules. Deterministic given its inputs, so tests can
    drive it with a fake clock."""

    def __init__(self, cfg: OversubConfig,
                 clock: Callable[[], float] = time.perf_counter):
        self.cfg = cfg
        self.clock = clock
        self.step_ewma_s: Optional[float] = None    # None until first step

    # ------------------------------------------------------------ ordering
    @staticmethod
    def protection_key(req):
        """Total order, strongest first: highest priority class (lowest
        number), then most generated tokens (most work to lose), then
        oldest arrival. Growth is granted in this order and the head of it
        is never victimized while anything weaker runs — the progress
        guarantee."""
        return (req.priority, -len(req.out_tokens), req.rid)

    @classmethod
    def victim_order(cls, reqs) -> list:
        """Weakest first — the exact reverse of ``protection_key``: lowest
        class, then least invested (cheapest recompute), then youngest."""
        return sorted(reqs, key=cls.protection_key, reverse=True)

    def pick_victim(self, candidates, *, max_priority: Optional[int] = None):
        """The next request to evict, or None. ``max_priority`` restricts
        victims to classes STRICTLY weaker (larger number) than it — the
        priority-preemption rule for a blocked queue head."""
        pool = [r for r in candidates
                if max_priority is None or r.priority > max_priority]
        order = self.victim_order(pool)
        return order[0] if order else None

    # ----------------------------------------------------------- admission
    def may_admit(self, pool, fresh_blocks: int, revived_blocks: int,
                  running: int) -> bool:
        """Watermark-gated optimistic admission: the reservation itself must
        fit AND post-admission utilization must stay at or under the
        watermark, keeping headroom for decode growth. An idle engine
        always admits (a request whose prompt alone exceeds the watermark
        must still be servable — it fits the pool, validated at submit)."""
        if fresh_blocks + revived_blocks > pool.num_free:
            return False
        if running == 0:
            return True
        used_after = (pool.num_blocks - pool.num_free) \
            + fresh_blocks + revived_blocks
        return used_after <= self.cfg.admit_watermark * pool.num_blocks

    # --------------------------------------------------------- step shaping
    def note_step(self, dt_s: float) -> None:
        """Feed one engine-step wall duration into the TPOT-proxy EWMA."""
        if self.step_ewma_s is None:
            self.step_ewma_s = dt_s
        else:
            a = self.cfg.step_ewma
            self.step_ewma_s = a * dt_s + (1.0 - a) * self.step_ewma_s

    def allow_prefill(self, *, head_wait_s: Optional[float],
                      decoding: int, pool_util: float) -> bool:
        """Prefill-vs-decode for this step. Prefill is deferred when the
        decode side is under pressure — pool above the admission watermark
        (appends are about to evict) or the step EWMA above the TPOT
        target — EXCEPT when nothing is decoding (deferring would deadlock)
        or the queue head has waited past the TTFT target (p99 TTFT is the
        SLO prefill protects)."""
        if decoding == 0:
            return True
        if head_wait_s is not None and head_wait_s >= self.cfg.ttft_slo_s:
            return True
        if pool_util > self.cfg.admit_watermark:
            return False
        if (self.step_ewma_s is not None
                and self.step_ewma_s > self.cfg.tpot_slo_s):
            return False
        return True
