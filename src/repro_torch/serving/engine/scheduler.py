"""Continuous-batching scheduler: request queue, block-budget admission with
prefix-cache matching, chunked prefill interleaved with decode.

Ported near verbatim from ``repro.serving.engine.scheduler`` (host numpy
code), with the oversubscription policy hooks (optimistic admission, block
growth, preemption). A temperature request carries its own CPU
``torch.Generator`` (the reference's PRNG key), so a preempted and resumed
request draws the same noise sequence.

Block budgets are provider-aware (`block_cost`, injected by the Engine from
models.state_providers): sliding-window sequences reserve at most the ring
length, recurrent (ssm) sequences reserve zero blocks and are admitted on
slot availability alone, and hybrid configs charge the max over their layer
kinds since every layer shares one block table.

Policy (one engine `step()`):
  1. ADMIT  — pop waiting requests while a slot AND their block reservation
              are available. With prefix caching, the incoming prompt's
              longest cached block-aligned prefix is aliased read-only into
              the new table (refcount +1 per block) and the reservation is
              charged ONLY for the uncached tail + generation budget, so a
              cache hit both skips prefill compute and admits earlier.
  2. PREFILL — pack up to `prefills_per_step` prompt chunks of admitted
              requests (chunk = `prefill_chunk` tokens, starting at the
              first uncached token) into ONE segment-masked device call,
              padded to a declared (chunk-length x num-segments) bucket so
              steady-state serving only ever hits AOT-warmed executables.
              Long prompts never block the decode batch for more than one
              chunk.
  3. DECODE — one batched token step over every DECODING slot.

Copy-on-write rule: if the cached prefix covers the WHOLE prompt, the last
matched block is not aliased — the engine copies its device content into a
private block and re-prefills only the final prompt token into that copy, so
the first-token logits exist and no shared block is ever written. Decode
appends always land in privately-owned blocks (the tail reservation), so
shared blocks stay read-only by construction.

Oversubscription (``engine.oversub``, enabled by passing an OversubConfig +
SLOPolicy): admission reserves only ``block_cost(prefill_len + 1)`` — the
prompt KV plus the first decode write — gated by the policy's watermark,
and the queue is ordered by (priority, rid) instead of pure FCFS. Decode
blocks are appended per step by the ENGINE (which owns the device tables);
when the pool can't satisfy an append the engine preempts a victim through
``preempt()``: fully written blocks of ``prompt + generated`` are published
to the prefix index first, every block is released, and the request rolls
back to WAITING with ``prefill_tokens = prompt + generated`` so ordinary
(cached-prefix) re-prefill resumes it bit-identically — under greedy
decoding the continuation argmaxes over identical KV, so outputs match the
never-preempted run exactly.

Requests are pure host-side state; all device work goes through the Engine's
step functions.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serving.engine.paged_cache import BlockPool, prefix_hashes

WAITING, PREFILLING, DECODING, FINISHED = "waiting", "prefilling", "decoding", "finished"


def chunk_buckets_for(prefill_chunk: int, declared=()) -> tuple:
    """Normalize declared chunk-length buckets: sorted unique values, each in
    (0, prefill_chunk], with prefill_chunk itself always present so every
    chunk has a bucket. An empty declaration means one bucket of the full
    chunk length (exactly the pre-bucket behavior)."""
    buckets = sorted(set(int(b) for b in declared))
    for b in buckets:
        if not 0 < b <= prefill_chunk:
            raise ValueError(
                f"prefill bucket {b} outside (0, prefill_chunk="
                f"{prefill_chunk}]")
    if prefill_chunk not in buckets:
        buckets.append(prefill_chunk)
    return tuple(buckets)


def segment_buckets_for(prefills_per_step: int, packed: bool = True) -> tuple:
    """Segment-count buckets: powers of two below prefills_per_step plus
    prefills_per_step itself, so the largest packed call has an exact bucket
    and partial batches pad at most 2x. Unpacked engines only dispatch
    G=1 calls."""
    if not packed:
        return (1,)
    out, g = [], 1
    while g < prefills_per_step:
        out.append(g)
        g *= 2
    out.append(prefills_per_step)
    return tuple(out)


@dataclass
class PrefillBatch:
    """One packed prefill dispatch: up to `num_segments` prompt chunks (one
    per request) padded to the declared (chunk_len x num_segments) bucket.
    The engine pads missing segments with valid=0 and an out-of-range slot
    sentinel so they never touch sequence state."""
    segments: list                      # [(request, start, valid)]
    chunk_len: int                      # C bucket >= every segment's valid
    num_segments: int                   # G bucket >= len(segments)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S0,) int32
    max_new: int
    temperature: float = 0.0
    generator: Optional[object] = None  # CPU torch.Generator, temperature > 0
    stop_token: Optional[int] = None
    state: str = WAITING
    slot: int = -1
    prefilled: int = 0                  # prefill tokens already in the pool
    out_tokens: list = field(default_factory=list)
    # prefix caching (filled in at submit/admit time)
    block_hashes: list = field(default_factory=list)   # chained, full blocks
    shared_blocks: int = 0              # cached blocks aliased at admission
    cow_src: Optional[int] = None       # block to copy-on-write, if any
    registered: int = 0                 # prefix blocks published to the index
    # oversubscription / preemption
    priority: int = 0                   # class, LOWER is more important
    arrive_t: Optional[float] = None    # submit timestamp (TTFT SLO gating)
    preempts: int = 0                   # times this request was evicted
    got_first: bool = False             # first_token already emitted (so a
                                        #   resumed prefill completion is an
                                        #   ordinary decode_token)
    prefill_tokens: Optional[np.ndarray] = None   # resume: prompt + generated
    snapshot: Optional[list] = None     # per-layer provider state snapshot
    snapshot_len: int = 0               # tokens the snapshot state covers

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefill_src(self) -> np.ndarray:
        """Tokens to prefill: the prompt, or prompt + already-generated
        tokens after a preemption (recompute-by-re-prefill)."""
        return self.prompt if self.prefill_tokens is None else self.prefill_tokens

    @property
    def prefill_len(self) -> int:
        return int(self.prefill_src.shape[0])

    @property
    def seq_tokens(self) -> int:
        """Total tokens whose state exists once the NEXT decode write lands:
        prompt plus everything generated (the growth/rollback unit)."""
        return self.prompt_len + len(self.out_tokens)

    @property
    def done(self) -> bool:
        if len(self.out_tokens) >= self.max_new:
            return True
        return (self.stop_token is not None and self.out_tokens
                and self.out_tokens[-1] == self.stop_token)


class Scheduler:
    def __init__(self, pool: BlockPool, *, max_slots: int,
                 max_blocks_per_seq: int, prefill_chunk: int,
                 prefills_per_step: int = 1, prefix_caching: bool = True,
                 block_cost=None, chunk_buckets=None, segment_buckets=None,
                 packed_prefill: bool = True, policy=None):
        self.pool = pool
        self.max_slots = max_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefill_chunk = prefill_chunk
        self.prefills_per_step = prefills_per_step
        self.prefix_caching = prefix_caching
        self.packed_prefill = packed_prefill
        # oversubscription: an engine.oversub.SLOPolicy switches admission to
        # optimistic prompt-only reservation (watermark-gated) and the queue
        # to (priority, rid) order; None keeps the conservative
        # full-reservation FCFS scheduler.
        self.policy = policy
        self.chunk_buckets = (tuple(chunk_buckets) if chunk_buckets
                              else chunk_buckets_for(prefill_chunk))
        self.segment_buckets = (
            tuple(segment_buckets) if segment_buckets
            else segment_buckets_for(prefills_per_step, packed_prefill))
        # per-sequence block cost: total tokens -> blocks to reserve. The
        # engine injects the provider-aware cost (max over layer state
        # kinds: full = ceil(total/bs), ring = capped at the ring length,
        # recurrent = 0); the default is the uniform full-attention cost.
        self.block_cost = block_cost or pool.blocks_for
        self.waiting: deque = deque()
        self.running: dict = {}         # rid -> Request (PREFILLING|DECODING)
        self._free_slots = list(range(max_slots - 1, -1, -1))

    # ------------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        need = self.block_cost(req.prompt_len + req.max_new)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"request {req.rid}: needs {need} blocks > table width "
                f"{self.max_blocks_per_seq}; raise max_blocks_per_seq/block_size")
        if need > self.pool.num_blocks:
            raise ValueError(f"request {req.rid}: larger than the whole pool")
        if self.prefix_caching:
            req.block_hashes = prefix_hashes(req.prefill_src,
                                             self.pool.block_size)
        self._enqueue(req)

    def _enqueue(self, req: Request) -> None:
        """Queue placement. Conservative mode is FCFS (append; rids are
        monotone). With a policy, order by (priority, rid): classes first,
        and within a class a preempted request's original rid makes resumed
        work senior to newer arrivals."""
        if self.policy is None:
            self.waiting.append(req)
            return
        key = (req.priority, req.rid)
        for i, other in enumerate(self.waiting):
            if (other.priority, other.rid) > key:
                self.waiting.insert(i, req)
                return
        self.waiting.append(req)

    def _admit_need(self, req: Request) -> int:
        """Blocks to reserve at admission. Conservative: the whole
        prompt + max_new span (an admitted request always completes).
        Optimistic (policy set): only the prefill tokens plus the first
        decode write — generation grows on demand, preemption reclaims."""
        if self.policy is None:
            return self.block_cost(req.prompt_len + req.max_new)
        return self.block_cost(req.prefill_len + 1)

    def _admit_plan(self, req: Request):
        """(matched, cow, need) for admitting `req` right now: the aliasable
        cached chain (minus a copy-on-write source when it covers the whole
        prefill), and the total block reservation."""
        matched = (self.pool.match_prefix(req.block_hashes)
                   if self.prefix_caching else [])
        cow = None
        if matched and len(matched) * self.pool.block_size == req.prefill_len:
            # whole prefill cached: don't alias the last block — the engine
            # copies it and re-runs the final token there to produce the
            # first-token logits (copy-on-write)
            cow = matched[-1]
            matched = matched[:-1]
        return matched, cow, self._admit_need(req)

    def _may_admit(self, matched: list, need: int) -> bool:
        if self.policy is None:
            return self.pool.admit_feasible(matched, need - len(matched))
        return self.policy.may_admit(
            self.pool, need - len(matched), self.pool.revive_count(matched),
            len(self.running))

    def can_admit_head(self) -> bool:
        """Would the queue head be admitted by the next `admit()` call?
        (The priority-preemption probe: False + a weaker victim running
        means eviction can unblock the head.)"""
        if not self.waiting:
            return True
        if not self._free_slots:
            return False
        matched, _, need = self._admit_plan(self.waiting[0])
        return self._may_admit(matched, need)

    def admit(self) -> list:
        """Admission by free-block budget. Conservative mode reserves blocks
        for the whole sequence (prompt + max_new) up front — with no
        preemption this guarantees an admitted request always runs to
        completion. Optimistic mode (policy set) reserves only the prefill
        span + 1 under the policy watermark. The reservation is the
        provider-aware `block_cost` (ring layers cap at the ring length,
        recurrent layers reserve nothing). Cached prefix blocks are aliased
        instead of allocated, so the budget only charges the uncached
        tail."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            matched, cow, need = self._admit_plan(req)
            if not self._may_admit(matched, need):
                break                   # in-order: don't starve the head
            self.waiting.popleft()
            if self.prefix_caching:
                self.pool.note_prefix_lookup(
                    len(matched) + (1 if cow is not None else 0))
            if matched:
                self.pool.share(req.rid, matched)
            self.pool.alloc(req.rid, need - len(matched))
            req.shared_blocks = len(matched)
            req.cow_src = cow
            req.prefilled = (req.prefill_len - 1 if cow is not None
                             else len(matched) * self.pool.block_size)
            # shared blocks (and the CoW source's key) are already indexed
            req.registered = len(matched) + (1 if cow is not None else 0)
            req.slot = self._free_slots.pop()
            req.state = PREFILLING
            self.running[req.rid] = req
            admitted.append(req)
        return admitted

    def register_prefilled(self, req: Request) -> None:
        """Publish the request's fully-prefilled prefix blocks to the prefix
        index (chained hashes) so concurrent and future requests can alias
        them. First writer wins on each key."""
        if not self.prefix_caching:
            return
        row = self.pool.table(req.rid)
        full = min(req.prefilled, req.prefill_len) // self.pool.block_size
        while req.registered < min(full, len(req.block_hashes)):
            i = req.registered
            self.pool.register(req.rid, row[i], req.block_hashes[i])
            req.registered += 1

    def growth_need(self, req: Request, extra: int = 0) -> int:
        """Fresh blocks `req` must append before its next decode write
        lands (0 when the current table already covers it). Provider-aware:
        ring layers stop growing once the ring is full, recurrent layers
        never grow. ``extra`` widens the horizon past the one-token write —
        a speculative verify step commits up to qlims tokens at once, so
        the engine asks for qlims-1 extra."""
        return max(0, self.block_cost(req.seq_tokens + extra)
                   - len(self.pool.table(req.rid)))

    def grow(self, req: Request, extra: int = 0) -> list:
        """Append the blocks `growth_need` asks for (caller checked
        feasibility / preempted victims first). Returns the new block ids
        so the engine can extend the device table row."""
        need = self.growth_need(req, extra)
        return self.pool.append(req.rid, need) if need else []

    def preempt(self, req: Request) -> None:
        """Victim rollback: publish every fully written block of
        ``prompt + generated`` to the prefix index, release all blocks and
        the slot, and requeue the request as WAITING with
        ``prefill_tokens = prompt + generated`` so the ordinary
        (cached-prefix) admission path resumes it. The caller (engine) must
        have materialized ``out_tokens`` to concrete ints — and captured any
        provider snapshot — BEFORE calling; registration precedes the free
        so refcount-zero blocks park content-intact on the cold end of the
        free list and resume can alias them back."""
        if req.rid not in self.running:
            raise ValueError(f"preempt of non-running request {req.rid}")
        # tokens whose KV is actually written: everything prefilled while
        # PREFILLING; one behind prompt+generated while DECODING (the last
        # generated token is the pending input — its KV doesn't exist yet)
        covered = (req.seq_tokens - 1 if req.state == DECODING
                   else req.prefilled)
        if req.out_tokens:
            req.prefill_tokens = np.concatenate(
                [req.prompt, np.asarray(req.out_tokens, np.int32)])
        if self.prefix_caching:
            req.block_hashes = prefix_hashes(req.prefill_src,
                                             self.pool.block_size)
            row = self.pool.table(req.rid)
            full = min(covered // self.pool.block_size,
                       len(req.block_hashes), len(row))
            for i in range(req.registered, full):
                # first writer wins; a block matched at admission is already
                # indexed under the SAME chained hash (register no-ops)
                self.pool.register(req.rid, row[i], req.block_hashes[i])
        self.pool.evict_seq(req.rid)
        self._free_slots.append(req.slot)
        del self.running[req.rid]
        req.state = WAITING
        req.slot = -1
        req.prefilled = 0
        req.shared_blocks = 0
        req.cow_src = None
        req.registered = 0
        req.preempts += 1
        self._enqueue(req)

    def _chunk_bucket(self, valid: int) -> int:
        """Smallest declared chunk bucket covering `valid` tokens (always
        exists: prefill_chunk is declared and valid <= prefill_chunk)."""
        for c in self.chunk_buckets:
            if c >= valid:
                return c
        raise AssertionError(f"no chunk bucket >= {valid}")

    def _segment_bucket(self, n: int) -> int:
        """Smallest declared segment bucket covering `n` chunks (always
        exists: prefills_per_step is declared and n <= prefills_per_step)."""
        for g in self.segment_buckets:
            if g >= n:
                return g
        raise AssertionError(f"no segment bucket >= {n}")

    def next_prefills(self) -> list:
        """PrefillBatch objects to dispatch this step. Collects up to
        `prefills_per_step` (request, start, valid) prompt chunks, then packs
        them all into ONE batch at the smallest declared
        (chunk-length x num-segments) bucket — chunk_len covers the largest
        valid in the batch, num_segments covers the chunk count. Unpacked
        mode returns one G=1 batch per chunk (still bucket-padded, so the
        same AOT-warmed executables serve both modes)."""
        work = []
        for req in self.running.values():
            if len(work) >= self.prefills_per_step:
                break
            if req.state == PREFILLING:
                start = req.prefilled
                valid = min(self.prefill_chunk, req.prefill_len - start)
                work.append((req, start, valid))
        if not work:
            return []
        if self.packed_prefill:
            return [PrefillBatch(
                work, self._chunk_bucket(max(v for _, _, v in work)),
                self._segment_bucket(len(work)))]
        return [PrefillBatch([w], self._chunk_bucket(w[2]), 1) for w in work]

    def decode_batch(self) -> list:
        return [r for r in self.running.values() if r.state == DECODING]

    def finish(self, req: Request) -> None:
        req.state = FINISHED
        self.pool.free_seq(req.rid)
        self._free_slots.append(req.slot)
        del self.running[req.rid]
        req.slot = -1

    # --------------------------------------------------------------- status
    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def occupancy(self) -> float:
        """Fraction of slots doing useful DECODE work right now. Slots still
        prefilling contribute nothing to the decode batch, so they are
        excluded — this matches the engine's `engine_occupancy_sum`, which
        accumulates decode_batch / max_slots per decode step."""
        return sum(1 for r in self.running.values()
                   if r.state == DECODING) / self.max_slots
