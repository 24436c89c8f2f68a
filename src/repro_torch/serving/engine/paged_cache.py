"""Paged KV cache bookkeeping, ported near verbatim from
``repro.serving.engine.paged_cache`` (host numpy code): a fixed pool of
fixed-size blocks, per-sequence block tables, per-block refcounts, and a
prefix index for cross-request KV reuse (vLLM-style PagedAttention memory
management with prefix caching), plus the oversubscription calls
``append`` (on-demand growth) and ``evict_seq`` (victim eviction).

`BlockPool` is pure host-side accounting — the device-side pool tensors live
in the Engine (`models.transformer.init_paged_state`, plus one scratch
block at index `num_blocks` this pool never hands out). The pool is
state-kind agnostic: how many blocks a sequence charges is the caller's
policy (the scheduler's provider-aware `block_cost` — full attention pages
O(S), sliding-window rings cap at ceil(window/bs)+1, recurrent sequences
own zero blocks, `alloc(rid, 0)` just registers the owner so `table` /
`free_seq` stay uniform). A block may be referenced by any number of
sequence tables (shared read-only prompt prefixes); the refcount tracks
exactly how many. Blocks whose refcount drops
to zero but that are registered in the prefix index are NOT lost: they go on
the free list in least-recently-used order with their device content intact,
so a later request with the same prompt prefix can revive them via
`match_prefix` + `share` — and allocation pressure reclaims them LRU-first
(eviction = popping a registered block off the free list). With an empty
index the pool degrades exactly to a plain refcounted allocator.

Free-list discipline (one deque encodes both the reuse preference and the
eviction order):

    appendleft: cached blocks          append/pop (right): plain blocks
    [newest cached ... oldest cached | never used | recently freed plain]
                                                        ^ alloc pops here

Plain (unregistered) frees are reused first; registered blocks are only
reclaimed once no plain block remains, oldest-freed first (LRU).

`defragment` computes a compaction permutation the Engine applies to the
device pools; it rewrites every owner's table consistently under aliasing
(a shared block moves once, every table follows) and preserves the content
and LRU order of cached-free blocks.
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.telemetry import MetricsRegistry


class BlockPoolError(RuntimeError):
    """Invariant violation: double free, unknown owner, over-allocation."""


def prefix_hashes(tokens, block_size: int) -> list:
    """Chained digests, one per FULL block of `tokens`: hashes[i] commits to
    tokens[0 : (i+1)*block_size], so equal hashes imply equal token prefixes
    (up to digest collision) and therefore bitwise-equal KV content."""
    t = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    out, h = [], b""
    for i in range(t.shape[0] // block_size):
        blk = t[i * block_size:(i + 1) * block_size].tobytes()
        h = hashlib.blake2b(h + blk, digest_size=16).digest()
        out.append(h)
    return out


@dataclass
class BlockPool:
    num_blocks: int
    block_size: int
    # metrics go through a telemetry registry (the Engine passes its own so
    # pool counters land in the same snapshot); on_evict lets the owner
    # record an `evict` lifecycle event per reclaimed cached block
    registry: Optional[MetricsRegistry] = None
    on_evict: Optional[Callable[[int], None]] = None
    _free: deque = field(init=False)
    _ref: list = field(init=False)        # block id -> refcount
    _owned: dict = field(init=False)      # rid -> ordered list of block ids
    _index: dict = field(init=False)      # prefix hash -> block id
    _hash_of: dict = field(init=False)    # block id -> prefix hash (inverse)

    def __post_init__(self):
        self._free = deque(range(self.num_blocks - 1, -1, -1))  # pops 0 first
        self._ref = [0] * self.num_blocks
        self._owned = {}
        self._index = {}
        self._hash_of = {}
        self._n_cached_free = 0         # registered blocks on the free list
        if self.registry is None:
            self.registry = MetricsRegistry()
        reg = self.registry
        self._m_lookups = reg.counter(
            "pool_prefix_lookups_total", "prefix-index lookups at admission")
        self._m_hit_blocks = reg.counter(
            "pool_prefix_hit_blocks_total", "cached blocks matched at admission")
        self._m_evictions = reg.counter(
            "pool_evictions_total", "cached-free blocks reclaimed (LRU)")
        self._m_registrations = reg.counter(
            "pool_registrations_total", "blocks published to the prefix index")

    @property
    def stats(self) -> dict:
        """Back-compat snapshot of the registry-backed pool counters (the
        pre-telemetry ad-hoc dict keys). Read-only view: mutate through the
        counters, never through this dict."""
        return {"lookups": self._m_lookups.value,
                "hit_blocks": self._m_hit_blocks.value,
                "evictions": self._m_evictions.value,
                "registrations": self._m_registrations.value}

    def note_prefix_lookup(self, hit_blocks: int) -> None:
        """Record one admission-time prefix lookup that matched `hit_blocks`
        cached blocks (the scheduler calls this only on the attempt that
        admits, so a blocked head request doesn't skew hit rates)."""
        self._m_lookups.inc()
        self._m_hit_blocks.inc(hit_blocks)

    # ------------------------------------------------------------- queries
    @property
    def num_free(self) -> int:
        """Allocatable blocks. Includes refcount-zero cached blocks — they
        hold reusable content but are reclaimed on demand (LRU)."""
        return len(self._free)

    @property
    def num_cached_free(self) -> int:
        """Refcount-zero blocks kept only for their prefix-index content.
        O(1): a maintained counter (validated against a full scan in
        `check()`), not a deque scan."""
        return self._n_cached_free

    @property
    def utilization(self) -> float:
        return 1.0 - self.num_free / self.num_blocks

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_alloc(self, n_blocks: int) -> bool:
        return n_blocks <= self.num_free

    def admit_feasible(self, shared: list, n_fresh: int) -> bool:
        """Can a request alias `shared` (possibly reviving cached-free
        blocks) AND still allocate `n_fresh` fresh blocks?"""
        return n_fresh <= len(self._free) - self.revive_count(shared)

    def revive_count(self, shared: list) -> int:
        """How many of `shared` are cached-FREE (would be revived off the
        free list by `share`, consuming free capacity) as opposed to live.
        Admission policies need the split: revived blocks count against the
        free list but carry content, fresh blocks are the true new demand."""
        return sum(1 for b in shared if self._ref[b] == 0)

    def table(self, rid) -> list:
        """Ordered block ids of a sequence (logical page i -> physical id)."""
        if rid not in self._owned:
            raise BlockPoolError(f"unknown sequence {rid!r}")
        return list(self._owned[rid])

    # ----------------------------------------------------------- mutation
    def alloc(self, rid, n_blocks: int) -> list:
        """Append `n_blocks` fresh private blocks to sequence `rid` (creating
        it). `n_blocks == 0` is valid and registers `rid` with an empty
        table (recurrent-only sequences own no blocks but still free
        uniformly). Popping a cached-free block evicts its prefix-index
        entry."""
        if n_blocks > len(self._free):
            raise BlockPoolError(
                f"need {n_blocks} blocks, only {len(self._free)} free")
        got = []
        for _ in range(n_blocks):
            b = self._free.pop()
            if b in self._hash_of:                      # LRU eviction
                del self._index[self._hash_of.pop(b)]
                self._n_cached_free -= 1
                self._m_evictions.inc()
                if self.on_evict is not None:
                    self.on_evict(b)
            self._ref[b] = 1
            got.append(b)
        self._owned.setdefault(rid, []).extend(got)
        return got

    def append(self, rid, n_blocks: int) -> list:
        """On-demand growth: append `n_blocks` fresh blocks to an EXISTING
        sequence (the oversubscription per-step decode append). Unlike
        `alloc` this never creates an owner — growing a sequence the pool
        has never seen is a bookkeeping bug, not a request."""
        if rid not in self._owned:
            raise BlockPoolError(f"append to unknown sequence {rid!r}")
        return self.alloc(rid, n_blocks)

    def evict_seq(self, rid) -> int:
        """Victim eviction: release every block of a preempted sequence.
        Identical accounting to `free_seq` — callers register the victim's
        fully written prefix blocks FIRST, so refcount-zero registered
        blocks park on the cold end of the free list content-intact and the
        victim's resume can alias them back instead of recomputing."""
        return self.free_seq(rid)

    def share(self, rid, blocks: list) -> None:
        """Alias existing blocks into `rid`'s table (refcount +1 each).
        Blocks must be live (ref > 0) or cached in the prefix index; a
        cached-free block is revived off the free list, content intact."""
        if len(set(blocks)) != len(blocks):
            raise BlockPoolError("share called with duplicate blocks")
        row = self._owned.get(rid, [])
        for b in blocks:                                # validate, no mutation
            if not (0 <= b < self.num_blocks):
                raise BlockPoolError(f"share of invalid block {b}")
            if self._ref[b] == 0 and b not in self._hash_of:
                raise BlockPoolError(f"share of free uncached block {b}")
            if b in row:
                raise BlockPoolError(
                    f"block {b} already in table of {rid!r}")
        self._owned.setdefault(rid, [])
        for b in blocks:
            if self._ref[b] == 0:
                self._free.remove(b)                    # revive, content kept
                self._n_cached_free -= 1                # free+ref0 => cached
            self._ref[b] += 1
            self._owned[rid].append(b)

    def register(self, rid, block: int, key: bytes) -> bool:
        """Publish an owned block under a prefix hash so later requests can
        alias it. First writer wins: if `key` is already indexed (a
        concurrent identical prompt), this is a no-op and the caller's block
        stays private. Returns True iff the block was registered."""
        if rid not in self._owned or block not in self._owned[rid]:
            raise BlockPoolError(f"register: {rid!r} does not own {block}")
        if key in self._index:
            return False
        old = self._hash_of.get(block)
        if old is not None:
            if old == key:
                return False
            raise BlockPoolError(f"block {block} already registered")
        self._index[key] = block
        self._hash_of[block] = key
        self._m_registrations.inc()
        return True

    def match_prefix(self, keys: list) -> list:
        """Longest chain of cached blocks for the given chained prefix
        hashes: walks `keys` in order, stops at the first miss. Pure query —
        the scheduler updates `stats` only on the attempt that admits, so a
        blocked head request retried every step doesn't skew hit rates."""
        got = []
        for k in keys:
            b = self._index.get(k)
            if b is None:
                break
            got.append(b)
        return got

    def free_seq(self, rid) -> int:
        """Release every block of a sequence (refcount -1 each). Double-free
        raises. Blocks hitting refcount zero return to the free list: plain
        blocks at the hot end, prefix-cached blocks at the cold end so they
        survive longest (LRU eviction order). Released in reverse table
        order so a cached chain is evicted leaf-first — evicting the root
        first would make every still-cached descendant unmatchable (match
        walks the chain from the root)."""
        if rid not in self._owned:
            raise BlockPoolError(f"double free / unknown sequence {rid!r}")
        blocks = self._owned.pop(rid)
        for b in reversed(blocks):
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if b in self._hash_of:
                    self._free.appendleft(b)            # evict-last, LRU
                    self._n_cached_free += 1
                else:
                    self._free.append(b)                # reuse-first
        return len(blocks)

    def drop_cache(self) -> int:
        """Clear the prefix index entirely. Cached-free blocks become plain
        free blocks — their content is forgotten, so they also move from the
        evict-last end of the free list to the reuse-first end (there is
        nothing left worth preserving; leaving garbage blocks parked behind
        never-used ones would starve reuse). Live registered blocks stay
        owned but are no longer shareable. Returns entries dropped."""
        n = len(self._index)
        plain, forgotten = [], []
        for b in self._free:
            if b in self._hash_of:
                self._m_evictions.inc()
                if self.on_evict is not None:
                    self.on_evict(b)
                forgotten.append(b)
            else:
                plain.append(b)
        self._free = deque(plain + forgotten)           # forgotten: reuse-first
        self._index.clear()
        self._hash_of.clear()
        self._n_cached_free = 0
        return n

    def defragment(self) -> np.ndarray:
        """Compact used blocks to the front of the pool.

        Returns `src` (num_blocks,) int32 such that the device pools must be
        permuted as ``new_pool[i] = old_pool[src[i]]``. Owner tables are
        rewritten in place to the new dense ids — a block shared by several
        tables moves ONCE and every owner follows. Cached-free blocks keep
        their content (they land right after the owned region) and the free
        list keeps its order, so reuse preference and LRU are preserved."""
        src = np.empty(self.num_blocks, np.int32)
        remap, nxt = {}, 0

        def place(old):
            nonlocal nxt
            if old not in remap:
                remap[old] = nxt
                src[nxt] = old
                nxt += 1
            return remap[old]

        for rid in self._owned:
            self._owned[rid] = [place(b) for b in self._owned[rid]]
        # cached-free blocks: content matters, keep them dense after the
        # owned region (in free-list order)
        for b in self._free:
            if b in self._hash_of:
                place(b)
        # plain free blocks: content is garbage, they fill the tail
        for b in self._free:
            if b not in self._hash_of:
                place(b)
        assert nxt == self.num_blocks
        self._free = deque(remap[b] for b in self._free)
        self._index = {k: remap[b] for k, b in self._index.items()}
        self._hash_of = {remap[b]: k for b, k in self._hash_of.items()}
        ref = [0] * self.num_blocks
        for old, new in remap.items():
            ref[new] = self._ref[old]
        self._ref = ref
        return src

    # ------------------------------------------------------------ checking
    def check(self) -> None:
        """Assert every pool invariant (used by the property-test harness
        after each step; cheap enough for test-time use)."""
        counts = [0] * self.num_blocks
        for rid, blocks in self._owned.items():
            assert len(set(blocks)) == len(blocks), \
                f"table of {rid!r} repeats a block"
            for b in blocks:
                counts[b] += 1
        for b in range(self.num_blocks):
            assert self._ref[b] == counts[b], \
                f"block {b}: refcount {self._ref[b]} != {counts[b]} owners"
        free = list(self._free)
        assert len(free) == len(set(free)), "free list repeats a block"
        for b in free:
            assert self._ref[b] == 0, f"block {b} free but referenced"
        assert len(free) + sum(1 for r in self._ref if r > 0) \
            == self.num_blocks, "free + owned != pool"
        for k, b in self._index.items():
            assert self._hash_of.get(b) == k, "index/hash_of out of sync"
        assert len(self._index) == len(self._hash_of), "index not a bijection"
        free_set = set(free)
        for b in self._hash_of:
            assert self._ref[b] > 0 or b in free_set, \
                f"registered block {b} neither owned nor free"
        scan = sum(1 for b in free if b in self._hash_of)
        assert self._n_cached_free == scan, \
            f"cached-free counter {self._n_cached_free} != scan {scan}"
