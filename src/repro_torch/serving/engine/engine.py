"""Continuous-batching serving engine (port of ``repro.serving.engine.engine``).

Sequence state is per layer kind (``models.state_providers``): full
attention pages O(S) KV blocks, sliding-window layers keep a fixed ring of
``ceil(window/block_size)+1`` blocks written modulo the ring, and recurrent
layers (rwkv6, mamba2) keep one O(1) slab row per slot, so the engine
serves full, sliding, local-global (gemma3), recurrent (rwkv6) and hybrid
(zamba2) decoders through one scheduler and one block-table layout.
Admission charges the per-kind block cost (the max over kinds) and prefix
caching stays on exactly for the all-full-attention configs, where block
aliasing is sound.

Wires the host-side scheduler + block-pool bookkeeping to the device step
functions over the paged KV pools:

  * ``prefill_fn`` — up to ``prefills_per_step`` prompt chunks of DIFFERENT
    requests packed into one segment-masked call
    (``transformer.paged_prefill_packed``), padded to a declared
    (chunk-length x num-segments) bucket.
  * ``decode_fn`` — one token for EVERY decoding slot at once
    (``transformer.paged_decode_step``, whose attention is a hand-written
    paged-attention kernel on CUDA: full or ring mode); requests join and
    leave the batch between steps, the shapes stay fixed at max_slots.
  * ``verify_fn`` — with ``EngineConfig.spec``, replaces the decode step:
    k tokens per slot (the pending token plus k-1 drafts) through the
    multi-query verify kernels, greedy acceptance on the device
    (``spec.verify_step``), then one host read of (greedy, accepts).
  * ``copy_block_fn`` — the copy-on-write block duplication of prefix
    caching.
  * ``reset_slot_fn`` — zero a slot's recurrent slab rows for a new
    occupant.

All per-slot batch state (next token, sequence lengths, active mask, block
tables) lives on the device and greedy sampling happens on the device, so a
steady-state greedy decode step reads nothing back: the host queues step
after step ahead of the card. Host<->device traffic happens at request
lifecycle events (admit / prefill chunk / finish), for stop_token scanning
and for temperature sampling; generated greedy tokens are recorded as (step
vector, index) refs and materialized once at drain. Host-to-device copies
are issued non-blocking.

Unlike the reference, which donates and returns new pools, the step
functions update the KV pools IN PLACE; the small per-slot vectors are
replaced out of place, because recorded token refs may still point at an
earlier step's vector.

Prefix caching (``EngineConfig.prefix_caching``, on by default) aliases a
new request's longest cached block-aligned prompt prefix read-only into its
table, and prefills only the uncached tail. Telemetry
(``EngineConfig.telemetry``, on by default) traces every request's
lifecycle and keeps every counter in one registry (``serving.telemetry``).

Quantized KV (``EngineConfig.kv_quant``): every paged pool is int8 with one
f32 scale per stored vector; the writes quantize and the hand-written
kernels dequantize inside (the pools' dict structure carries the mode, so
the step functions are the same). Oversubscription
(``EngineConfig.oversub``, ``engine.oversub``): optimistic admission under
a watermark, per-step block growth, and preemption with rollback to a
re-prefill of ``prompt + generated``, which stores the same KV again; a
pure-recurrent config resumes from a host snapshot of its slab rows
instead.

Temperature requests (``add_request(temperature=...)``) sample on the host
with Gumbel-max noise from the request's own CPU ``torch.Generator``
(``serve.sample``), so their streams survive preemption; under speculation
they run unspeculated (one token a verify step). MoE configs
(mixtral-8x7b, qwen3-moe-30b-a3b) are served like the dense ones: their
MoE layers see each step's whole padded batch, as the reference's do.

Under a sharding plan (``Engine(..., plan=)``, ``core.parallelism``) the
params are placed by ``plan.param_specs`` as DTensors and the decode,
prefill and verify steps run in the plan's context; the paged entry
points return their logits gathered to plain tensors. The pools stay plain tensors holding every kv
head on every rank (the reference gives them no sharding), so the paged
kernels take every query head.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import parallelism as par
from repro_torch.kernels.quantize import KVQuantConfig
from repro_torch.models import state_providers as SP
from repro_torch.models import transformer as T
from repro_torch.serving import serve as SERVE
from repro_torch.serving import telemetry as TM
from repro_torch.serving.engine import spec as SPEC
from repro_torch.serving.engine.oversub import OversubConfig, SLOPolicy
from repro_torch.serving.engine.paged_cache import BlockPool
from repro_torch.serving.engine.spec import SpecConfig
from repro_torch.serving.engine.scheduler import (DECODING, FINISHED,
                                                  PREFILLING, Request,
                                                  Scheduler,
                                                  chunk_buckets_for,
                                                  segment_buckets_for)


@dataclass(frozen=True)
class EngineConfig:
    block_size: int = 16
    num_blocks: int = 128
    max_blocks_per_seq: int = 16        # block-table width P
    max_slots: int = 8                  # max concurrent sequences
    prefill_chunk: int = 32             # prompt tokens per prefill call
    prefills_per_step: int = 1          # chunks interleaved per engine step
    prefix_caching: bool = True         # alias cached prompt-prefix blocks
    telemetry: bool = True              # lifecycle tracing + metrics registry
    step_timing: bool = False           # synchronize per device call to time steps
    prefill_buckets: tuple = ()         # chunk-length buckets; () = one
                                        #   bucket of prefill_chunk tokens
    packed_prefill: bool = True         # pack chunks into one prefill call
    oversub: Optional[OversubConfig] = None   # optimistic admission + victim
                                        #   preemption (engine.oversub);
                                        #   None = conservative reservation
    spec: Optional[SpecConfig] = None   # speculative decoding (engine.spec):
                                        #   k-token draft + multi-query verify
                                        #   replaces the one-token decode step
    kv_quant: Optional[KVQuantConfig] = None  # int8 paged KV + per-vector f32
                                        #   scales, dequantized inside the
                                        #   paged-attention kernels

    def __post_init__(self):
        object.__setattr__(self, "prefill_buckets",
                           tuple(self.prefill_buckets))


def _in_plan(fn, plan):
    """fn run under the sharding plan's context; fn itself without a plan.
    Its results are plain tensors (the paged entry points gather their
    logits)."""
    if plan is None:
        return fn

    def run(*args):
        with par.plan_context(plan):
            return fn(*args)
    return run


def _step_fns(cfg, e: EngineConfig, plan=None):
    """The device step functions (counterparts of the reference's jitted
    decode_fn / prefill_fn / verify_fn / copy_block_fn). None of them reads
    a value back to the host; verify_fn is None without speculation. Under
    a sharding `plan` the decode, prefill and verify steps run in its
    context (the params are DTensors, the paged pools plain tensors on
    every rank, as the reference gives them no sharding)."""
    skinds = SP.state_kinds(cfg)
    # speculative decoding enlarges every ring layer by the draft depth so a
    # verify step's K in-flight positions never overwrite a key still inside
    # someone's window — decode, prefill and verify must all index the ring
    # with the SAME enlarged modulus, hence the shared `draft` here.
    draft = e.spec.k - 1 if e.spec is not None else 0

    def decode_fn(params, pool, tokens, tables, seq_lens, active):
        positions = torch.where(active, seq_lens, 0)
        attn_lens = torch.where(active, seq_lens + 1, 0)
        logits, pool = T.paged_decode_step(
            cfg, params, pool, {"token": tokens}, tables, positions,
            attn_lens, draft=draft)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        return greedy, logits, seq_lens + active.to(torch.int32), pool

    def prefill_fn(params, pool, tokens, tables, starts, valids, slots):
        # packed: tokens (G, C) — one bucket-padded chunk per segment;
        # starts/valids/slots (G,). Padded segments carry valid == 0 and
        # slot == max_slots (sentinel), so their writes go to the scratch
        # block.
        logits, pool = T.paged_prefill_packed(
            cfg, params, pool, tokens, tables, starts, valids, slots,
            draft=draft)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        return greedy, logits, pool

    verify_fn = None
    if e.spec is not None:
        def verify_fn(params, pool, tokens, tables, seq_lens, active, qlims):
            # one call verifies k tokens per slot and computes the greedy
            # acceptance run on the device (spec.verify_step)
            return SPEC.verify_step(cfg, params, pool, tokens, tables,
                                    seq_lens, active, qlims)

    def copy_block_fn(pool, src, dst):
        # copy-on-write: duplicate one KV block (all layers) so a request
        # whose prompt is fully cached can re-run its last token privately
        for st in pool.values():
            for a in st.values():
                a[:, dst] = a[:, src]
        return pool

    def reset_slot_fn(pool, slot):
        # zero one slot's recurrent slab rows across all layers: a new
        # occupant must not see the previous request's final state
        for i, sk in enumerate(skinds):
            if sk in ("rwkv", "mamba"):
                for a in pool[f"l{i}"].values():
                    a[:, slot] = 0
        return pool

    if verify_fn is not None:
        verify_fn = _in_plan(verify_fn, plan)
    return (_in_plan(decode_fn, plan), _in_plan(prefill_fn, plan),
            copy_block_fn, reset_slot_fn, verify_fn)


def _set(vec, i, value):
    """Out-of-place ``vec[i] = value``: the old vector may still be
    referenced by recorded (step vector, index) token refs."""
    out = vec.clone()
    out[i] = value
    return out


class Engine:
    def __init__(self, cfg, params, engine_cfg: EngineConfig = None,
                 plan=None, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine runs on cuda by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        leaf = params["embed"]["table"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, engine device "
                             f"is {self.device}")
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        self.plan = plan
        if plan is not None:
            params = par.shard_tree(params, plan.param_specs(params),
                                    plan.mesh)
        self.params = params
        e = self.ecfg

        # speculative decoding: the drafter is host-only per-engine state;
        # the device sees only k (verify tokens width + ring slack)
        self.drafter = e.spec.build_drafter() if e.spec is not None else None
        self.providers = SP.providers_for(
            cfg, num_blocks=e.num_blocks, block_size=e.block_size,
            max_slots=e.max_slots, max_blocks_per_seq=e.max_blocks_per_seq,
            draft=e.spec.k - 1 if e.spec is not None else 0,
            kv_quant=e.kv_quant)
        self._has_recurrent = any(p.kind in ("rwkv", "mamba")
                                  for p in self.providers)
        for p in self.providers:
            if p.kind == "ring" and p.ring_pages > e.max_blocks_per_seq:
                raise ValueError(
                    f"ring needs {p.ring_pages} blocks (window "
                    f"{p.window} @ block_size {e.block_size}) > "
                    f"max_blocks_per_seq {e.max_blocks_per_seq}")
        # block aliasing is only sound when every layer's state is a pure
        # function of the token prefix — i.e. all-full-attention configs
        self.prefix_caching = (e.prefix_caching and all(
            p.supports_prefix_caching for p in self.providers))

        self.telemetry = TM.Telemetry(enabled=e.telemetry,
                                      step_timing=e.step_timing)
        reg = self.telemetry.registry
        self._m_decode_steps = reg.counter(
            "engine_decode_steps_total", "batched decode steps dispatched")
        self._m_prefill_chunks = reg.counter(
            "engine_prefill_chunks_total", "prompt prefill chunks dispatched")
        self._m_emitted = reg.counter(
            "engine_tokens_emitted_total", "tokens emitted across requests")
        self._m_occupancy = reg.counter(
            "engine_occupancy_sum",
            "sum over decode steps of decode_batch/max_slots")
        self._m_prefix_hits = reg.counter(
            "engine_prefix_hit_tokens_total",
            "prompt tokens served from the prefix cache")
        self._m_cow = reg.counter(
            "engine_cow_copies_total", "copy-on-write block duplications")
        self._m_defrags = reg.counter(
            "engine_defrags_total", "pool defragmentation passes")
        self._m_step_syncs = reg.counter(
            "engine_step_vector_syncs_total",
            "step vectors materialized on host for stop_token scanning")
        self._m_preempts = reg.counter(
            "engine_preemptions_total", "victims evicted and rolled back")
        self._m_resumes = reg.counter(
            "engine_resumes_total", "preempted requests re-admitted")
        self._m_appends = reg.counter(
            "engine_block_appends_total",
            "blocks appended on demand to decoding sequences")
        self._m_prefill_deferrals = reg.counter(
            "engine_prefill_deferrals_total",
            "steps that skipped prefill under SLO/pool pressure")
        self._m_verify_steps = reg.counter(
            "engine_verify_steps_total", "speculative verify steps dispatched")
        self._m_draft = reg.counter(
            "engine_draft_tokens_total", "draft tokens proposed for verify")
        self._m_accepted = reg.counter(
            "engine_accepted_tokens_total", "draft tokens accepted by verify")
        self._h_accept = reg.histogram(
            "engine_spec_acceptance_rate",
            "per verify step: accepted drafts / proposed drafts")
        self._g_waiting = reg.gauge(
            "engine_waiting_requests", "requests queued awaiting admission")
        self._g_running = reg.gauge(
            "engine_running_requests", "requests prefilling or decoding")
        self._g_free_blocks = reg.gauge(
            "pool_free_blocks", "allocatable blocks (incl. cached-free)")
        self._h_queue_wait = reg.histogram(
            "engine_request_queue_wait_seconds", "arrive -> admit wait")
        self._h_ttft = reg.histogram(
            "engine_request_ttft_seconds", "arrive -> first token")
        self._h_e2e = reg.histogram(
            "engine_request_e2e_seconds", "arrive -> finish")

        self.pool_state = T.init_paged_state(cfg, e.num_blocks, e.block_size,
                                             max_slots=e.max_slots,
                                             device=self.device,
                                             kv_quant=e.kv_quant)
        # pool bytes the int8 layout saves against the config's dtype (all
        # layers and superblocks; 0 with quantization off)
        n_sb, _ = SP.superblock_layout(cfg)
        self._g_kv_quant_saved = reg.gauge(
            "kv_quant_bytes_saved_total",
            "pool bytes saved by KV quantization vs the unquantized layout")
        self._g_kv_quant_saved.set(
            n_sb * sum(p.pool_bytes_saved() for p in self.providers))
        on_evict = ((lambda b: self.telemetry.record(None, "evict", block=b))
                    if self.telemetry.enabled else None)
        self.block_pool = BlockPool(e.num_blocks, e.block_size,
                                    registry=reg, on_evict=on_evict)
        self.chunk_buckets = chunk_buckets_for(e.prefill_chunk,
                                               e.prefill_buckets)
        self.segment_buckets = segment_buckets_for(e.prefills_per_step,
                                                   e.packed_prefill)
        self.prefill_grid = [(c, g) for c in self.chunk_buckets
                             for g in self.segment_buckets]
        self._m_bucket = {
            (c, g): reg.counter(
                f"engine_prefill_bucket_c{c}g{g}_dispatch_total",
                f"prefill dispatches at chunk bucket {c} x {g} segments")
            for c, g in self.prefill_grid}
        # oversubscription: the SLO policy flips the scheduler to optimistic
        # prompt-only reservation; the engine then appends decode blocks per
        # step and preempts victims when an append (or a higher-priority
        # queue head) can't be satisfied. Snapshot resume is sound only when
        # EVERY provider can restore from a snapshot (pure-recurrent
        # configs); hybrids recompute — the attention KV must be rebuilt
        # anyway and the slab prefill loop rebuilds recurrent state exactly.
        self._policy = SLOPolicy(e.oversub) if e.oversub is not None else None
        self._snapshot_resume = (
            e.oversub is not None and e.oversub.snapshot_resume
            and self._has_recurrent
            and all(getattr(p, "supports_snapshot_resume", False)
                    for p in self.providers))
        self.scheduler = Scheduler(
            self.block_pool, max_slots=e.max_slots,
            max_blocks_per_seq=e.max_blocks_per_seq,
            prefill_chunk=e.prefill_chunk,
            prefills_per_step=e.prefills_per_step,
            prefix_caching=self.prefix_caching,
            block_cost=self.blocks_needed,
            chunk_buckets=self.chunk_buckets,
            segment_buckets=self.segment_buckets,
            packed_prefill=e.packed_prefill,
            policy=self._policy)

        # device-resident slot state (touched from the host only at request
        # lifecycle events; the decode loop never reads it back)
        i32 = dict(dtype=torch.int32, device=self.device)
        self.tables = torch.zeros((e.max_slots, e.max_blocks_per_seq), **i32)
        self.seq_lens = torch.zeros((e.max_slots,), **i32)
        self.active = torch.zeros((e.max_slots,), dtype=torch.bool,
                                  device=self.device)
        self.next_tok = torch.zeros((e.max_slots,), **i32)

        self._next_rid = 0
        self.requests: dict = {}        # rid -> Request (all ever submitted)

        (self._decode, self._prefill, self._copy_block, self._reset_slot,
         self._verify) = _step_fns(cfg, e, plan)
        if self.telemetry.enabled:
            wrap = self.telemetry.recompiles.wrap
            self._decode = wrap("decode", self._decode)
            self._prefill = wrap("prefill", self._prefill)
            self._copy_block = wrap("copy_block", self._copy_block)
            self._reset_slot = wrap("reset_slot", self._reset_slot)
            if self._verify is not None:
                self._verify = wrap("verify", self._verify)
        self._step_device_s = 0.0
        self._warmup_prefill()
        self._warmup_verify()

    def _to_device(self, a: np.ndarray):
        # non-blocking: CUDA stages a pageable source before returning, so
        # the host queues the copy without waiting for the card
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _warmup_prefill(self) -> None:
        """Drive every declared (chunk x segments) prefill bucket through the
        prefill fn once at construction (the reference compiles them here;
        on the card this brings up the libraries' handles and workspaces
        before serving). All-padding arguments (valids == 0, slot ==
        max_slots sentinel) send every write to the scratch block, so the
        pools' blocks [0, num_blocks) are untouched."""
        e = self.ecfg
        i32 = dict(dtype=torch.int32, device=self.device)
        for c, g in self.prefill_grid:
            self._device_call(
                "engine/warmup_prefill", self._prefill,
                self.params, self.pool_state, torch.zeros((g, c), **i32),
                self.tables, torch.zeros((g,), **i32),
                torch.zeros((g,), **i32), torch.full((g,), e.max_slots, **i32))

    def _warmup_verify(self) -> None:
        """Drive the verify fn once at construction, as ``_warmup_prefill``
        does: every slot inactive means qlims == 0, so every write goes to
        the scratch block and the pools' blocks [0, num_blocks) are
        untouched."""
        if self._verify is None:
            return
        e = self.ecfg
        i32 = dict(dtype=torch.int32, device=self.device)
        z = torch.zeros((e.max_slots,), **i32)
        self._device_call(
            "engine/warmup_verify", self._verify, self.params,
            self.pool_state, torch.zeros((e.max_slots, e.spec.k), **i32),
            self.tables, z, torch.zeros((e.max_slots,), dtype=torch.bool,
                                        device=self.device), z)

    @property
    def stats(self) -> dict:
        """Snapshot of the registry-backed engine counters (read-only view;
        the full metric set lives in ``self.telemetry.registry``)."""
        return {"decode_steps": self._m_decode_steps.value,
                "prefill_chunks": self._m_prefill_chunks.value,
                "emitted": self._m_emitted.value,
                "occupancy_sum": self._m_occupancy.value,
                "prefix_hit_tokens": self._m_prefix_hits.value,
                "cow_copies": self._m_cow.value,
                "preemptions": self._m_preempts.value,
                "resumes": self._m_resumes.value,
                "block_appends": self._m_appends.value}

    def bucket_dispatches(self) -> dict:
        """Serving-time prefill dispatch counts per declared (chunk_len,
        num_segments) bucket (warmup calls are not counted)."""
        return {k: int(m.value) for k, m in self._m_bucket.items()}

    # ----------------------------------------------------------------- API
    def blocks_needed(self, total_tokens: int) -> int:
        """Blocks one sequence of `total_tokens` reserves: the max over the
        per-kind provider costs (the block table is shared across layers)."""
        return SP.seq_blocks_needed(self.providers, total_tokens)

    def add_request(self, prompt, max_new: int, *, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    stop_token: Optional[int] = None,
                    priority: int = 0) -> int:
        """Queue a request; returns its id. `prompt`: 1-D int tokens.
        `temperature` > 0 samples on the host with noise from `generator`
        (a CPU ``torch.Generator``; by default one seeded with the request
        id, as the reference seeds its key). `priority` is the
        oversubscription class (LOWER is more important; ignored by the
        conservative scheduler).

        Validates up front that prompt + generation budget fits both the
        per-sequence block table and the whole pool, so infeasible requests
        fail here with the offending numbers."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        e = self.ecfg
        total = prompt.shape[0] + max_new
        need = self.blocks_needed(total)
        if need > e.max_blocks_per_seq:
            raise ValueError(
                f"request infeasible: prompt_len {prompt.shape[0]} + max_new "
                f"{max_new} = {total} tokens needs {need} blocks > "
                f"max_blocks_per_seq {e.max_blocks_per_seq} "
                f"(= {e.max_blocks_per_seq * e.block_size} tokens at "
                f"block_size {e.block_size})")
        if need > e.num_blocks:
            raise ValueError(
                f"request infeasible: prompt_len {prompt.shape[0]} + max_new "
                f"{max_new} = {total} tokens needs {need} blocks > pool "
                f"budget num_blocks {e.num_blocks}")
        if temperature > 0.0 and generator is None:
            generator = torch.Generator().manual_seed(self._next_rid)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new,
                      temperature=temperature, generator=generator,
                      stop_token=stop_token, priority=priority,
                      arrive_t=self.telemetry.clock())
        self.requests[rid] = req
        self.scheduler.submit(req)
        self.telemetry.record(rid, "arrive", prompt_len=int(prompt.shape[0]),
                              max_new=int(max_new))
        return rid

    def _device_call(self, span: str, fn, *args):
        """Dispatch one step function under a labeled profiler span. In the
        timing path (`step_timing`) only, synchronize so the measured
        interval is device completion rather than the enqueue, and add it
        to the current step's device time."""
        tel = self.telemetry
        if not tel.enabled:
            return fn(*args)
        with tel.span(span):
            if not tel.step_timing:
                return fn(*args)
            t0 = tel.clock()
            out = fn(*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._step_device_s += tel.clock() - t0
            return out

    def step(self) -> list:
        """One engine iteration: admit -> prefill chunk(s) -> batched decode.
        Under oversubscription the order becomes: priority preemption ->
        (policy-gated) admit + prefill -> per-sequence block growth (with
        victim preemption on append failure) -> batched decode. Returns the
        rids that emitted a token this step (token values are materialized
        lazily — read them via `drain()` / `output()`)."""
        e = self.ecfg
        tel = self.telemetry
        emitted = []
        self._step_device_s = 0.0
        t_step = tel.clock() if tel.step_timing else 0.0
        t_wall = tel.clock() if self._policy is not None else 0.0
        n_prefills = 0
        sync_memo = {}                  # one host transfer per step vector

        pol = self._policy
        if pol is not None and pol.cfg.priority_preemption:
            self._priority_preempt()
        allow_prefill = True
        if pol is not None:
            head_wait = None
            if self.scheduler.waiting:
                head = self.scheduler.waiting[0]
                if head.arrive_t is not None:
                    head_wait = pol.clock() - head.arrive_t
            decoding = sum(1 for r in self.scheduler.running.values()
                           if r.state == DECODING)
            allow_prefill = pol.allow_prefill(
                head_wait_s=head_wait, decoding=decoding,
                pool_util=self.block_pool.utilization)
            if not allow_prefill:
                self._m_prefill_deferrals.inc()

        for req in (self.scheduler.admit() if allow_prefill else []):
            row = self.block_pool.table(req.rid)
            padded = np.zeros((e.max_blocks_per_seq,), np.int32)
            padded[:len(row)] = row
            self.tables[req.slot] = self._to_device(padded)
            if self._has_recurrent:
                # the slot's recurrent slab rows still hold the previous
                # occupant's final state — zero them for the newcomer
                self.pool_state = self._device_call(
                    "engine/reset_slot", self._reset_slot,
                    self.pool_state, req.slot)
            self._m_prefix_hits.inc(req.prefilled)
            resumed = req.preempts > 0
            if tel.enabled:
                t_admit = tel.record(req.rid, "resume" if resumed else "admit",
                                     slot=req.slot)
                if not resumed:
                    t_arrive = tel.tracer.first(req.rid, "arrive")
                    if t_arrive is not None:
                        self._h_queue_wait.observe(t_admit - t_arrive)
                if req.prefilled:
                    tel.record(req.rid, "prefix_hit", tokens=req.prefilled,
                               blocks=req.shared_blocks
                               + (1 if req.cow_src is not None else 0))
            if resumed:
                self._m_resumes.inc()
            if req.snapshot is not None and self._snapshot_resume:
                # pure-recurrent resume: copy the checkpointed slab rows
                # back into the (freshly zeroed) slot and skip the re-scan —
                # prefill only covers the tokens past the snapshot
                self.pool_state = {
                    f"l{i}": p.resume_restore(
                        self.pool_state[f"l{i}"], req.slot, req.snapshot[i])
                    for i, p in enumerate(self.providers)}
                req.prefilled = req.snapshot_len
            req.snapshot = None
            req.snapshot_len = 0
            self.seq_lens = _set(self.seq_lens, req.slot, req.prefilled)
            if req.cow_src is not None:
                # whole prefill cached: copy the last matched block into the
                # private block at its table position, then re-prefill only
                # the final token there (yields the first-token logits)
                dst = row[req.prefill_len // e.block_size - 1]
                self.pool_state = self._device_call(
                    "engine/copy_block", self._copy_block,
                    self.pool_state, int(req.cow_src), int(dst))
                self._m_cow.inc()

        for batch in (self.scheduler.next_prefills() if allow_prefill
                      else []):
            # one segment-masked device call per batch: segment j carries
            # request j's chunk, padded to the (C, G) bucket; missing
            # segments get valid=0 and the out-of-range slot sentinel
            C, G = batch.chunk_len, batch.num_segments
            tokens = np.zeros((G, C), np.int32)
            starts = np.zeros((G,), np.int32)
            valids = np.zeros((G,), np.int32)
            slots = np.full((G,), e.max_slots, np.int32)
            for j, (req, start, valid) in enumerate(batch.segments):
                tokens[j, :valid] = req.prefill_src[start:start + valid]
                starts[j], valids[j], slots[j] = start, valid, req.slot
            greedy, logits, self.pool_state = self._device_call(
                "engine/prefill", self._prefill,
                self.params, self.pool_state, self._to_device(tokens),
                self.tables, self._to_device(starts), self._to_device(valids),
                self._to_device(slots))
            self._m_bucket[(C, G)].inc()
            for j, (req, start, valid) in enumerate(batch.segments):
                req.prefilled += valid
                self.scheduler.register_prefilled(req)
                self.seq_lens = _set(self.seq_lens, req.slot, req.prefilled)
                self._m_prefill_chunks.inc()
                n_prefills += 1
                tel.record(req.rid, "prefill_chunk", start=start, tokens=valid)
                if req.prefilled == req.prefill_len:
                    # prefill complete: segment j's logits yield the next
                    # token (the request's FIRST, unless this is a resumed
                    # re-prefill continuing an interrupted generation)
                    self._record_token(req, greedy, j, logits, sync_memo)
                    emitted.append(req.rid)
                    if tel.enabled:
                        if req.got_first:
                            tel.record(req.rid, "decode_token")
                        else:
                            t_first = tel.record(req.rid, "first_token")
                            t_arrive = tel.tracer.first(req.rid, "arrive")
                            if t_arrive is not None:
                                self._h_ttft.observe(t_first - t_arrive)
                    req.got_first = True
                    req.state = DECODING
                    self.active = _set(self.active, req.slot, True)
                    if req.done:
                        self._finish(req)

        if pol is not None:
            self._grow_decode()
        batch = self.scheduler.decode_batch()
        if batch and self._verify is not None:
            emitted.extend(self._spec_decode(batch, sync_memo))
        elif batch:
            greedy, logits, self.seq_lens, self.pool_state = self._device_call(
                "engine/decode", self._decode,
                self.params, self.pool_state, self.next_tok, self.tables,
                self.seq_lens, self.active)
            self.next_tok = greedy
            self._m_decode_steps.inc()
            self._m_occupancy.inc(len(batch) / e.max_slots)
            for req in batch:
                self._record_token(req, greedy, req.slot, logits, sync_memo)
                emitted.append(req.rid)
                tel.record(req.rid, "decode_token")
                if req.done:
                    self._finish(req)

        self._m_emitted.inc(len(emitted))
        if tel.enabled:
            self._g_waiting.set(len(self.scheduler.waiting))
            self._g_running.set(len(self.scheduler.running))
            self._g_free_blocks.set(self.block_pool.num_free)
            if tel.step_timing:
                total = tel.clock() - t_step
                tel.record_step(
                    host_s=total - self._step_device_s,
                    device_s=self._step_device_s, prefills=n_prefills,
                    decode_batch=len(batch), emitted=len(emitted))
        if pol is not None:
            pol.note_step(tel.clock() - t_wall)
        return emitted

    def drain(self, max_steps: int = 100_000) -> dict:
        """Run steps until every queued request finished; returns
        {rid: np.ndarray of generated tokens} for ALL finished requests."""
        steps = 0
        while self.scheduler.has_work:
            if steps >= max_steps:      # permit exactly max_steps steps
                raise RuntimeError("drain did not converge")
            self.step()
            steps += 1
        memo = {}                       # one transfer per unique step vector
        return {rid: self._materialize(r, memo)
                for rid, r in self.requests.items() if r.state == FINISHED}

    def output(self, rid) -> np.ndarray:
        """Materialize a request's generated tokens (waits for the device)."""
        return self._materialize(self.requests[rid], {})

    def _materialize(self, req: Request, memo: dict) -> np.ndarray:
        out = []
        for t in req.out_tokens:
            if isinstance(t, tuple):                # (step vector, index)
                vec, i = t
                host = memo.get(id(vec))
                if host is None:
                    host = memo[id(vec)] = vec.cpu().numpy()
                out.append(int(host[i]))
            else:
                out.append(int(t))
        return np.asarray(out, np.int32)

    def defragment(self) -> np.ndarray:
        """Compact used KV blocks to the front of the pool and rewrite every
        live block table (host bookkeeping + one device gather per pool).
        Shared (prefix-cached) blocks move once and every owner's table
        follows; cached-free blocks keep their content. Returns the applied
        permutation `src` (``new_pool[i] = old_pool[src[i]]``)."""
        src = self.block_pool.defragment()
        self._m_defrags.inc()
        self.telemetry.record(None, "defrag",
                              moved=int(np.sum(src != np.arange(len(src)))))
        perm = torch.from_numpy(src.astype(np.int64)).to(self.device)
        self.pool_state = {
            f"l{i}": p.defrag_remap(self.pool_state[f"l{i}"], perm)
            for i, p in enumerate(self.providers)}
        tables = np.zeros(tuple(self.tables.shape), np.int32)
        for req in self.scheduler.running.values():
            row = self.block_pool.table(req.rid)
            tables[req.slot, :len(row)] = row
        self.tables = self._to_device(tables)
        return src

    # -------------------------------------------------- preemption internals
    def _grow_decode(self) -> None:
        """Optimistic growth: append the block(s) each decoding sequence's
        next KV write needs, strongest request first (the policy's
        protection order). When the pool can't satisfy an append, preempt
        strictly-WEAKER victims until it can — and if none exist, the
        growing request itself is the weakest and rolls back. The maximal
        request is never victimized while anything weaker runs, so progress
        is guaranteed (its full span fits the pool, validated at submit)."""
        sched = self.scheduler
        order = sorted(sched.decode_batch(), key=SLOPolicy.protection_key)
        for req in order:
            if req.rid not in sched.running:
                continue                # became a victim earlier this pass
            need = sched.growth_need(req, extra=self._spec_horizon(req))
            if need == 0:
                continue
            while not self.block_pool.can_alloc(need):
                me = SLOPolicy.protection_key(req)
                victim = self._policy.pick_victim(
                    [r for r in sched.running.values()
                     if r is not req and SLOPolicy.protection_key(r) > me])
                self._preempt(victim if victim is not None else req)
                if victim is None:
                    break
            if req.rid in sched.running:
                fresh = sched.grow(req, extra=self._spec_horizon(req))
                old = len(self.block_pool.table(req.rid)) - len(fresh)
                self.tables[req.slot, old:old + len(fresh)] = \
                    self._to_device(np.asarray(fresh, np.int32))
                self._m_appends.inc(len(fresh))

    def _priority_preempt(self) -> None:
        """A blocked queue head may evict strictly-lower-class victims: while
        the head cannot be admitted and such a victim runs, preempt the
        weakest one. Equal-or-higher-class work is never disturbed, so this
        terminates and never inverts the class order."""
        sched = self.scheduler
        while sched.waiting and not sched.can_admit_head():
            head = sched.waiting[0]
            victim = self._policy.pick_victim(
                list(sched.running.values()), max_priority=head.priority)
            if victim is None:
                return
            self._preempt(victim)

    def _preempt(self, req: Request) -> None:
        """Evict one running request and roll it back to WAITING. Host-side
        order matters: materialize its lazy token refs (the step vectors are
        unreachable once the slot turns over), deactivate the slot, then let
        the scheduler register + free its blocks and requeue it.
        Materialization uses a private memo: this call drops the victim's
        step-vector refs, so a shared id()-keyed memo could dangle for the
        rest of the step. A pure-recurrent config snapshots the victim's slab
        rows first (``_snapshot_resume``)."""
        req.out_tokens = [int(t) for t in self._materialize(req, {})]
        if self._snapshot_resume:
            # the state covers exactly the tokens processed as inputs so
            # far: seq_tokens - 1 while DECODING (the last generated token
            # is the pending input), prefilled while mid-prefill
            req.snapshot = [
                p.preempt_checkpoint(self.pool_state[f"l{i}"], req.slot)
                for i, p in enumerate(self.providers)]
            req.snapshot_len = (req.seq_tokens - 1 if req.state == DECODING
                                else req.prefilled)
        self.active = _set(self.active, req.slot, False)
        blocks = len(self.block_pool.table(req.rid))
        if self.drafter is not None:
            self.drafter.forget(req.rid)
        self.scheduler.preempt(req)
        self._m_preempts.inc()
        self.telemetry.record(req.rid, "preempt",
                              generated=len(req.out_tokens), blocks=blocks)

    def preempt_request(self, rid: int) -> bool:
        """Force-preempt one running request (test/ops hook — the soak tests
        drive every request through at least one evict/resume cycle with
        this). Returns False if the request isn't currently running."""
        req = self.requests[rid]
        if req.state not in (PREFILLING, DECODING):
            return False
        self._preempt(req)
        return True

    # ------------------------------------------------------------- internal
    def _spec_decode(self, batch: list, sync_memo: dict) -> list:
        """One speculative decode step over the DECODING batch: host
        drafting, ONE verify call covering k tokens per slot, then a host
        read of the (greedy, accepts) pair to record each accepted run.
        Spec mode reads back every step — acceptance decides how many
        tokens exist, so lazy step-vector refs can't represent the output —
        which is why verify must emit > 1 token per step on average to win.

        Per slot the verify row is ``[pending, d1 .. d_{k-1}]``: the last
        emitted (true) token plus the drafter's guesses for the next k-1
        stream positions. ``qlims`` caps accepted tokens AND KV writes at
        what the request may still emit, so writes never pass the block
        reservation; under oversubscription ``_spec_horizon`` grows the
        table by the same horizon first. Temperature requests run with
        qlims == 1: one token whose value the host samples from the pending
        position's logits (the device commits only the pending token's
        state, which holds whatever token is sampled)."""
        e = self.ecfg
        tel = self.telemetry
        k = e.spec.k
        emitted = []
        tokens = np.zeros((e.max_slots, k), np.int32)
        qlims = np.zeros((e.max_slots,), np.int32)
        plans = []
        for req in batch:
            # drafting needs the concrete stream: materialize any lazy
            # step-vector refs (at most this step's prefill-completion token)
            if any(isinstance(t, tuple) for t in req.out_tokens):
                req.out_tokens = [int(t) for t in
                                  self._materialize(req, sync_memo)]
            q = (1 if req.temperature > 0.0
                 else min(k, req.max_new - len(req.out_tokens)))
            ctx = np.concatenate([req.prompt,
                                  np.asarray(req.out_tokens, np.int32)])
            tokens[req.slot, 0] = ctx[-1]
            if q > 1:
                tokens[req.slot, 1:] = self.drafter.propose(
                    req.rid, ctx, k - 1)
            qlims[req.slot] = q
            plans.append((req, q))
        greedy, accepts, logits, self.seq_lens, self.pool_state = \
            self._device_call(
                "engine/verify", self._verify,
                self.params, self.pool_state, self._to_device(tokens),
                self.tables, self.seq_lens, self.active,
                self._to_device(qlims))
        g_host = greedy.cpu().numpy()
        a_host = accepts.cpu().numpy()
        self._m_step_syncs.inc()
        self._m_decode_steps.inc()
        self._m_verify_steps.inc()
        self._m_occupancy.inc(len(batch) / e.max_slots)
        for req, q in plans:
            a = int(a_host[req.slot])
            toks = [int(t) for t in g_host[req.slot, :a]]
            if req.temperature > 0.0:
                toks = [int(SERVE.sample(logits[req.slot, 0], req.generator,
                                         req.temperature))]
            if req.stop_token is not None and req.stop_token in toks:
                # truncate at the stop token; the device advanced past it
                # but the slot is freed below, so the overrun is unreachable
                toks = toks[:toks.index(req.stop_token) + 1]
            req.out_tokens.extend(toks)
            emitted.append(req.rid)
            drafted, accepted = max(q - 1, 0), max(a - 1, 0)
            self._m_draft.inc(drafted)
            self._m_accepted.inc(accepted)
            if drafted:
                self._h_accept.observe(accepted / drafted)
            tel.record(req.rid, "verify", drafted=drafted, accepted=accepted)
            tel.record(req.rid, "decode_token", tokens=len(toks))
            self._m_emitted.inc(len(toks) - 1)    # step() adds 1 per rid
            if req.done:
                self._finish(req)
        return emitted

    def _spec_horizon(self, req: Request) -> int:
        """Extra block-growth horizon under speculation: the next verify
        step writes KV at positions ``seq_tokens-1 .. seq_tokens-2+qlims``,
        i.e. qlims-1 tokens past what the one-token decode step writes."""
        if self._verify is None or req.temperature > 0.0:
            return 0
        return min(self.ecfg.spec.k, req.max_new - len(req.out_tokens)) - 1

    def _record_token(self, req: Request, greedy_vec, greedy_idx, logits,
                      sync_memo: dict):
        """Record the request's next token. Greedy requests store a
        (step-vector, index) ref — no host sync; a temperature request
        samples row `greedy_idx` of `logits` on the host with its generator;
        stop_token requests pay a host round-trip, at most ONE transfer per
        step vector (`sync_memo`, one dict per engine step)."""
        if req.temperature > 0.0:
            tok = int(SERVE.sample(logits[greedy_idx], req.generator,
                                   req.temperature))
            self.next_tok = _set(self.next_tok, req.slot, tok)
            req.out_tokens.append(tok)
            return
        if req.stop_token is not None:
            host = sync_memo.get(id(greedy_vec))
            if host is None:
                host = sync_memo[id(greedy_vec)] = greedy_vec.cpu().numpy()
                self._m_step_syncs.inc()
            req.out_tokens.append(int(host[greedy_idx]))
        else:
            req.out_tokens.append((greedy_vec, greedy_idx))
        if req.state != DECODING:
            # token came from prefill logits: seed the device next-token
            # vector for the upcoming decode step
            self.next_tok = _set(self.next_tok, req.slot,
                                 greedy_vec[greedy_idx])

    def _finish(self, req: Request) -> None:
        self.active = _set(self.active, req.slot, False)
        if self.drafter is not None:
            self.drafter.forget(req.rid)
        self.scheduler.finish(req)
        tel = self.telemetry
        if tel.enabled:
            t_fin = tel.record(req.rid, "finish",
                               generated=len(req.out_tokens))
            t_arrive = tel.tracer.first(req.rid, "arrive")
            if t_arrive is not None:
                self._h_e2e.observe(t_fin - t_arrive)
