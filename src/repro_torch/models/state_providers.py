"""Per-layer-kind sequence-state providers.

Mirrors ``repro.models.state_providers``: one provider per layer *state
kind*, which builds the layer's device state and tells the host scheduler
what a sequence costs in blocks. The ``full`` kind pages KV blocks (prefix
caching), the ``ring`` kind keeps sliding-window KV in a fixed ring of
blocks per sequence, and the recurrent ``rwkv`` and ``mamba`` kinds keep
one O(1) state slab row per engine slot (``RecurrentSlabProvider``: no
blocks, snapshot resume after a preemption, speculative rollback through
``select_checkpoint``).

Dropped writes. The reference scatters inactive or padding rows to block id
N with ``mode="drop"``; PyTorch has no drop mode, and index N would raise
(CPU) or device-assert (CUDA). So every pool holds one extra *scratch block*
at index N that ``BlockPool`` never hands out: dropped rows are routed there
with ``torch.where`` — no host sync, no read-modify-write of live blocks.
Nothing ever reads the scratch block; compare pools with the reference's on
``[:N]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quantize import KVQuantConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


# ------------------------------------------------------------- KV allocation
def alloc_kv_pool(lead_shape, hkv: int, hd: int, dtype, device,
                  kv_quant: Optional[KVQuantConfig] = None):
    """THE allocator for K/V storage (tests/test_torch_port_rules.py fences
    raw KV dicts elsewhere): {"k", "v"} of lead + (hkv, hd) in `dtype`,
    zero-filled. With `kv_quant` the values are int8 and {"k_scale",
    "v_scale"} f32 (lead + (hkv,)) carry one dequant scale per stored
    vector; the attention code dispatches on the dict's structure ("k_scale"
    in pool)."""
    shape = tuple(lead_shape) + (hkv, hd)
    if kv_quant is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    sshape = tuple(lead_shape) + (hkv,)
    # scale 1.0 is quantize_kv's on an all-zero vector, so untouched slots
    # dequantize to exactly 0.0
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.ones(sshape, dtype=torch.float32, device=device)}


# ----------------------------------------------------------- layer kind lists
def superblock_layout(cfg: ModelConfig):
    """Returns (n_superblocks, layers_per_superblock)."""
    if cfg.family == "hybrid":
        per = cfg.hybrid_ssm_per_attn + 1
        return cfg.num_layers // per, per
    if cfg.attention_type == "local_global":
        per = cfg.local_global_ratio + 1
        return cfg.num_layers // per, per
    return cfg.num_layers, 1


def layer_kinds(cfg: ModelConfig):
    """Static list of layer kinds within one superblock."""
    if cfg.family == "hybrid":
        return ["mamba"] * cfg.hybrid_ssm_per_attn + ["shared_attn"]
    if cfg.attention_type == "local_global":
        return ["local"] * cfg.local_global_ratio + ["global"]
    if cfg.family == "ssm":
        return ["rwkv"]
    if cfg.num_experts:
        return ["moe_attn"]
    return ["attn"]


def state_kind(layer_kind: str, cfg: ModelConfig) -> str:
    """Map a layer kind to its sequence-state kind."""
    if layer_kind in ("global", "shared_attn"):
        return "full"
    if layer_kind == "local":
        return "ring"
    if layer_kind in ("attn", "moe_attn"):
        return "ring" if cfg.attention_type == "sliding" else "full"
    if layer_kind == "rwkv":
        return "rwkv"
    if layer_kind == "mamba":
        return "mamba"
    raise ValueError(f"unknown layer kind {layer_kind!r}")


def state_kinds(cfg: ModelConfig):
    """Per-layer state kinds within one superblock (static)."""
    return [state_kind(k, cfg) for k in layer_kinds(cfg)]


def ring_pages(window: int, block_size: int, draft: int = 0) -> int:
    """Ring length in pages: ceil(window/bs) intact pages always cover the
    last `window` positions, +1 for the page currently being overwritten.

    ``draft`` adds speculative-decoding slack: a verify step holds K = draft
    + 1 in-flight positions, and the OLDEST draft query still needs its full
    window `(qpos - window, qpos]` resident while the ring has already
    advanced to the newest draft — so the intact span must cover
    window + draft positions back from the newest write."""
    return -(-(window + draft) // block_size) + 1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------------------------------------------ providers
@dataclass(frozen=True)
class _PagedPoolProvider:
    """Shared machinery of the block-pooled KV providers: pool tensor
    layout (plus the scratch block), per-slot KV bytes, and the block-axis
    defrag gather."""
    cfg: ModelConfig
    num_blocks: int
    block_size: int
    max_blocks_per_seq: Optional[int] = None
    kv_quant: Optional[KVQuantConfig] = None

    # Preemption rolls paged KV back by freeing blocks (and re-aliasing the
    # registered ones on resume), ring KV by re-prefilling (its write cursor
    # is a function of the token count): neither keeps a snapshot. These
    # are the reference's rollback hooks, which the recurrent slabs fill in.
    def preempt_checkpoint(self, state, slot: int):
        return None

    def resume_restore(self, state, slot: int, snap):
        return state

    def init_layer_state(self, n_sb: int, device):
        """(n_sb, num_blocks + 1, bs, Hkv, hd) pools, one per superblock
        (int8, plus (n_sb, num_blocks + 1, bs, Hkv) f32 scales, with
        `kv_quant`); block num_blocks is the scratch block that absorbs
        dropped writes."""
        hkv, hd = self.cfg.num_kv_heads, self.cfg.resolved_head_dim
        return alloc_kv_pool((n_sb, self.num_blocks + 1, self.block_size),
                             hkv, hd, L.dtype_of(self.cfg), device,
                             self.kv_quant)

    def _bytes_per_token(self) -> int:
        """KV bytes one stored token costs in this pool (both K and V)."""
        hkv, hd = self.cfg.num_kv_heads, self.cfg.resolved_head_dim
        if self.kv_quant is not None:
            return 2 * hkv * (hd + 4)   # int8 vector + one f32 scale per head
        return 2 * hkv * hd * L.dtype_of(self.cfg).itemsize

    def state_bytes_per_slot(self, total_tokens: int) -> int:
        return (self.blocks_needed(total_tokens) * self.block_size
                * self._bytes_per_token())

    def pool_bytes_saved(self) -> int:
        """Bytes of the num_blocks allocatable blocks saved by quantization
        against the config's dtype (0 when quantization is off) — the
        kv_quant_bytes_saved_total gauge."""
        if self.kv_quant is None:
            return 0
        hkv, hd = self.cfg.num_kv_heads, self.cfg.resolved_head_dim
        per_tok = 2 * hkv * hd * L.dtype_of(self.cfg).itemsize
        return (self.num_blocks * self.block_size
                * (per_tok - self._bytes_per_token()))

    def defrag_remap(self, state, perm):
        """state leaves (values and, for int8 pools, scales): (n_sb, N + 1,
        bs, ...); perm (N,): new[i] = old[perm[i]]. The gather reads into a
        new tensor before the copy back, so no block is overwritten before
        it is read."""
        for a in state.values():
            a[:, :self.num_blocks] = a[:, perm]
        return state


@dataclass(frozen=True)
class PagedKVProvider(_PagedPoolProvider):
    """Full-attention paged KV: O(S) blocks per sequence, prefix caching."""

    kind = "full"
    supports_prefix_caching = True

    def blocks_needed(self, total_tokens: int) -> int:
        return _ceil_div(total_tokens, self.block_size)

    def max_tokens(self) -> Optional[int]:
        """Context bound imposed by the block-table width (None = unbounded)."""
        if self.max_blocks_per_seq is None:
            return None
        return self.max_blocks_per_seq * self.block_size


@dataclass(frozen=True)
class RingKVProvider(_PagedPoolProvider):
    """Sliding-window paged KV: a fixed ring of ceil(window/bs)+1 blocks per
    sequence (more with speculative slack); token at position p lives in
    table[(p // bs) % ring] at offset p % bs, so long generations stop
    consuming new blocks."""
    window: int = 0
    draft: int = 0   # speculative slack: K-1 extra in-flight positions

    kind = "ring"
    supports_prefix_caching = False  # ring content depends on wrap position

    @property
    def ring_pages(self) -> int:
        return ring_pages(self.window, self.block_size, draft=self.draft)

    def blocks_needed(self, total_tokens: int) -> int:
        return min(_ceil_div(total_tokens, self.block_size), self.ring_pages)

    def max_tokens(self) -> Optional[int]:
        return None  # the ring wraps: any length fits in ring_pages blocks

    def write_cursor(self, seq_len: int) -> dict:
        """Where token `seq_len` will be written: a pure function of the
        token count, so re-prefilling the same tokens after a preemption
        reproduces the ring wrap for wrap."""
        return {"page": (seq_len // self.block_size) % self.ring_pages,
                "offset": seq_len % self.block_size}


@dataclass(frozen=True)
class RecurrentSlabProvider:
    """O(1) recurrent state: one slab row per engine slot, no block
    accounting. The engine zeroes a slot's rows when a new request takes
    it, and the decode step masks the updates of inactive slots, so a
    mid-prefill neighbour is never corrupted by the batched decode."""
    cfg: ModelConfig
    max_slots: int
    kind: str                         # "rwkv" | "mamba"

    supports_prefix_caching = False
    supports_snapshot_resume = True   # O(1) state: checkpoint beats re-scan

    def _spec(self):
        if self.kind == "rwkv":
            return S.rwkv6_state_spec(self.cfg)
        if self.kind == "mamba":
            return S.mamba2_state_spec(self.cfg)
        raise ValueError(self.kind)

    def init_layer_state(self, n_sb: int, device):
        """Zero slabs (n_sb, max_slots, ...) of the kind's state spec."""
        return {k: torch.zeros((n_sb, self.max_slots) + shape, dtype=dt,
                               device=device)
                for k, (shape, dt) in self._spec().items()}

    def blocks_needed(self, total_tokens: int) -> int:
        return 0

    def max_tokens(self) -> Optional[int]:
        return None

    def state_bytes_per_slot(self, total_tokens: int) -> int:
        return sum(math.prod(shape) * dt.itemsize
                   for shape, dt in self._spec().values())

    def pool_bytes_saved(self) -> int:
        return 0    # slabs are never quantized

    def defrag_remap(self, state, perm):
        return state  # slot-indexed, block moves don't touch it

    def preempt_checkpoint(self, state, slot: int):
        """Host snapshot of one slot's recurrent state. Leaves are
        (n_sb, max_slots, ...) — slot axis 1."""
        return {k: a[:, slot].to("cpu", copy=True) for k, a in state.items()}

    def resume_restore(self, state, slot: int, snap):
        """Copy a ``preempt_checkpoint`` snapshot back into `slot`, in
        place (the engine zeroes the slot first, so this is a plain set)."""
        for k, a in state.items():
            a[:, slot] = snap[k].to(a.device)
        return state


# -------------------------------------------------- speculative rollback
def select_checkpoint(checkpoints, accepts, old):
    """Roll rejected draft tokens back to the accepted recurrent state.

    ``checkpoints`` leaves: (n_sb, K, max_slots, ...) — the per-draft-step
    states captured by the verify loop (checkpoint j = state after
    processing drafts 0..j). ``accepts``: (max_slots,) int32 tokens accepted
    this step (1..K; 0 marks an inactive slot). ``old``: the pre-verify slab
    (n_sb, max_slots, ...). Returns new slab leaves advanced by exactly
    ``accepts`` tokens per slot: checkpoint ``accepts - 1`` where active,
    the untouched old state elsewhere."""
    out = {}
    for name, cps in checkpoints.items():
        o = old[name]
        K, n_slots = cps.shape[1], cps.shape[2]
        cp = torch.clamp(accepts.long() - 1, 0, K - 1)             # (S,)
        picked = cps[:, cp, torch.arange(n_slots, device=cps.device)]
        act = (accepts > 0).reshape((1, n_slots) + (1,) * (o.dim() - 2))
        out[name] = torch.where(act, picked.to(o.dtype), o)
    return out


# ----------------------------------------------------------------- assembly
def provider_for(skind: str, cfg: ModelConfig, *, num_blocks: int,
                 block_size: int, max_slots: int = 0,
                 max_blocks_per_seq: Optional[int] = None, draft: int = 0,
                 kv_quant: Optional[KVQuantConfig] = None):
    if skind == "full":
        return PagedKVProvider(cfg, num_blocks, block_size, max_blocks_per_seq,
                               kv_quant)
    if skind == "ring":
        return RingKVProvider(cfg, num_blocks, block_size, max_blocks_per_seq,
                              kv_quant, window=cfg.window_size, draft=draft)
    if skind in ("rwkv", "mamba"):
        return RecurrentSlabProvider(cfg, max_slots, skind)
    raise ValueError(f"unknown state kind {skind!r}")


def providers_for(cfg: ModelConfig, *, num_blocks: int, block_size: int,
                  max_slots: int = 0,
                  max_blocks_per_seq: Optional[int] = None, draft: int = 0,
                  kv_quant: Optional[KVQuantConfig] = None):
    """One provider per layer of a superblock, aligned with layer_kinds(cfg).
    Layers of the same kind share a (frozen, equal) provider instance.
    ``draft`` = K - 1 when speculative decoding is on (ring slack);
    ``kv_quant`` switches the KV pools to int8 with per-vector scales."""
    cache = {}
    out = []
    for sk in state_kinds(cfg):
        if sk not in cache:
            cache[sk] = provider_for(sk, cfg, num_blocks=num_blocks,
                                     block_size=block_size,
                                     max_slots=max_slots,
                                     max_blocks_per_seq=max_blocks_per_seq,
                                     draft=draft, kv_quant=kv_quant)
        out.append(cache[sk])
    return out


def seq_blocks_needed(providers, total_tokens: int) -> int:
    """Blocks to reserve for one sequence of `total_tokens`: the max over
    kinds (the block table is shared across layers)."""
    return max((p.blocks_needed(total_tokens) for p in providers), default=0)


def state_memory_per_slot(cfg: ModelConfig, providers, total_tokens: int) -> int:
    """Whole-model sequence-state bytes for one busy slot at `total_tokens`
    context (all superblocks)."""
    n_sb, _ = superblock_layout(cfg)
    return n_sb * sum(p.state_bytes_per_slot(total_tokens) for p in providers)
