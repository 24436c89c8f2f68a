"""Decoder assembled from a ModelConfig: parameters, the training forward
and loss, and the paged entry points the serving engine drives (counterpart
of ``repro.models.transformer``).

Parameters are a plain dict with the reference's layout: per-layer weights
are stacked on a leading superblock axis (n_sb, ...), so the JAX
``init_params`` pytree converts leaf for leaf (``repro_torch.convert``) and
``pool[sb]`` / ``weight[sb]`` are contiguous views. The reference's
``lax.scan`` over superblocks is a Python loop here.

Entry points:
  init_params(cfg, seed=..., device=...)
  forward(cfg, params, inputs)                  -> hidden (B,S,D), aux
  loss_fn(cfg, params, batch)                   -> scalar loss (chunked CE)
  init_paged_state(cfg, num_blocks, block_size, device=...)
  paged_decode_step(cfg, params, pool, inputs, block_tables, positions, attn_lens)
  paged_verify_step(cfg, params, pool, tokens, block_tables, base, qlims)
  paged_prefill_packed(cfg, params, pool, tokens, tables, starts, valids, slots)
  paged_prefill_step(cfg, params, pool, tokens, table_row, start, valid_len, slot)

The port serves the attention-only dense families: full attention (layer
kind ``attn``), sliding window (``attn`` with ring KV) and local-global
(gemma3: ``local`` ring layers and ``global`` full layers in one
superblock). Each layer dispatches on its state kind. MoE, recurrent and
hybrid families raise ``NotImplementedError`` (ROADMAP A9, A13).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import state_providers as SP

superblock_layout = SP.superblock_layout
_layer_kinds = SP.layer_kinds


_ATTN_KINDS = ("attn", "local", "global")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config outside the port's slices so far."""
    kinds = _layer_kinds(cfg)
    SP.providers_for(cfg, num_blocks=1, block_size=1)   # raises on recurrent
    if any(k not in _ATTN_KINDS for k in kinds):
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {kinds} come in a later slice of the "
            f"port (it serves dense full, sliding and local-global "
            f"attention decoders)")
    if cfg.rope_mode not in ("standard", "none"):
        raise NotImplementedError(
            f"{cfg.name}: rope_mode {cfg.rope_mode!r} comes in a later slice")


# ------------------------------------------------------------------ param init
def param_specs(cfg: ModelConfig) -> dict:
    """Nested dict of (shape, dtype, init) leaves, in the reference's
    layout; init is "dense", "embed" or "ones"."""
    check_supported(cfg)
    n_sb, _ = superblock_layout(cfg)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt, f32 = L.dtype_of(cfg), torch.float32
    layer = {
        "ln1": {"scale": ((n_sb, d), f32, "ones")},
        "attn": {"wq": ((n_sb, d, h * hd), dt, "dense"),
                 "wk": ((n_sb, d, hkv * hd), dt, "dense"),
                 "wv": ((n_sb, d, hkv * hd), dt, "dense"),
                 "wo": ((n_sb, h * hd, d), dt, "dense")},
        "ln2": {"scale": ((n_sb, d), f32, "ones")},
        "mlp": {"w_gate": ((n_sb, d, f), dt, "dense"),
                "w_in": ((n_sb, d, f), dt, "dense"),
                "w_out": ((n_sb, f, d), dt, "dense")},
    }
    specs = {"embed": {"table": ((v, d), dt, "embed")},
             "blocks": {f"l{i}": layer
                        for i in range(len(_layer_kinds(cfg)))},
             "final_norm": {"scale": ((d,), f32, "ones")}}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ((d, v), dt, "dense")}
    return specs


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random weights made on `device` from a seeded ``torch.Generator``:
    normal · 1/√fan_in for projections, normal · 0.02 for the embedding,
    ones for norm scales (the reference's initialisers; the two frameworks'
    generators give different numbers, so parity tests convert the JAX
    weights instead). Stacked leaves are filled one superblock at a time to
    bound the float32 temporaries."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(spec):
        shape, dtype, init = spec
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "embed":
            return L.embed_init(shape, dtype, gen, device)
        if len(shape) == 2:
            return L.dense_init(shape, dtype, gen, device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = L.dense_init(shape[1:], dtype, gen, device)
        return out

    return _map_specs(make, param_specs(cfg))


def _at(tree, i):
    """Superblock i of a stacked (n_sb, ...) dict tree, as views."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def logits(cfg: ModelConfig, params, hidden):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], hidden)
    return hidden @ params["lm_head"]["w"]


def _embed_tokens(cfg, params, tokens):
    x = L.embed(params["embed"], tokens)
    if cfg.family != "ssm":
        x = x * float(np.sqrt(cfg.d_model))
    return x


# -------------------------------------------------------------------- forward
def _apply_layer_train(kind, lp, x, positions, cfg):
    """One layer over a full sequence: x + attention, then x + MLP.
    Returns (x, aux loss)."""
    if kind == "moe_attn":
        raise NotImplementedError(
            "layer kind 'moe_attn' (MoE) comes with the MoE slice of the port "
            "(ROADMAP A13)")
    if kind not in _ATTN_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} (recurrent / hybrid) comes with the "
            f"recurrent slice of the port (ROADMAP A9)")
    window = None
    if kind == "local" or (cfg.attention_type == "sliding" and kind == "attn"):
        window = cfg.window_size
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + A.attention_train(lp["attn"], h, positions, cfg, window=window)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + L.swiglu(lp["mlp"], h), 0.0


def _checkpointed(fn):
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def forward(cfg: ModelConfig, params, inputs):
    """inputs: {"tokens": (B,S)} or {"embeds": (B,S,D)}, optional
    "positions" (B,S). Returns (hidden (B,S,D), aux_loss f32 scalar).

    With ``cfg.remat`` each superblock is checkpointed (only its input is
    kept; its layers run again in the backward pass), and when a superblock
    has more than one layer each layer is checkpointed again inside it, so
    the superblock's backward holds one layer's intermediates at a time.
    Gradients reach the stacked (n_sb, ...) weights through the superblock
    views (``_at``)."""
    if "embeds" in inputs:
        x = inputs["embeds"].to(L.dtype_of(cfg))
    else:
        x = _embed_tokens(cfg, params, inputs["tokens"])
    B, Sq = x.shape[0], x.shape[1]
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    kinds = _layer_kinds(cfg)
    layer_fn = _apply_layer_train
    if cfg.remat and len(kinds) > 1:
        layer_fn = _checkpointed(_apply_layer_train)

    def sb_fn(x, sb_params):
        aux = 0.0
        for i, kind in enumerate(kinds):
            x, a = layer_fn(kind, sb_params[f"l{i}"], x, positions, cfg)
            aux = aux + a
        return x, aux

    if cfg.remat:
        sb_fn = _checkpointed(sb_fn)
    n_sb, _ = superblock_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sb in range(n_sb):
        x, a = sb_fn(x, _at(params["blocks"], sb))
        aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def _ce_chunk(h, labels, head):
    """Summed cross-entropy of one chunk: h (B, c, D) against head (D, V)."""
    lg = (h @ head).float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    return torch.sum(lse - gold)


def loss_fn(cfg: ModelConfig, params, batch):
    """Chunked cross-entropy over sequence chunks of ``cfg.loss_chunk``,
    each chunk checkpointed so its (B, chunk, V) f32 logits are recomputed
    in the backward pass instead of stored; plus 0.01 · aux. The gold logit
    is a gather (the reference contracts a one-hot only to keep its
    vocab-sharded logits sharded). batch: {"tokens", "labels"} (B, S)."""
    hidden, aux = forward(cfg, params, batch)
    labels = batch["labels"].long()
    B, Sq, _ = hidden.shape
    chunk = min(cfg.loss_chunk, Sq)
    if Sq % chunk:
        raise ValueError(f"sequence length {Sq} is not a multiple of "
                         f"loss_chunk {chunk}")
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])                          # (D, V)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, Sq, chunk):
        total = total + checkpoint(_ce_chunk, hidden[:, c0:c0 + chunk],
                                   labels[:, c0:c0 + chunk], head,
                                   use_reentrant=False)
    return total / (B * Sq) + 0.01 * aux


# -------------------------------------------------------------- paged decode
def init_paged_state(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device="cuda", kv_quant=None):
    """Per-superblock, per-layer paged KV pools (n_sb, num_blocks + 1, bs,
    Hkv, hd) — all layers share one block table per sequence, each layer
    owns its pool storage (ring layers use the table's first ring_pages
    entries modulo the ring), and block num_blocks is the scratch block.
    `kv_quant` (KVQuantConfig) makes the pools int8 with per-vector f32
    scales; the decode, prefill and verify steps dispatch on the pools'
    structure ("k_scale" in the layer's dict)."""
    check_supported(cfg)
    n_sb, _ = superblock_layout(cfg)
    providers = SP.providers_for(cfg, num_blocks=num_blocks,
                                 block_size=block_size, kv_quant=kv_quant)
    return {f"l{i}": p.init_layer_state(n_sb, device)
            for i, p in enumerate(providers)}


def _attn_block(p, h_in, attn_out, cfg):
    """Residual + MLP tail shared by every attention-layer dispatch."""
    x = h_in + attn_out
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.swiglu(p["mlp"], h)


def _layers(cfg, params, pool, draft):
    """Every layer in order: (layer params, layer pool, window, ring_pages)
    as views of superblock sb; window and ring_pages are None for full
    layers. ``draft`` sets the ring slack (ring_pages(window, bs, draft)).
    The params and pools were made for a supported config (param_specs and
    init_paged_state check it)."""
    n_sb, _ = superblock_layout(cfg)
    skinds = SP.state_kinds(cfg)
    for sb in range(n_sb):
        for i, skind in enumerate(skinds):
            st = _at(pool[f"l{i}"], sb)
            window = rp = None
            if skind == "ring":
                window = cfg.window_size
                rp = SP.ring_pages(window, st["k"].shape[1], draft=draft)
            yield _at(params["blocks"][f"l{i}"], sb), st, window, rp


def paged_decode_step(cfg: ModelConfig, params, pool, inputs, block_tables,
                      positions, attn_lens, *, draft=0):
    """One-token decode for a continuous batch of slots. inputs: {"token":
    (B,)}; block_tables: (B, P) int32; positions: (B,) absolute position of
    each incoming token; attn_lens: (B,) int32 tokens to attend over
    including the new one (0 = inactive slot). ``draft`` must match the
    engine's speculative K-1 (0 when speculation is off) so ring layers use
    the same ring as the verify step. Returns (logits (B,V), pool updated
    in place)."""
    x = _embed_tokens(cfg, params, inputs["token"][:, None])
    for lp, st, window, rp in _layers(cfg, params, pool, draft):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = A.attention_decode_paged(lp["attn"], h, st, block_tables,
                                        positions, attn_lens, cfg,
                                        window=window, ring_pages=rp)
        x = _attn_block(lp, x, y, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits(cfg, params, x)[:, 0], pool


def paged_verify_step(cfg: ModelConfig, params, pool, tokens, block_tables,
                      base, qlims):
    """Multi-query speculative verify for a continuous batch of slots.
    tokens: (B, K) — K draft tokens per slot, draft j at absolute position
    `base[b] + j`; qlims: (B,) number of draft positions that may commit
    K/V this step (0 = inactive slot). Each layer writes the first qlims[b]
    drafts' K/V (write-then-attend) and attends causally among the draft
    positions; ring layers use the ring with K-1 slack. Returns (logits
    (B, K, V), pool updated in place)."""
    x = _embed_tokens(cfg, params, tokens)                        # (B, K, D)
    for lp, st, window, rp in _layers(cfg, params, pool,
                                      tokens.shape[1] - 1):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = A.attention_verify_paged(lp["attn"], h, st, block_tables,
                                        base, qlims, cfg, window=window,
                                        ring_pages=rp)
        x = _attn_block(lp, x, y, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits(cfg, params, x), pool


def paged_prefill_packed(cfg: ModelConfig, params, pool, tokens, tables,
                         starts, valids, slots, *, draft=0):
    """Segment-masked packed prefill: one prompt chunk per segment, all
    segments in ONE call. tokens: (G, C) int32 — segment g's chunk starts
    at absolute position `starts[g]` with the first `valids[g]` tokens real;
    tables: (S, P) block-table rows indexed by `slots`. `slots[g] >= S`
    marks an all-padding segment (valids[g] == 0): its table gather clamps
    and its writes go to the scratch block. ``draft`` as in
    :func:`paged_decode_step`. Returns (logits (G, V) of each segment's
    last valid token, pool updated in place)."""
    x = _embed_tokens(cfg, params, tokens)
    rows = tables[torch.clamp(slots, max=tables.shape[0] - 1).long()]
    for lp, st, window, rp in _layers(cfg, params, pool, draft):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if window is None:
            y, _ = A.attention_prefill_paged(lp["attn"], h, st, rows, starts,
                                             valids, cfg)
        else:
            y, _ = A.attention_prefill_ring(lp["attn"], h, st, rows, starts,
                                            valids, cfg, window=window,
                                            ring_pages=rp)
        x = _attn_block(lp, x, y, cfg)
    idx = torch.clamp(valids - 1, min=0).long()                   # (G,)
    last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    last = L.rmsnorm(params["final_norm"], last, cfg.norm_eps)    # (G, 1, D)
    return logits(cfg, params, last)[:, 0], pool


def paged_prefill_step(cfg: ModelConfig, params, pool, tokens, table_row,
                       start, valid_len, slot, *, draft=0):
    """Chunked prefill of ONE sequence (a G=1 packed call). tokens: (1, C)
    chunk starting at absolute position `start`, first `valid_len` real;
    `table_row` (P,). Returns (logits (1,V) of the chunk's last valid
    token, pool)."""
    dev = tokens.device

    def one(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    return paged_prefill_packed(cfg, params, pool, tokens, table_row[None],
                                one(start), one(valid_len), one(slot),
                                draft=draft)
