"""GQA attention against the paged KV pool: decode and packed prefill.

Counterpart of the paged verbs in ``repro.models.attention`` (full mode).
The reference returns new pools; here the pools are updated IN PLACE (the
returned dict is the one passed in), which saves a pool copy per layer.
Rows the reference drops with ``mode="drop"`` go to the pool's scratch
block at index N (see ``state_providers``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention.ref import NEG_INF
from repro_torch.models import layers as L


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _project_qkv(params, x, positions, cfg):
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(x @ params["wk"], hkv, hd)
    v = _split_heads(x @ params["wv"], hkv, hd)
    if cfg.rope_mode == "standard":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_mode != "none":
        raise NotImplementedError(
            f"rope_mode {cfg.rope_mode!r} comes in a later slice of the port")
    return q, k, v


def _scratch_block(kv) -> int:
    return kv["k"].shape[0] - 1


def paged_write(kv, k_new, v_new, block_tables, positions, active):
    """Scatter one token's K/V per sequence into the block pool, in place.

    kv: {"k","v"}: (N + 1, bs, Hkv, hd), block N the scratch block;
    k_new/v_new: (B, Hkv, hd); block_tables: (B, P); positions: (B,)
    absolute token position; active: (B,) bool — inactive rows land in the
    scratch block."""
    bs = kv["k"].shape[1]
    P = block_tables.shape[1]
    pages = torch.clamp(positions // bs, max=P - 1).long()
    bids = torch.gather(block_tables, 1, pages[:, None])[:, 0]
    bids = torch.where(active, bids, _scratch_block(kv)).long()
    offs = (positions % bs).long()
    kv["k"][bids, offs] = k_new
    kv["v"][bids, offs] = v_new
    return kv


def attention_decode_paged(params, x, kv, block_tables, positions, attn_lens,
                           cfg):
    """One-token decode against a paged KV pool. x: (B,1,D); kv k/v pools
    (N + 1, bs, Hkv, hd); block_tables (B, P); positions (B,) absolute
    position of the incoming token; attn_lens (B,) tokens to attend over
    INCLUDING the new one (0 marks an inactive slot — its write goes to the
    scratch block and its output is garbage the engine ignores). Returns
    (out (B,1,D), kv updated in place)."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, positions[:, None], cfg)
    paged_write(kv, k_new[:, 0], v_new[:, 0], block_tables, positions,
                attn_lens > 0)
    out = paged_attention(q[:, 0].contiguous(), kv["k"], kv["v"],
                          block_tables, attn_lens)
    out = out.reshape(B, 1, h * hd)
    return out @ params["wo"], kv


def attention_prefill_paged(params, x, kv, table_rows, starts, valids, cfg):
    """Segment-masked packed prefill against the paged pool. x: (G,C,D) —
    one prompt chunk per segment, segment g starting at absolute position
    `starts[g]`, of which the first `valids[g]` tokens are real (`valids[g]
    == 0` marks an all-padding segment whose writes all go to the scratch
    block). Writes each segment's chunk K/V into the pool in place, then
    attends causally over each segment's own prefix gathered via its table
    row. Returns (out (G,C,D), kv)."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G, C = x.shape[0], x.shape[1]
    ar = torch.arange(C, device=x.device, dtype=starts.dtype)
    pos = starts[:, None] + ar[None, :]                           # (G, C)
    q, k, v = _project_qkv(params, x, pos, cfg)

    bs = kv["k"].shape[1]
    P = table_rows.shape[1]
    valid = ar[None, :] < valids[:, None]                         # (G, C)
    # padding positions may index past the table; only masked rows do
    pages = torch.clamp(pos // bs, max=P - 1).long()
    bids = torch.where(valid, torch.gather(table_rows, 1, pages),
                       _scratch_block(kv)).long()
    offs = (pos % bs).long()
    kv["k"][bids, offs] = k
    kv["v"][bids, offs] = v

    n_rep = h // hkv
    kk = _repeat_kv(kv["k"][table_rows].reshape(G, P * bs, hkv, hd), n_rep)
    vv = _repeat_kv(kv["v"][table_rows].reshape(G, P * bs, hkv, hd), n_rep)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    kpos = torch.arange(P * bs, device=x.device)
    mask = kpos[None, None, :] <= pos[:, :, None]                 # (G, C, P*bs)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv).reshape(G, C, h * hd)
    return out @ params["wo"], kv
