"""GQA attention: training over a full sequence; the dense (non-paged)
cache's prefill and one-token decode (``serve.generate``'s path); and
against the paged KV pool decode, packed prefill and speculative verify, in
full and ring (sliding-window) layouts.

Counterpart of ``attention_train`` and the paged verbs in
``repro.models.attention``. Training attention takes the device's path:
on CUDA the hand-written flash-attention kernel (``kernels/flash_attention``,
the reference's "TPU-native third" strategy); on the CPU the reference's
two XLA strategies, ``naive`` (materialized scores) and ``chunked`` (query
chunks, each checkpointed), which are its oracle for that kernel.

For the cache and paged verbs the reference returns new caches and pools;
here they are updated IN PLACE (the returned dict is the one passed in), which saves a pool copy per layer. Rows the reference
drops with ``mode="drop"`` go to the pool's scratch block at index N (see
``state_providers``). An int8 pool (a dict with "k_scale"/"v_scale")
quantizes every write and scatters the scales at the same (block, offset);
the kernels dequantize on read.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import parallelism as par
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_verify)
from repro_torch.kernels.paged_attention.ref import (NEG_INF, _gather_pool,
                                                     ring_key_positions)
from repro_torch.kernels.quantize import dequantize_kv, quantize_kv
from repro_torch.models import layers as L
from repro_torch.models.state_providers import alloc_kv_pool


def _quantize_pair(k, v):
    """Quantize a K/V write for an int8 pool: per-vector nearest-even
    rounding, so every path (paged prefill, decode, verify, re-prefill after
    a preemption) stores identical values for the same input vector."""
    qk, sk = quantize_kv(k)
    qv, sv = quantize_kv(v)
    return qk, sk, qv, sv


def _scales(kv):
    """The kernels' scale arguments: an int8 pool's scale pools, or none."""
    return dict(k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"))


def _scatter(kv, bids, offs, k, v, quantized=None):
    """Write K/V rows at (block, offset), in place; an int8 pool stores the
    quantized values and their scales (`quantized`, if the caller has
    quantized k and v already)."""
    if "k_scale" in kv:
        qk, sk, qv, sv = quantized or _quantize_pair(k, v)
        kv["k"][bids, offs] = qk
        kv["v"][bids, offs] = qv
        kv["k_scale"][bids, offs] = sk
        kv["v_scale"][bids, offs] = sv
    else:
        kv["k"][bids, offs] = k
        kv["v"][bids, offs] = v


def _split_heads(x, n, hd, pl=None):
    """(..., n·hd) -> (..., n, hd). A DTensor is first put in the
    placements `pl` (its attention layout, `_head_layout`), which split
    its last dim into whole heads only: DTensor cannot view a dim split
    within a head as (n, hd), nor, in the backward pass, the gradient of
    one."""
    if pl is not None and par.is_dtensor(x) and tuple(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    return x.reshape(x.shape[:-1] + (n, hd))


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    if par.is_dtensor(k):
        # each rank's kv heads feed its own contiguous query heads, so the
        # repeat runs on the local heads whatever their placement
        from torch.distributed.tensor.experimental import local_map
        pl = list(k.placements)
        return local_map(lambda t: torch.repeat_interleave(t, n_rep, dim=2),
                         out_placements=pl, in_placements=(pl,),
                         device_mesh=k.device_mesh)(k)
    return torch.repeat_interleave(k, n_rep, dim=2)


def _project_qkv(params, x, positions, cfg):
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q_pl = kv_pl = None
    if par.is_dtensor(x):
        q_pl, kv_pl, _ = _head_layout(x.device_mesh, x.shape[:2], h, hkv, hd)
    q = _split_heads(x @ params["wq"], h, hd, q_pl)
    k = _split_heads(x @ params["wk"], hkv, hd, kv_pl)
    v = _split_heads(x @ params["wv"], hkv, hd, kv_pl)
    if cfg.rope_mode == "standard":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_mode == "mrope":
        q = L.apply_mrope(q, positions, cfg.rope_theta)
        k = L.apply_mrope(k, positions, cfg.rope_theta)
    elif cfg.rope_mode != "none":
        raise ValueError(f"unknown rope_mode {cfg.rope_mode!r}")
    return q, k, v


def _plain_qkv(params, x, positions, cfg):
    """`_project_qkv` for the paged verbs: under a sharding plan q, k and v
    are gathered whole, since the paged pools are plain tensors holding
    every kv head on every rank (the reference gives them no sharding);
    the kernels then take every head."""
    return tuple(par.full(t) for t in _project_qkv(params, x, positions,
                                                    cfg))


def rope_positions(pos, cfg):
    """The positions a serving verb gives `_project_qkv`: `pos` itself, or
    under M-RoPE the text position in all three streams, (3, *pos.shape),
    as the reference's verbs broadcast it (a view, no copy)."""
    if cfg.rope_mode == "mrope":
        return pos[None].expand((3,) + tuple(pos.shape))
    return pos


def _mask(q_pos, k_pos, window):
    """causal (+ optional sliding window) mask: True = attend."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _attend_full(q, k, v, n_rep, scale, chunk, window):
    """Full-sequence causal(+window) attention, dispatching naive/chunked
    (chunked needs S % chunk == 0; odd lengths take the naive path)."""
    S = q.shape[1]
    if S <= chunk or S % chunk != 0:
        kk = _repeat_kv(k, n_rep)
        vv = _repeat_kv(v, n_rep)
        qpos = torch.arange(S, device=q.device)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
        mask = _mask(qpos, qpos, window)
        scores = torch.where(mask[None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    return _chunked_attention(q, k, v, n_rep, scale, chunk, window)


def attention_train(params, x, positions, cfg, *, window=None,
                    impl="chunked"):
    """Self-attention over a full sequence. x: (B,S,D); positions (B,S),
    or (3,B,S) under M-RoPE.
    A CUDA tensor runs the flash-attention kernel (`impl` is not read); a
    CPU tensor takes the reference's `impl`: "naive" or "chunked" (query
    chunks of ``cfg.attn_chunk``)."""
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(params, x, positions, cfg)
    S = x.shape[1]
    if x.is_cuda:
        def attend(q, k, v):
            return flash_attention(q, k, v, causal=True, window=window)
    else:
        chunk = S if impl == "naive" else cfg.attn_chunk

        def attend(q, k, v):
            return _attend_full(q, k, v, q.shape[2] // k.shape[2],
                                1.0 / np.sqrt(hd), chunk, window)
    out = _on_local_heads(attend, q, k, v)
    return _merge_heads(out) @ params["wo"]


def _merge_heads(x):
    """(B, S, H, hd) -> (B, S, H·hd). On a DTensor the gradient reaching
    the merged tensor is put back in its placements first, which split it
    into whole heads: the output projection's backward gives it split as
    that weight's rows, within a head where the heads do not divide the
    tensor axes."""
    out = x.reshape(x.shape[:2] + (x.shape[2] * x.shape[3],))
    if par.is_dtensor(out) and out.requires_grad:
        out = par._ConstrainGrad.apply(out)
    return out


def _on_local_heads(fn, q, k, v):
    """fn(q, k, v) -> (B, S, H, hd); on DTensors (a sharding plan) it runs
    through ``local_map`` on each rank's own rows and heads, in the layout
    of `_head_layout`, so a kernel only ever sees plain local tensors.
    Where the kv heads stay whole over the axes that split the query heads
    (GQA with fewer kv heads than ranks: yi-9b's 4 on a 16-way 'model'
    axis) each rank takes the kv heads its own query heads read, as GSPMD
    splits the reference's attention; their gradient is a partial sum over
    those axes. The gradients leaving `fn` for q, k and v are made
    contiguous: the attention backward gives them permuted, and DTensor
    views a gradient's local tensor where its global one is contiguous (a
    split-head MHA layer's projection backward failed on that view)."""
    if not par.is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    shape = [min(a, b) for a, b in zip(q.shape[:2], k.shape[:2])]
    q_pl, kv_pl, kv = _head_layout(mesh, shape, q.shape[2], k.shape[2],
                                   q.shape[3])
    lo, hi = kv or (0, None)
    kv_grad = tuple(Partial() if a != b else b for a, b in zip(q_pl, kv_pl))

    def local(q, k, v):
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        if kv is not None:
            k, v = k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
        return fn(q, k, v)
    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _head_layout(mesh, bs, H, Hkv, hd):
    """(q placements, k / v placements, kv heads (lo, hi) this rank reads)
    of attention's (B, S, heads, hd) tensors under the current plan, bs
    being (B, S). The query heads split over the longest leading run of
    the plan's tensor axes whose size divides them (the projections'
    columns split over those axes major first, so a rank's block of
    columns holds whole heads and the re-layout moves data within the
    remaining axes only); the batch splits over the plan's batch axes and
    those remaining tensor axes, as many of them as divide it (attention
    is independent per row: GSPMD splits the reference's so where the
    heads do not divide). The kv heads split as the query heads where the
    axes divide them; otherwise they stay whole there and each rank reads
    the kv heads of its own query heads (None: all it holds). Without a
    plan everything is replicated."""
    plan = par.current_plan()
    if plan is None:
        rep = par.placements(par.P(), mesh)
        return rep, rep, None
    t, kv = plan.tensor_axes, None
    heads = ()
    for n in range(len(t), 0, -1):
        if par._divisible(H, t[:n], plan.shape):
            kv = _kv_heads_of_rank(plan, mesh, t[:n], H, Hkv)
            if par._divisible(Hkv, t[:n], plan.shape) or kv is not None:
                heads = t[:n]
                break
    rest, batch = t[len(heads):], ()
    for n in range(len(rest), -1, -1):
        if par._divisible(bs[0], plan.batch_axes + rest[:n], plan.shape):
            batch = plan.batch_axes + rest[:n]
            break
    kv_heads = () if kv is not None else heads

    def pl(h_axes, n):
        spec = par.P(batch or None, None, h_axes or None, None)
        return par.placements(spec, mesh, (bs[0], bs[1], n, hd))
    return pl(heads, H), pl(kv_heads, Hkv), kv


def _kv_heads_of_rank(plan, mesh, heads, H, Hkv):
    """(lo, hi): the kv heads that this rank's query heads read when the
    query heads split over the tensor axes `heads` and the kv heads do not
    (each rank's block of H / |heads| query heads maps onto whole kv
    heads); None otherwise."""
    if not heads or par._divisible(Hkv, heads, plan.shape) \
            or not par._divisible(H, heads, plan.shape):
        return None
    h_loc, rep = H // plan.axis_size(heads), H // Hkv
    if h_loc % rep and rep % h_loc:
        return None
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    r = 0
    for a in heads:
        r = r * mesh.size(names.index(a)) + coord[names.index(a)]
    return r * h_loc // rep, ((r + 1) * h_loc - 1) // rep + 1


class _ContiguousGrad(torch.autograd.Function):
    """Identity; its gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _chunked_attention(q, k, v, n_rep, scale, chunk, window):
    """Online-softmax attention over query chunks (flash-style), each chunk
    checkpointed: its scores and probabilities are recomputed in the
    backward pass, so peak live memory stays O(one chunk).

    For sliding-window layers each query chunk only reads the KV slice
    [chunk_start - window, chunk_end) — sub-quadratic work.
    """
    B, S, H, hd = q.shape
    kk = _repeat_kv(k, n_rep)          # (B, S, H, hd)
    vv = _repeat_kv(v, n_rep)
    kpos_all = torch.arange(S, device=q.device)
    span = None
    if window is not None:
        span = int(min(S, chunk * int(np.ceil(window / chunk)) + chunk))

    def one_chunk(q_start, q_chunk):
        qpos = q_start + torch.arange(chunk, device=q.device)
        if span is None:
            keys, vals, kpos = kk, vv, kpos_all
        else:
            k_start = max(q_start + chunk - span, 0)
            keys = kk[:, k_start:k_start + span]
            vals = vv[:, k_start:k_start + span]
            kpos = kpos_all[k_start:k_start + span]
        s = torch.einsum("bqhd,bkhd->bhqk", q_chunk, keys).float() * scale
        m = _mask(qpos, kpos, window)
        s = torch.where(m[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, vals)

    outs = [checkpoint(one_chunk, q0, q[:, q0:q0 + chunk], use_reentrant=False)
            for q0 in range(0, S, chunk)]
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------ dense cache
def init_kv_cache(cfg, batch, max_len, window=None, kv_quant=None,
                  device="cuda"):
    """Dense decode cache (batch, size, Hkv, hd), size = max_len, or a ring
    of min(max_len, window) slots for a sliding-window layer; int8 with
    per-vector scales with `kv_quant`."""
    size = min(max_len, window) if window is not None else max_len
    return alloc_kv_pool((batch, size), cfg.num_kv_heads,
                         cfg.resolved_head_dim, L.dtype_of(cfg), device,
                         kv_quant)


def _store(cache, slots, k, v, quantized=None):
    """cache[:, slots] = k / v (their int8 values and scales for an int8
    cache), in place."""
    if "k_scale" in cache:
        qk, sk, qv, sv = quantized or _quantize_pair(k, v)
        vals = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        vals = {"k": k, "v": v}
    for name, val in vals.items():
        par.write_along(cache[name], 1, slots, val)


def attention_prefill(params, x, cache, cfg, *, window=None):
    """Batched prefill: full-sequence causal attention and the cache fill in
    one pass. x: (B,S,D) starting at position 0. Writes K/V into the dense
    cache in place (ring-aware for sliding-window layers: only the last
    min(S, size) positions land, at their ring slots). An int8 cache makes
    the queries attend the round-tripped values, as the paged prefill reads
    its keys back from the int8 pool. Returns (out (B,S,D), cache)."""
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _project_qkv(params, x, rope_positions(positions, cfg), cfg)
    quantized = None
    if "k_scale" in cache:
        quantized = qk, sk, qv, sv = _quantize_pair(k, v)
        k = dequantize_kv(qk, sk).to(k.dtype)
        v = dequantize_kv(qv, sv).to(v.dtype)
    out = _on_local_heads(
        lambda q, k, v: _attend_full(q, k, v, q.shape[2] // k.shape[2],
                                     1.0 / np.sqrt(hd),
                                     cfg.attn_chunk, window), q, k, v)
    out = _merge_heads(out) @ params["wo"]

    Sc = cache["k"].shape[1]
    keep = min(S, Sc)                       # ring slots are unique for the
    slots = torch.arange(S - keep, S, device=x.device) % Sc   # last `keep`
    tail = slice(S - keep, S)
    if quantized is not None:
        quantized = tuple(a[:, tail] for a in quantized)
    _store(cache, slots, k[:, tail], v[:, tail], quantized)
    return out, cache


def attention_decode(params, x, cache, index, cfg, *, window=None):
    """One-token decode against the dense cache. x: (B,1,D); cache k/v:
    (B,Sc,Hkv,hd); index: the token's absolute position (an int). Writes
    the token's K/V in place (slot index % Sc in a ring) and attends every
    valid slot: slot <= index, or in a ring an age below min(index+1, Sc).
    Returns (out (B,1,D), cache)."""
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    positions = torch.full((B, 1), index, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, rope_positions(positions, cfg),
                                   cfg)
    Sc = cache["k"].shape[1]
    slot = index % Sc if window is not None else index      # ring buffer
    _store(cache, slot, k_new[:, 0], v_new[:, 0])
    if "k_scale" in cache:
        k = dequantize_kv(cache["k"], cache["k_scale"]).to(x.dtype)
        v = dequantize_kv(cache["v"], cache["v_scale"]).to(x.dtype)
    else:
        k, v = cache["k"], cache["v"]
    kpos = torch.arange(Sc, device=x.device)
    if window is not None:
        # ring buffer: valid entries were written within the last
        # min(index + 1, Sc) steps
        valid = (slot - kpos) % Sc < min(index + 1, Sc)
    else:
        valid = kpos <= index

    scale = 1.0 / np.sqrt(hd)

    def attend(q, k, v):
        rep = q.shape[2] // k.shape[2]     # this rank's heads' ratio
        kk, vv = _repeat_kv(k, rep), _repeat_kv(v, rep)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, vv)
    out = _merge_heads(_on_local_heads(attend, q, k, v))
    return out @ params["wo"], cache


# ------------------------------------------------------------ paged verbs
def _scratch_block(kv) -> int:
    return kv["k"].shape[0] - 1


def _block_ids(kv, block_tables, positions, valid, ring_pages):
    """Pool block of each position (B, K) through its table row; pages are
    taken modulo the ring in ring mode and clamped to the table (only rows
    that `valid` drops can index past it); dropped rows get the scratch
    block."""
    bs = kv["k"].shape[1]
    pages = positions // bs
    if ring_pages is not None:
        pages = pages % ring_pages
    pages = torch.clamp(pages, 0, block_tables.shape[1] - 1).long()
    bids = torch.gather(block_tables, 1, pages)
    return torch.where(valid, bids, _scratch_block(kv)).long()


def paged_write(kv, k_new, v_new, block_tables, positions, active, *,
                ring_pages=None):
    """Scatter one token's K/V per sequence into the block pool, in place.

    kv: {"k","v"}: (N + 1, bs, Hkv, hd), block N the scratch block;
    k_new/v_new: (B, Hkv, hd); block_tables: (B, P); positions: (B,)
    absolute token position; active: (B,) bool — inactive rows land in the
    scratch block. ring_pages: sliding-window layers write page
    (pos // bs) % ring_pages."""
    return paged_write_multi(kv, k_new[:, None], v_new[:, None],
                             block_tables, positions[:, None],
                             active[:, None], ring_pages=ring_pages)


def attention_decode_paged(params, x, kv, block_tables, positions, attn_lens,
                           cfg, *, window=None, ring_pages=None):
    """One-token decode against a paged KV pool. x: (B,1,D); kv k/v pools
    (N + 1, bs, Hkv, hd); block_tables (B, P); positions (B,) absolute
    position of the incoming token; attn_lens (B,) tokens to attend over
    INCLUDING the new one (0 marks an inactive slot — its write goes to the
    scratch block and its output is garbage the engine ignores).
    window/ring_pages switch sliding-window layers to the ring layout (write
    modulo the ring, attend the last `window` positions). Returns (out
    (B,1,D), kv updated in place)."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    B = x.shape[0]
    q, k_new, v_new = _plain_qkv(params, x,
                                 rope_positions(positions[:, None], cfg), cfg)
    paged_write(kv, k_new[:, 0], v_new[:, 0], block_tables, positions,
                attn_lens > 0, ring_pages=ring_pages)
    ring = {} if window is None else dict(window=window, positions=positions,
                                         ring_pages=ring_pages)
    out = paged_attention(q[:, 0].contiguous(), kv["k"], kv["v"],
                          block_tables, attn_lens, **ring, **_scales(kv))
    out = out.reshape(B, 1, h * hd)
    return out @ params["wo"], kv


def paged_write_multi(kv, k_new, v_new, block_tables, positions, valid, *,
                      ring_pages=None):
    """Scatter K draft tokens' K/V per sequence into the block pool, in
    place. k_new/v_new: (B, K, Hkv, hd); positions: (B, K) absolute token
    positions; valid: (B, K) bool — invalid (rejected-horizon or inactive)
    writes go to the scratch block, so pool contents stay canonical.
    ring_pages: sliding-window layers write page (pos // bs) % ring_pages.
    Int8 pools quantize on write, scales at the same (block, offset)."""
    bids = _block_ids(kv, block_tables, positions, valid, ring_pages)
    offs = (positions % kv["k"].shape[1]).long()
    _scatter(kv, bids, offs, k_new, v_new)
    return kv


def attention_verify_paged(params, x, kv, block_tables, base, qlims, cfg, *,
                           window=None, ring_pages=None):
    """Multi-query speculative verify against a paged KV pool. x: (B,K,D) —
    K draft tokens per sequence, draft j at absolute position base[b] + j.
    qlims (B,): number of draft positions whose K/V may be written this step
    (0 marks an inactive slot); queries at or past qlims produce garbage the
    engine discards, and their writes go to the scratch block so
    rejected-horizon KV never lands in the pool. window/ring_pages switch
    sliding-window layers to the ring layout — the ring must be sized with
    `draft = K - 1` slack (see state_providers.ring_pages). Returns (out
    (B,K,D), kv updated in place)."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    B, K = x.shape[0], x.shape[1]
    ar = torch.arange(K, device=x.device, dtype=base.dtype)
    positions = base[:, None] + ar[None, :]                       # (B, K)
    q, k_new, v_new = _plain_qkv(params, x, rope_positions(positions, cfg),
                                 cfg)
    write = ar[None, :] < qlims[:, None]                          # (B, K)
    paged_write_multi(kv, k_new, v_new, block_tables, positions, write,
                      ring_pages=ring_pages)
    attn_lens = torch.where(qlims > 0, base + K, 0).to(torch.int32)
    ring = {} if window is None else dict(
        window=window, positions=attn_lens - 1, ring_pages=ring_pages)
    out = paged_attention_verify(q.contiguous(), kv["k"], kv["v"],
                                 block_tables, attn_lens, **ring,
                                 **_scales(kv))
    out = out.reshape(B, K, h * hd)
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
    q, k, v = _plain_qkv(params, x, rope_positions(pos, cfg), cfg)

    bs = kv["k"].shape[1]
    P = table_rows.shape[1]
    valid = ar[None, :] < valids[:, None]                         # (G, C)
    # padding positions may index past the table; only masked rows do
    bids = _block_ids(kv, table_rows, pos, valid, None)
    offs = (pos % bs).long()
    _scatter(kv, bids, offs, k, v)

    # the gather below reads the pool back (dequantized for an int8 pool),
    # so every query attends the values the decode kernel will later see
    n_rep = h // hkv
    if "k_scale" in kv:
        kk = _gather_pool(kv["k"], table_rows, P * bs, kv["k_scale"])
        vv = _gather_pool(kv["v"], table_rows, P * bs, kv["v_scale"])
        kk, vv = kk.to(x.dtype), vv.to(x.dtype)
    else:
        kk = kv["k"][table_rows].reshape(G, P * bs, hkv, hd)
        vv = kv["v"][table_rows].reshape(G, P * bs, hkv, hd)
    kk, vv = _repeat_kv(kk, n_rep), _repeat_kv(vv, n_rep)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    kpos = torch.arange(P * bs, device=x.device)
    mask = kpos[None, None, :] <= pos[:, :, None]                 # (G, C, P*bs)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv).reshape(G, C, h * hd)
    return out @ params["wo"], kv


def attention_prefill_ring(params, x, kv, table_rows, starts, valids, cfg,
                           *, window, ring_pages):
    """Segment-masked packed prefill against a RING-paged pool. x: (G,C,D) —
    one chunk per segment starting at `starts[g]`, first `valids[g]` tokens
    real. Each segment owns only `ring_pages` blocks; its position p lives
    at `table_rows[g, (p // bs) % ring_pages]`, offset `p % bs`.

    The pre-chunk ring content is gathered BEFORE the chunk's writes: on
    wraparound the chunk overwrites pages that early queries still need.
    The gather (advanced indexing) copies, so the in-place scatter below
    cannot reach it. Each query t attends the union of {its segment's
    pre-chunk ring keys} and {its segment's chunk}, masked to its window
    (t - window, t]. Returns (out (G,C,D), kv updated in place)."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G, C = x.shape[0], x.shape[1]
    ar = torch.arange(C, device=x.device, dtype=starts.dtype)
    pos = starts[:, None] + ar[None, :]                           # (G, C)
    q, k, v = _plain_qkv(params, x, rope_positions(pos, cfg), cfg)
    quant = "k_scale" in kv
    quantized = None
    if quant:
        # the chunk's keys are attended from here, not read back from the
        # pool: round-trip them so they equal what later decode steps read
        quantized = qk, sk, qv, sv = _quantize_pair(k, v)
        k = dequantize_kv(qk, sk).to(k.dtype)
        v = dequantize_kv(qv, sv).to(v.dtype)

    bs = kv["k"].shape[1]
    R = ring_pages

    # 1) each segment's ring as of starts - 1, copied (and dequantized,
    # scales included) before the writes
    ring_rows = table_rows[:, :R].long()                          # (G, R)
    if quant:
        old_k = _gather_pool(kv["k"], ring_rows, R * bs,
                             kv["k_scale"]).to(x.dtype)
        old_v = _gather_pool(kv["v"], ring_rows, R * bs,
                             kv["v_scale"]).to(x.dtype)
    else:
        old_k = kv["k"][ring_rows].reshape(G, R * bs, hkv, hd)
        old_v = kv["v"][ring_rows].reshape(G, R * bs, hkv, hd)
    old_pos = ring_key_positions(starts - 1, R, bs)               # (G, R*bs)
    # entries the pre-chunk ring never held: pages < 0 entirely, and the
    # current page's offsets past (start-1) % bs (previous-lap leftovers,
    # reconstructed as > start-1)
    old_ok = (old_pos >= 0) & (old_pos <= (starts - 1)[:, None])

    # 2) write the chunk's K/V at their ring slots. Padding rows go to the
    # scratch block, and so does any position lapped by a LATER valid
    # position of this same chunk (C can exceed the ring capacity R*bs):
    # an index_put with repeated indices leaves the winner undefined, so
    # only each (slot, offset)'s newest lap may write (values and scales).
    # Skipped positions are more than R*bs > window older than the chunk's
    # last token — nothing downstream can attend them.
    last_valid = (starts + valids - 1)[:, None]                   # (G, 1)
    write = (ar[None, :] < valids[:, None]) & (pos > last_valid - R * bs)
    bids = _block_ids(kv, table_rows, pos, write, R)
    offs = (pos % bs).long()
    _scatter(kv, bids, offs, k, v, quantized)

    # 3) attend: keys = each segment's pre-chunk ring and its own chunk
    n_rep = h // hkv
    kk = _repeat_kv(torch.cat([old_k, k], dim=1), n_rep)
    vv = _repeat_kv(torch.cat([old_v, v], dim=1), n_rep)
    kpos = torch.cat([old_pos, pos.long()], dim=1)                # (G, R*bs+C)
    kok = torch.cat([old_ok, torch.ones((G, C), dtype=torch.bool,
                                        device=x.device)], dim=1)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    qp = pos.long()[:, :, None]
    mask = (kok[:, None, :] & (kpos[:, None, :] <= qp)
            & (kpos[:, None, :] > qp - window))                   # (G, C, K)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv).reshape(G, C, h * hd)
    return out @ params["wo"], kv
