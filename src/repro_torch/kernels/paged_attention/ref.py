"""Plain PyTorch versions of paged attention: one-query decode and the
K-query speculative verify, each in full and ring (sliding-window) mode.

One query token per sequence attends over KV stored in a block pool via a
per-sequence block table, as ``repro.kernels.paged_attention.ref`` defines:

  * ``seq_lens[b]`` counts the valid tokens of sequence ``b`` INCLUDING the
    current one (the caller writes its K/V into the pool first).
  * ``seq_lens[b] == 0`` marks an inactive slot: the output row is zeros.
  * Table entries past the sequence's last page may point anywhere inside
    the pool; their contents are masked out.

Ring mode (``window`` + ``positions`` + ``ring_pages`` set): the sequence
owns only ``ring_pages`` blocks and the token at absolute position p was
written at ``table[(p // bs) % ring_pages]``, offset ``p % bs``. Ring slot r
currently holds absolute page ``q_cur - ((q_cur % R - r) % R)`` with
``q_cur = position // bs`` (torch's ``//`` and ``%`` on tensors floor, as
Python's do), and the query attends exactly ``(position - window,
position]``. Offsets past ``position % bs`` in the current page still hold
the previous lap's keys; their reconstructed positions exceed ``position``,
so the causal bound masks them.

These are what ``ops`` runs for CPU tensors, and what the CUDA kernels are
held against on the card.
"""
import torch

NEG_INF = -1e30


def _masked_gqa_attend(q, k, v, valid, scale):
    """q: (B, H, hd); k/v: (B, K, Hkv, hd); valid: (B, K) bool mask.
    Max-subtracted softmax with a guarded denominator so fully-masked rows
    (inactive slots) produce zeros instead of NaN. Returns (B, H, hd)."""
    B, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * scale
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2))
    p = torch.where(mask, p, 0.0)
    denom = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p / denom, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def _masked_gqa_attend_multi(q, k, v, valid, scale):
    """Multi-query variant: q: (B, K, H, hd); k/v: (B, Kk, Hkv, hd);
    valid: (B, K, Kk) bool, one key mask per query row. Each row runs the
    elementwise ops of :func:`_masked_gqa_attend`. Returns (B, K, H, hd)."""
    B, K, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, K, Hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float()) * scale
    mask = valid[:, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2))
    p = torch.where(mask, p, 0.0)
    denom = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p / denom, v.float())
    return out.reshape(B, K, H, hd).to(q.dtype)


def _gather_pool(pool, tables, T, scl=None):
    """Gather pool blocks through a block table into (B, T, Hkv, hd) f32.
    When ``scl`` (N, bs, Hkv) is given the pool is int8 and each vector is
    dequantized with the same per-(slot, head) f32 multiply as the kernels'
    tile load — so ref-with-scales equals the ref run on the pool
    dequantized beforehand, bit for bit."""
    B = tables.shape[0]
    Hkv, hd = pool.shape[2], pool.shape[3]
    x = pool[tables].float()                            # (B, P, bs, Hkv, hd)
    if scl is not None:
        x = x * scl[tables][..., None]
    return x.reshape(B, T, Hkv, hd)


def ring_key_positions(positions, ring_pages, block_size):
    """Absolute position of every (ring slot, offset) pair, per sequence.
    positions: (B,) current absolute position. Returns (B, R*bs); entries
    may be negative (page not yet written) or > positions (stale
    previous-lap offsets) — callers mask both."""
    R, bs = ring_pages, block_size
    dev = positions.device
    q_cur = positions.long() // bs                                # (B,)
    r_cur = q_cur % R
    page = q_cur[:, None] - ((r_cur[:, None]
                              - torch.arange(R, device=dev)[None, :]) % R)
    kpos = page[:, :, None] * bs + torch.arange(bs, device=dev)[None, None, :]
    return kpos.reshape(positions.shape[0], R * bs)


def _ring_gather(k_pool, v_pool, block_tables, ring_pages, k_scale=None,
                 v_scale=None):
    bs = k_pool.shape[1]
    tables = block_tables[:, :ring_pages]
    return (_gather_pool(k_pool, tables, ring_pages * bs, k_scale),
            _gather_pool(v_pool, tables, ring_pages * bs, v_scale))


def _check_ring_args(positions, ring_pages):
    if positions is None or ring_pages is None:
        raise ValueError("ring mode needs window, positions AND ring_pages")


def check_scales(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")


def paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens, *,
                        scale=None, window=None, positions=None,
                        ring_pages=None, k_scale=None, v_scale=None):
    """q: (B, H, hd); k_pool/v_pool: (N, bs, Hkv, hd);
    block_tables: (B, P) int32; seq_lens: (B,) int32. Returns (B, H, hd).

    window/positions/ring_pages switch on ring mode (all three required):
    attend the sliding window (positions - window, positions] through the
    ring block layout. k_scale/v_scale (both or neither): int8 pools with
    per-(slot, head) f32 dequant scales (N, bs, Hkv)."""
    hd = q.shape[-1]
    bs = k_pool.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    check_scales(k_scale, v_scale)
    if window is None:
        P = block_tables.shape[1]
        k = _gather_pool(k_pool, block_tables, P * bs, k_scale)
        v = _gather_pool(v_pool, block_tables, P * bs, v_scale)
        valid = (torch.arange(P * bs, device=q.device)[None, :]
                 < seq_lens[:, None])
        return _masked_gqa_attend(q, k, v, valid, scale)

    _check_ring_args(positions, ring_pages)
    k, v = _ring_gather(k_pool, v_pool, block_tables, ring_pages, k_scale,
                        v_scale)
    kpos = ring_key_positions(positions, ring_pages, bs)          # (B, R*bs)
    pos = positions.long()[:, None]
    valid = ((kpos >= 0) & (kpos <= pos) & (kpos > pos - window)
             & (seq_lens[:, None] > 0))
    return _masked_gqa_attend(q, k, v, valid, scale)


def paged_attention_verify_ref(q, k_pool, v_pool, block_tables, seq_lens, *,
                               scale=None, window=None, positions=None,
                               ring_pages=None, k_scale=None, v_scale=None):
    """Multi-query verify for speculative decoding.

    q: (B, K, H, hd) — K draft queries per sequence. ``seq_lens[b]`` counts
    valid tokens INCLUDING all K draft tokens (their K/V already written),
    so query j of sequence b sits at absolute position ``seq_lens[b] - K +
    j`` and attends keys causally up to and including itself.
    ``seq_lens[b] == 0`` marks an inactive slot (zero output).

    Ring mode (window/positions/ring_pages set): ``positions[b]`` is the
    NEWEST draft position ``seq_lens[b] - 1``; each query attends its own
    sliding window ``(qpos - window, qpos]`` through the ring layout. The
    caller sizes the ring so that the oldest query's window is still
    resident (``ring_pages(window, bs, draft=K-1)``). k_scale/v_scale as
    in :func:`paged_attention_ref`. Returns (B, K, H, hd)."""
    K, hd = q.shape[1], q.shape[-1]
    bs = k_pool.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    check_scales(k_scale, v_scale)
    dev = q.device
    qpos = (seq_lens.long()[:, None] - K
            + torch.arange(K, device=dev)[None, :])                # (B, K)
    if window is None:
        P = block_tables.shape[1]
        k = _gather_pool(k_pool, block_tables, P * bs, k_scale)
        v = _gather_pool(v_pool, block_tables, P * bs, v_scale)
        kpos = torch.arange(P * bs, device=dev)
        valid = kpos[None, None, :] <= qpos[:, :, None]           # (B, K, P*bs)
        return _masked_gqa_attend_multi(q, k, v, valid, scale)

    _check_ring_args(positions, ring_pages)
    k, v = _ring_gather(k_pool, v_pool, block_tables, ring_pages, k_scale,
                        v_scale)
    kpos = ring_key_positions(positions, ring_pages, bs)[:, None, :]
    valid = ((kpos >= 0) & (kpos <= qpos[:, :, None])
             & (kpos > qpos[:, :, None] - window)
             & (seq_lens[:, None, None] > 0))
    return _masked_gqa_attend_multi(q, k, v, valid, scale)
