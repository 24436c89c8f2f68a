"""Plain PyTorch version of paged decode attention (full mode).

One query token per sequence attends over KV stored in a block pool via a
per-sequence block table, as ``repro.kernels.paged_attention.ref`` defines:

  * ``seq_lens[b]`` counts the valid tokens of sequence ``b`` INCLUDING the
    current one (the caller writes its K/V into the pool first).
  * ``seq_lens[b] == 0`` marks an inactive slot: the output row is zeros.
  * Table entries past the sequence's last page may point anywhere inside
    the pool; their contents are masked out.

This is what ``ops.paged_attention`` runs for CPU tensors, and what the
CUDA kernel is held against on the card.
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


def _gather_pool(pool, tables, T):
    """Gather pool blocks through a block table into (B, T, Hkv, hd) f32."""
    B = tables.shape[0]
    Hkv, hd = pool.shape[2], pool.shape[3]
    return pool[tables].float().reshape(B, T, Hkv, hd)


def paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens, *,
                        scale=None):
    """q: (B, H, hd); k_pool/v_pool: (N, bs, Hkv, hd);
    block_tables: (B, P) int32; seq_lens: (B,) int32. Returns (B, H, hd)."""
    hd = q.shape[-1]
    bs = k_pool.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    P = block_tables.shape[1]
    k = _gather_pool(k_pool, block_tables, P * bs)
    v = _gather_pool(v_pool, block_tables, P * bs)
    valid = (torch.arange(P * bs, device=q.device)[None, :]
             < seq_lens[:, None])
    return _masked_gqa_attend(q, k, v, valid, scale)
