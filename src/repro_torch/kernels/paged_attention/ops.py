"""Paged decode attention, dispatched by device.

A CPU tensor takes the plain version (``ref.paged_attention_ref``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k_pool, v_pool, block_tables, seq_lens):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"want q (B, H, hd) and pools (N, bs, Hkv, hd), got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, H, hd = q.shape
    N, bs, Hkv, hd_k = k_pool.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {Hkv}")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"head_dim {hd} unsupported: the kernel takes "
                         f"multiples of 8 up to 256")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} != (B={B}, P)")
    if tuple(seq_lens.shape) != (B,):
        raise ValueError(f"seq_lens {tuple(seq_lens.shape)} != ({B},)")
    if q.dtype not in SUPPORTED_DTYPES or not (
            q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}: want one of {SUPPORTED_DTYPES}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    tensors = (q, k_pool, v_pool, block_tables, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must start on a 16-byte boundary (the kernel "
                         "loads K/V rows in 16-byte vectors)")


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *, scale=None):
    """q: (B, H, hd); k_pool/v_pool: (N, block_size, Hkv, hd); block_tables:
    (B, P) int32; seq_lens: (B,) int32 — valid tokens per sequence including
    the current one (0 marks an inactive slot, whose row is zeros).
    Returns (B, H, hd) in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k_pool, v_pool, block_tables, seq_lens)
    out = torch.empty_like(q)
    paged_attention_cuda(q, k_pool, v_pool, block_tables, seq_lens, out, scale)
    kernels.launch_counts["paged_attention"] += 1
    return out
