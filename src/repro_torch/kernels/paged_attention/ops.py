"""Paged attention — one-query decode and K-query verify, each in full and
ring mode — dispatched by device.

A CPU tensor takes the plain version (``ref``); a CUDA tensor launches the
hand-written kernel or raises — there is no fallback. A bf16 query, in
one-query decode or K-query verify, full or ring mode, launches the
tensor-core kernel (``kernel.paged_decode_cuda``); an f32 query launches
the CUDA-core kernels. Each mode counts its
launches under its own key of ``repro_torch.kernels.launch_counts``:
``paged_attention`` (full decode), ``paged_ring`` (ring decode),
``paged_verify`` and ``paged_ring_verify``; with int8 pools (``k_scale`` /
``v_scale`` given) the same mode's key with an ``_int8`` suffix.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.paged_attention.kernel import (
    MAX_SMEM_BYTES, multi_smem_bytes, paged_attention_cuda,
    paged_attention_multi_cuda, paged_decode_cuda, tile_dtype)
from repro_torch.kernels.paged_attention.ref import (check_scales,
                                                     paged_attention_ref,
                                                     paged_attention_verify_ref)

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k_pool, v_pool, block_tables, seq_lens, k_scale=None,
           v_scale=None):
    """q (B, H, hd) for decode or (B, K, H, hd) for verify; pools of q's
    dtype, or int8 with contiguous f32 scales (N, bs, Hkv) for each."""
    if q.dim() not in (3, 4) or k_pool.dim() != 4:
        raise ValueError(f"want q (B, H, hd) or (B, K, H, hd) and pools "
                         f"(N, bs, Hkv, hd), got {tuple(q.shape)} and "
                         f"{tuple(k_pool.shape)}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
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
    check_scales(k_scale, v_scale)
    quant = k_scale is not None
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in SUPPORTED_DTYPES or not (
            pool_dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}: want q in {SUPPORTED_DTYPES} and "
                        f"pools of q's dtype, or int8 pools with scales")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    tensors = (q, k_pool, v_pool, block_tables, seq_lens)
    if quant:
        for s in (k_scale, v_scale):
            if tuple(s.shape) != (N, bs, Hkv) or s.dtype != torch.float32:
                raise ValueError(f"scales must be f32 {(N, bs, Hkv)}, got "
                                 f"{s.dtype} {tuple(s.shape)}")
        tensors += (k_scale, v_scale)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must start on a 16-byte boundary (the kernel "
                         "loads K/V rows in 16- or 8-byte vectors)")


def _check_ring(q, block_tables, window, positions, ring_pages):
    """Ring arguments (ring_pages None: full mode, nothing to check)."""
    if ring_pages is None:
        return
    B = q.shape[0]
    if not 1 <= ring_pages <= block_tables.shape[1]:
        raise ValueError(f"ring_pages {ring_pages} outside [1, table "
                         f"width {block_tables.shape[1]}]")
    if window < 1:
        raise ValueError(f"window {window} must be positive")
    if (tuple(positions.shape) != (B,) or positions.dtype != torch.int32
            or positions.device != q.device or not positions.is_contiguous()):
        raise ValueError(f"positions must be contiguous int32 ({B},) on "
                         f"{q.device}")


def _check_multi(q, k_pool, block_tables, window, positions, ring_pages):
    """Ring arguments and the ring/verify kernel's shared-memory need."""
    _check_ring(q, block_tables, window, positions, ring_pages)
    B, n_q, H, hd = q.shape
    rows = n_q * (H // k_pool.shape[2])
    smem = multi_smem_bytes(tile_dtype(k_pool.dtype), hd, rows)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{n_q} queries x {H // k_pool.shape[2]} heads per kv head at "
            f"head_dim {hd} ({k_pool.dtype} pools) need {smem} B of shared "
            f"memory per "
            f"block, over the {MAX_SMEM_BYTES} B a Hopper block may use")


def _ring_mode(window, positions, ring_pages):
    ring = window is not None or positions is not None or ring_pages is not None
    if ring and (window is None or positions is None or ring_pages is None):
        raise ValueError("ring mode needs window, positions AND ring_pages")
    return ring


def _key(mode, k_scale):
    return mode if k_scale is None else mode + "_int8"


def _launch_multi(q, k_pool, v_pool, block_tables, seq_lens, scale, window,
                  positions, ring_pages, k_scale, v_scale, mode):
    """f32 q (B, n_q, H, hd) on CUDA: validate, launch the CUDA-core kernel,
    count under `mode`'s key."""
    _check(q, k_pool, v_pool, block_tables, seq_lens, k_scale, v_scale)
    _check_multi(q, k_pool, block_tables, window, positions, ring_pages)
    out = torch.empty_like(q)
    paged_attention_multi_cuda(
        q, k_pool, v_pool, block_tables, seq_lens,
        seq_lens if positions is None else positions, out, scale,
        window or 0, ring_pages or 0, k_scale, v_scale)
    kernels.launch_counts[_key(mode, k_scale)] += 1
    return out


def _launch_tc(q, k_pool, v_pool, block_tables, seq_lens, scale, window,
               positions, ring_pages, k_scale, v_scale, mode):
    """bf16 q (B, H, hd) or (B, n_q, H, hd) on CUDA: validate, launch the
    tensor-core kernel, count under `mode`'s key."""
    _check(q, k_pool, v_pool, block_tables, seq_lens, k_scale, v_scale)
    _check_ring(q, block_tables, window, positions, ring_pages)
    out = torch.empty_like(q)
    ring = ring_pages is not None
    paged_decode_cuda(q, k_pool, v_pool, block_tables, seq_lens,
                      positions if ring else seq_lens, out, scale,
                      window or 0, ring_pages or 0, k_scale, v_scale)
    kernels.launch_counts[_key(mode, k_scale)] += 1
    return out


def _device_of(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return q.device.type


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *, scale=None,
                    window=None, positions=None, ring_pages=None,
                    k_scale=None, v_scale=None):
    """q: (B, H, hd); k_pool/v_pool: (N, block_size, Hkv, hd); block_tables:
    (B, P) int32; seq_lens: (B,) int32 — valid tokens per sequence including
    the current one (0 marks an inactive slot, whose row is zeros).
    window/positions/ring_pages (all three) select ring mode: attend
    (positions - window, positions] through a ring of `ring_pages` blocks;
    positions (B,) int32. k_scale/v_scale (both or neither): int8 pools with
    f32 scales (N, block_size, Hkv), dequantized inside the kernel. Returns
    (B, H, hd) in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ring = _ring_mode(window, positions, ring_pages)
    scales = dict(k_scale=k_scale, v_scale=v_scale)
    if _device_of(q, "paged_attention") == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens,
                                   scale=scale, window=window,
                                   positions=positions, ring_pages=ring_pages,
                                   **scales)
    if q.dim() != 3:
        raise ValueError(f"want q (B, H, hd), got {tuple(q.shape)}")
    mode = "paged_ring" if ring else "paged_attention"
    if q.dtype == torch.bfloat16:
        return _launch_tc(q, k_pool, v_pool, block_tables, seq_lens, scale,
                          window, positions, ring_pages, k_scale, v_scale,
                          mode)
    if ring:
        return _launch_multi(q[:, None], k_pool, v_pool, block_tables,
                             seq_lens, scale, window, positions, ring_pages,
                             k_scale, v_scale, mode)[:, 0]
    _check(q, k_pool, v_pool, block_tables, seq_lens, **scales)
    out = torch.empty_like(q)
    paged_attention_cuda(q, k_pool, v_pool, block_tables, seq_lens, out, scale,
                         **scales)
    kernels.launch_counts[_key(mode, k_scale)] += 1
    return out


def paged_attention_verify(q, k_pool, v_pool, block_tables, seq_lens, *,
                           scale=None, window=None, positions=None,
                           ring_pages=None, k_scale=None, v_scale=None):
    """Multi-query verify for speculative decoding. q: (B, K, H, hd) — K
    draft queries per sequence, all K/V already written. ``seq_lens``
    counts tokens INCLUDING the K drafts; query j attends causally up to
    position ``seq_lens - K + j`` (0 marks an inactive slot). Ring mode:
    ``positions = seq_lens - 1`` and the ring sized with ``draft = K - 1``
    slack. k_scale/v_scale as in :func:`paged_attention`. Returns (B, K, H,
    hd) in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ring = _ring_mode(window, positions, ring_pages)
    if _device_of(q, "paged_attention_verify") == "cpu":
        return paged_attention_verify_ref(
            q, k_pool, v_pool, block_tables, seq_lens, scale=scale,
            window=window, positions=positions, ring_pages=ring_pages,
            k_scale=k_scale, v_scale=v_scale)
    if q.dim() != 4:
        raise ValueError(f"want q (B, K, H, hd), got {tuple(q.shape)}")
    launch = _launch_tc if q.dtype == torch.bfloat16 else _launch_multi
    return launch(q, k_pool, v_pool, block_tables, seq_lens, scale, window,
                  positions, ring_pages, k_scale, v_scale,
                  "paged_ring_verify" if ring else "paged_verify")
