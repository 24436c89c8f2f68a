"""ctypes binding of the hand-written CUDA paged-attention kernels
(``csrc/paged_attention.cu``, the Hopper ports of the TPU bodies in
``repro/kernels/paged_attention/kernel.py``): ``paged_attention_decode``
replaces ``paged_kernel`` (full-mode decode), and ``paged_attention_multi``
replaces ``paged_ring_kernel``, ``paged_verify_kernel`` and
``paged_ring_verify_kernel`` (ring decode, verify, ring verify). Both take
int8 pools with their f32 scale pools, dequantized inside the kernel (the
TPU helper ``_load_kv``'s ``quant=True`` path).

The library is built with ``nvcc`` on first use (``kernels.build``), never
at import, so this module imports on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# keys per thread block (split-K); a multiple of the kernels' 32-key tile
SPLIT_TOKENS = 256
# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.paged_attention_decode
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                   ctypes.c_float, I, P]
    fn.restype = I
    multi = lib.paged_attention_multi
    multi.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                      I, ctypes.c_float, I, P]
    multi.restype = I
    return lib


def tile_dtype(pool_dtype):
    """Element type of the kernels' shared-memory K/V tiles: the pool's own,
    f32 for an int8 pool (dequantized at load)."""
    return torch.float32 if pool_dtype == torch.int8 else pool_dtype


def multi_smem_bytes(dtype, hd: int, rows: int) -> int:
    """Shared memory of the ring/verify kernel's block (``multi_smem_bytes``
    in the source) for K/V tiles of `dtype` (``tile_dtype``): two 32-key
    tiles with padded rows, and per query row its f32 q, acc, m and l, plus
    the tile's 32 key positions."""
    item = torch.empty((), dtype=dtype).element_size()
    pad = 2 if item == 2 else 1
    return 2 * item * 32 * (hd + pad) + 4 * (2 * rows * hd + 2 * rows) + 4 * 32


def _ptr(t):
    return None if t is None else t.data_ptr()


def paged_attention_cuda(q, k_pool, v_pool, block_tables, seq_lens, out,
                         scale: float, k_scale=None, v_scale=None) -> None:
    """Launch the kernel pair (split-K pass + merge) on the current stream;
    the caller has validated every argument (``ops.paged_attention``).
    k_scale/v_scale (both or neither) mark int8 pools.
    The f32 workspace for the splits' partial (m, l, acc) is allocated
    here, on PyTorch's caching allocator. Raises if a launch fails."""
    B, H, hd = q.shape
    _, bs, Hkv, _ = k_pool.shape
    P = block_tables.shape[1]
    n_splits = -(-P * bs // SPLIT_TOKENS)
    workspace = torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32,
                            device=q.device)
    rc = _library().paged_attention_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), workspace.data_ptr(), B, H, Hkv, hd, bs, P,
        SPLIT_TOKENS,
        float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode launch failed: CUDA error "
                           f"{rc}")


def paged_attention_multi_cuda(q, k_pool, v_pool, block_tables, seq_lens,
                               positions, out, scale: float, window: int,
                               ring_pages: int, k_scale=None,
                               v_scale=None) -> None:
    """Launch the ring / verify kernel pair on the current stream. q and
    out are (B, n_q, H, hd); ``ring_pages == 0`` selects full mode, where
    `positions` is not read; k_scale/v_scale (both or neither) mark int8
    pools. The caller has validated every argument (``ops``). Raises if a
    launch fails."""
    B, n_q, H, hd = q.shape
    _, bs, Hkv, _ = k_pool.shape
    P = block_tables.shape[1]
    n_splits = -(-(ring_pages or P) * bs // SPLIT_TOKENS)
    workspace = torch.empty(B * n_q * H * n_splits * (hd + 2),
                            dtype=torch.float32, device=q.device)
    rc = _library().paged_attention_multi(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), seq_lens.data_ptr(),
        positions.data_ptr(), out.data_ptr(), workspace.data_ptr(), B, n_q,
        H, Hkv, hd, bs, P,
        ring_pages, window, SPLIT_TOKENS, float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_multi launch failed: CUDA error "
                           f"{rc}")
