"""ctypes binding of the hand-written CUDA paged-attention kernels
(``csrc/paged_attention.cu``, the Hopper ports of the TPU bodies in
``repro/kernels/paged_attention/kernel.py``): with a bf16 query,
``paged_decode_bf16`` replaces all four on the tensor cores —
``paged_kernel`` and ``paged_ring_kernel`` (one-query decode, full and ring
mode), ``paged_verify_kernel`` and ``paged_ring_verify_kernel`` (K-query
verify, full and ring mode); with an f32 query ``paged_attention_decode``
replaces ``paged_kernel`` and ``paged_attention_multi`` the other three on
the CUDA cores. All take int8 pools with their f32 scale pools, read inside
the kernel (the TPU helper ``_load_kv``'s ``quant=True`` path).

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

# keys per thread block (split-K) of the f32-query kernels; a multiple of
# their 32-key tile
SPLIT_TOKENS = 256
# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

# The bf16 decode and verify kernel (paged_decode_tc; the source's kDec*
# constants):
# keys per cp.async stage (16 a warp, 4 warps), stages in the ring, query
# rows per block (one mma tile), the most keys one block takes, and the
# widths it is instantiated at (another hd runs at the next one).
DECODE_STAGE_KEYS = 64
DECODE_STAGES = 3
DECODE_ROWS = 16
DECODE_MAX_SPLIT = 2048
DECODE_WIDTHS = (64, 80, 128, 256)
# the blocks the split choice aims for, in waves of the card's SMs: two,
# since a block's fixed costs (the table's round trip, the merge of its
# partial) outweigh a deeper fill of the card; splits of 64 to 1024 keys
# timed on an H100 at the smoke's decode shapes were fastest at 256 and
# 512 and slower between them, so a split is a power-of-two number of
# stages
DECODE_WAVES = 2


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
    dec = lib.paged_decode_bf16
    dec.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                    I, ctypes.c_float, P]
    dec.restype = I
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_width(hd: int) -> int:
    """The width the bf16 decode kernel runs head dim `hd` at."""
    return next(w for w in DECODE_WIDTHS if w >= hd)


def decode_smem_bytes(pool_dtype, hd: int, split_tokens: int, *,
                      ring_verify: bool = False) -> int:
    """Shared memory of a bf16 decode or verify block (``dec_smem_bytes``
    in the source): the K/V stages (int8 pools stay int8; rows padded to an
    odd multiple of 16 bytes), Q's 16-row tile, the stages' scales and the
    split's slot map; a ring verify also each key's position."""
    w = decode_width(hd)
    if pool_dtype == torch.int8:
        row = w + 16 if (w // 16) % 2 == 0 else w + 32
    else:
        row = 2 * w + 16
    return (DECODE_STAGES * 2 * DECODE_STAGE_KEYS * row
            + DECODE_ROWS * (w + 8) * 2
            + 2 * DECODE_STAGES * DECODE_STAGE_KEYS * 4
            + split_tokens * 4 * (2 if ring_verify else 1))


def decode_split_tokens(B: int, Hkv: int, rows: int, span: int,
                        sm_count: int) -> int:
    """Keys per block of the bf16 decode and verify kernel: the span (P·bs,
    or R·bs in ring mode) cut so that all blocks, B · Hkv · row tiles ·
    splits, make about DECODE_WAVES waves on `sm_count` SMs if every key
    were live; `rows` is a kv head's query rows, n_q · groups, in tiles of
    DECODE_ROWS. A power-of-two number of stages, at most DECODE_MAX_SPLIT.
    Reads nothing on the device (seq_lens stays there)."""
    blocks = B * Hkv * -(-rows // DECODE_ROWS)
    splits = max(1, -(-DECODE_WAVES * sm_count // blocks))
    stages = -(-span // (splits * DECODE_STAGE_KEYS))
    split = DECODE_STAGE_KEYS << max(0, stages - 1).bit_length()
    return min(split, DECODE_MAX_SPLIT)


def decode_workspace_floats(B: int, H: int, hd: int, span: int,
                            split_tokens: int, n_q: int = 1) -> int:
    """f32 partials (m, l, acc) of every output row (b, query, head) and
    split."""
    return B * n_q * H * -(-span // split_tokens) * (hd + 2)


def tile_dtype(pool_dtype):
    """Element type of the kernels' shared-memory K/V tiles: the pool's own,
    f32 for an int8 pool (dequantized at load)."""
    return torch.float32 if pool_dtype == torch.int8 else pool_dtype


def multi_smem_bytes(dtype, hd: int, rows: int) -> int:
    """Shared memory of the f32 ring/verify kernel's block
    (``multi_smem_bytes`` in the source) for K/V tiles of `dtype`
    (``tile_dtype``): two 32-key tiles with padded rows, and per query row
    its f32 q, acc, m and l, plus the tile's 32 key positions."""
    item = torch.empty((), dtype=dtype).element_size()
    pad = 2 if item == 2 else 1
    return 2 * item * 32 * (hd + pad) + 4 * (2 * rows * hd + 2 * rows) + 4 * 32


def _ptr(t):
    return None if t is None else t.data_ptr()


def paged_decode_cuda(q, k_pool, v_pool, block_tables, seq_lens, positions,
                      out, scale: float, window: int, ring_pages: int,
                      k_scale=None, v_scale=None) -> None:
    """Launch the bf16 decode / verify pair (tensor-core split pass + merge)
    on the current stream: q and out (B, H, hd) for a one-query decode or
    (B, n_q, H, hd) for a verify, bf16; ``ring_pages == 0`` selects full
    mode, where `positions` is not read; k_scale/v_scale (both or neither)
    mark int8 pools. The caller has validated every argument (``ops``).
    Raises if a launch fails."""
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    n_q = q.shape[1] if q.dim() == 4 else 1
    _, bs, Hkv, _ = k_pool.shape
    span = (ring_pages or block_tables.shape[1]) * bs
    split = decode_split_tokens(B, Hkv, n_q * (H // Hkv), span,
                                _sm_count(q.device.index or 0))
    workspace = torch.empty(
        decode_workspace_floats(B, H, hd, span, split, n_q),
        dtype=torch.float32, device=q.device)
    rc = _library().paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), seq_lens.data_ptr(),
        positions.data_ptr(), out.data_ptr(), workspace.data_ptr(), B, n_q, H,
        Hkv, hd, bs, block_tables.shape[1], ring_pages, window, split,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_bf16 launch failed: CUDA error "
                           f"{rc}")


def paged_attention_cuda(q, k_pool, v_pool, block_tables, seq_lens, out,
                         scale: float, k_scale=None, v_scale=None) -> None:
    """Launch the f32 kernel pair (split-K pass + merge) on the current
    stream; the caller has validated every argument
    (``ops.paged_attention``). k_scale/v_scale (both or neither) mark int8
    pools.
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
    """Launch the f32 ring / verify kernel pair on the current stream. q and
    out are (B, n_q, H, hd) f32; ``ring_pages == 0`` selects full mode, where
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
