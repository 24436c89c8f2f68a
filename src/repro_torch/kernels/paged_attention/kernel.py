"""ctypes binding of the hand-written CUDA paged-decode kernel
(``csrc/paged_attention.cu``, the Hopper port of the TPU body
``repro/kernels/paged_attention/kernel.py:paged_kernel``).

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

# keys per thread block (split-K); a multiple of the kernel's 32-key tile
SPLIT_TOKENS = 256


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.paged_attention_decode
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float,
                   I, P]
    fn.restype = I
    return lib


def paged_attention_cuda(q, k_pool, v_pool, block_tables, seq_lens, out,
                         scale: float) -> None:
    """Launch the kernel pair (split-K pass + merge) on the current stream;
    the caller has validated every argument (``ops.paged_attention``).
    The f32 workspace for the splits' partial (m, l, acc) is allocated
    here, on PyTorch's caching allocator. Raises if a launch fails."""
    B, H, hd = q.shape
    _, bs, Hkv, _ = k_pool.shape
    P = block_tables.shape[1]
    n_splits = -(-P * bs // SPLIT_TOKENS)
    workspace = torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32,
                            device=q.device)
    rc = _library().paged_attention_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        workspace.data_ptr(), B, H, Hkv, hd, bs, P, SPLIT_TOKENS,
        float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode launch failed: CUDA error "
                           f"{rc}")
