"""The blocked GEMM, dispatched by device.

``matmul`` takes the plain version (``ref``) for a CPU tensor and launches
the hand-written kernel for a CUDA tensor, or raises — there is no
fallback. Launches count under ``repro_torch.kernels.launch_counts
["matmul"]``. The TPU wrapper's ``block_m/block_n/block_k`` (VMEM tiling)
and ``interpret`` are dropped: the kernel picks its own tiles and masks
ragged edges, so no dim has to divide a block.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.matmul.kernel import matmul_cuda
from repro_torch.kernels.matmul.ref import matmul_ref

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _check(a, b, out_dtype):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"want a (M, K) and b (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if a.dtype not in SUPPORTED_DTYPES or a.dtype != b.dtype:
        raise TypeError(f"a/b dtypes {a.dtype}/{b.dtype}: want one of "
                        f"{SUPPORTED_DTYPES}")
    if out_dtype is not None and out_dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"out_dtype {out_dtype}: want one of "
                        f"{SUPPORTED_DTYPES}")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")


def _kernel(a, b, out_dtype):
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype or a.dtype,
                      device=a.device)
    matmul_cuda(a, b, out)
    kernels.launch_counts["matmul"] += 1
    return out


def matmul(a, b, *, out_dtype=None):
    """a (M, K) @ b (K, N) -> (M, N), summed in f32 and cast to `out_dtype`
    (default a's dtype). a and b share one dtype, f32 or bf16; f32 stays
    IEEE f32 on the card (no TF32). Any M, N and K."""
    _check(a, b, out_dtype)
    if a.is_cuda:
        return _kernel(a, b, out_dtype)
    return matmul_ref(a, b, out_dtype)
