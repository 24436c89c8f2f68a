"""ctypes binding of the hand-written CUDA blocked GEMM (``csrc/matmul.cu``,
the Hopper port of the TPU body ``matmul_kernel`` in
``repro/kernels/matmul/kernel.py``): ``matmul_cuda`` writes a @ b, summed in
f32, into an output of f32 or bf16.

The library is built with ``nvcc`` on first use (``kernels.build``), never
at import, so this module imports on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.matmul_f32acc
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P, P, P, L, L, L, I, I, P]
    fn.restype = I
    return lib


def matmul_cuda(a, b, out) -> None:
    """Launch on the current stream: a (M, K) and b (K, N) of one dtype, out
    (M, N), all contiguous. The caller has validated every argument
    (``ops``). Raises if the launch fails."""
    (M, K), N = a.shape, b.shape[1]
    rc = _library().matmul_f32acc(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[out.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matmul_f32acc launch failed: CUDA error {rc}")
