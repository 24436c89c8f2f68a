"""ctypes binding of the hand-written CUDA block quantizers
(``csrc/quantize.cu``, the Hopper ports of the TPU bodies
``quantize_nearest_kernel`` (B8) and ``quantize_kernel`` (B9) in
``repro/kernels/quantize/kernel.py``): ``quantize_rows_cuda`` writes the int8
rows and their f32 scales.

The library is built with ``nvcc`` on first use (``kernels.build``), never
at import, so this module imports on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize.cu"

# values per row (one scale each): the source's kBlock
ROW = 256


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.quantize_rows
    P, L = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [P, P, P, P, L, L, ctypes.c_float, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return lib


def quantize_rows_cuda(x, noise, q, scales, maxq: float) -> None:
    """Launch on the current stream: x (n,) f32; noise (rows, ROW) f32 or
    None (round half to even); q (rows, ROW) int8 and scales (rows,) f32
    written. The caller has validated every argument (``ops``). Raises if
    the launch fails."""
    rows = q.shape[0]
    rc = _library().quantize_rows(
        x.data_ptr(), None if noise is None else noise.data_ptr(),
        q.data_ptr(), scales.data_ptr(), x.numel(), rows, float(maxq),
        int(noise is not None),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_rows launch failed: CUDA error {rc}")
