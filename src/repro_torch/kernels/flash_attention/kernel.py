"""ctypes binding of the hand-written CUDA flash-attention forward kernels
(``csrc/flash_attention.cu``, the Hopper port of the TPU body ``flash_kernel``
in ``repro/kernels/flash_attention/kernel.py``): ``flash_attention_forward``
writes the attention output and the row log-sum-exp. bf16 runs on the tensor
cores (``mma.sync`` fed by ``cp.async``) at the widths of the source's
``kTcWidths``; f32 runs on the CUDA cores in a tile padded to the next
multiple of 64.

The library is built with ``nvcc`` on first use (``kernels.build``), never
at import, so this module imports on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# head dims the source takes: multiples of 8 up to 256, as the paged kernels
HEAD_DIMS = tuple(range(8, 257, 8))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.flash_attention_forward
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, I, I, I, P]
    fn.restype = I
    return lib


def flash_attention_cuda(q, k, v, out, lse, scale: float, causal: bool,
                         window) -> None:
    """Launch the forward kernel on the current stream: q, out (B, S, H,
    hd); k, v (B, S, Hkv, hd); lse (B, H, S) f32. The caller has validated
    every argument (``ops``). Raises if the launch fails."""
    B, S, H, hd = q.shape
    rc = _library().flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, k.shape[2], hd, float(scale), int(causal),
        int(window or 0), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_forward launch failed: CUDA "
                           f"error {rc}")
