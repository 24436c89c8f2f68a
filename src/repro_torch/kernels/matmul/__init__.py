"""Blocked GEMM: ``matmul`` (kernel B7 on the card, its plain version on
the CPU) and ``matmul_ref``. The survey's im2col convolution
(``models/conv.conv_im2col``) computes its GEMM with it."""
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref

__all__ = ["matmul", "matmul_ref"]
