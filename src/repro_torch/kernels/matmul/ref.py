"""Plain PyTorch version of the blocked GEMM (the counterpart of
``repro.kernels.matmul.ref.matmul_ref``)."""
import torch


def matmul_ref(a, b, out_dtype=None):
    """a (M, K) @ b (K, N), summed in f32 (``preferred_element_type=f32``)
    and cast to `out_dtype` (default a's dtype)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)
