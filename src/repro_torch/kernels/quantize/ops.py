"""Flat gradient <-> (int8 rows, scales), dispatched by device, plus the
int8 K/V quantization of the paged serving pools (plain PyTorch).

``quantize_blocks`` takes the plain version (``ref``) for a CPU tensor and
launches the hand-written kernel for a CUDA tensor, or raises — there is no
fallback: B9 (``mode="stochastic"``) counts under
``repro_torch.kernels.launch_counts["quantize_stochastic"]``, B8
(``mode="nearest"``) under ``["quantize_nearest"]``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels.quantize.kernel import ROW, quantize_rows_cuda
from repro_torch.kernels.quantize.ref import quantize_blocks_ref

MODES = ("stochastic", "nearest")


def _plain(flat, noise, bits, block, mode):
    x = F.pad(flat.float(), (0, (-flat.numel()) % block)).reshape(-1, block)
    return quantize_blocks_ref(x, noise, bits=bits, mode=mode)


def _kernel(flat, noise, bits, block, mode):
    if block != ROW:
        raise ValueError(f"block {block}: the kernel is built for {ROW}-value "
                         f"rows")
    x = flat.float().contiguous()
    rows = -(-x.numel() // block)
    if noise is not None:
        noise = noise.float().contiguous()
        if noise.device != x.device:
            raise ValueError("noise must lie on the input's device")
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if any(t is not None and t.data_ptr() % 16 for t in (x, noise)):
        raise ValueError("the input and noise must start on a 16-byte "
                         "boundary (the kernel loads them in 16-byte vectors)")
    quantize_rows_cuda(x, noise if mode == "stochastic" else None, q, scales,
                       2 ** (bits - 1) - 1)
    kernels.launch_counts["quantize_" + mode] += 1
    return q, scales


def quantize_blocks(flat, noise=None, *, bits=8, block=256,
                    mode="stochastic"):
    """flat: (n,) gradient (any float type, quantized in f32). Returns (q
    (rows, block) int8, scales (rows,) f32), rows = ceil(n / block); the
    rows past n quantize as zeros, as the reference's padding does.
    ``mode="stochastic"`` (B9) needs `noise`, uniform [0, 1) of shape (rows,
    block), and keeps E[dequant(quant(g))] = g; ``"nearest"`` (B8) rounds
    half to even and takes no noise."""
    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {mode!r}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits {bits}: int8 storage holds 2 to 8 bits")
    flat = flat.reshape(-1)
    if mode == "stochastic":
        rows = -(-flat.numel() // block)
        if noise is None:
            raise ValueError("stochastic mode needs a noise operand")
        if tuple(noise.shape) != (rows, block):
            raise ValueError(f"noise {tuple(noise.shape)} != (rows, block) = "
                             f"{(rows, block)}")
    if flat.is_cuda:
        return _kernel(flat, noise, bits, block, mode)
    return _plain(flat, noise, bits, block, mode)


def dequantize_blocks(q, scales, n=None):
    """(rows, block) int8 x (rows,) f32 -> flat f32, cut to n values."""
    flat = (q.float() * scales[:, None]).reshape(-1)
    return flat if n is None else flat[:n]


@dataclasses.dataclass(frozen=True)
class KVQuantConfig:
    """Paged-KV pool quantization: int8 values + one f32 scale per
    (block-slot, kv-head) vector over head_dim. Frozen, so it can live in
    the frozen engine and provider configs."""
    bits: int = 8

    def __post_init__(self):
        if self.bits != 8:
            raise ValueError(
                f"only int8 KV quantization supported, got bits={self.bits}")


def quantize_kv(x, *, bits: int = 8):
    """x: (..., hd) K or V vectors. Returns (q int8 of x's shape, scale f32
    (...,)): scale = amax / 127 (1.0 on an all-zero vector), values rounded
    half to even (``torch.round``, like ``jnp.round``), so every write path
    stores identical values for the same input vector. The scale divides
    by a tensor, not a Python number, which PyTorch's CUDA division would
    turn into a multiply by its reciprocal (one ulp off amax / 127 on about
    1 vector in 16)."""
    maxq = float(2 ** (bits - 1) - 1)
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    div = torch.full((), maxq, dtype=torch.float32, device=xf.device)
    scale = torch.where(amax == 0.0, 1.0, amax / div)
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -maxq - 1, maxq).to(torch.int8), scale


def dequantize_kv(q, scale):
    """Inverse of quantize_kv (up to rounding): (..., hd) int8 × (...,) f32
    → f32."""
    return q.float() * scale[..., None]
