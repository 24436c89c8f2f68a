"""int8 K/V quantization with one f32 scale per stored vector."""
from __future__ import annotations

import dataclasses

import torch


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
    stores identical values for the same input vector."""
    maxq = float(2 ** (bits - 1) - 1)
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.where(amax == 0.0, 1.0, amax / maxq)
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -maxq - 1, maxq).to(torch.int8), scale


def dequantize_kv(q, scale):
    """Inverse of quantize_kv (up to rounding): (..., hd) int8 × (...,) f32
    → f32."""
    return q.float() * scale[..., None]
