"""Per-vector int8 quantization of paged K/V (the port's copy of
``KVQuantConfig``, ``quantize_kv`` and ``dequantize_kv`` from
``repro.kernels.quantize.ops``), in plain PyTorch.

The KV path quantizes on write with these plain functions, as the reference
does; the dequant side runs inside the hand-written paged-attention kernels
(``kernels/paged_attention``). The reference's two Pallas quantizers over
256-value rows, ``quantize_nearest_kernel`` and ``quantize_kernel`` (used by
``core/compression.py``, not by the KV path), are not ported yet.
"""
from repro_torch.kernels.quantize.ops import (KVQuantConfig, dequantize_kv,
                                              quantize_kv)

__all__ = ["KVQuantConfig", "dequantize_kv", "quantize_kv"]
