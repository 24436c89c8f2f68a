"""Block quantizers: the flat-gradient quantizer over 256-value rows
(``quantize_blocks``: kernel B9 in stochastic mode, B8 in nearest mode, on
the card; ``core/compression.quantize_int`` routes every int8/int4/QSGD
compression through it) and the per-vector int8 quantization of paged K/V
(``quantize_kv``, plain PyTorch on the KV write path, dequantized inside the
paged-attention kernels).

The reference's ``core/compression.py`` calls no kernel: its
``quantize_int`` computes B9's function in jnp. The port routes it to B9.
"""
from repro_torch.kernels.quantize.ops import (KVQuantConfig,
                                              dequantize_blocks,
                                              dequantize_kv, quantize_blocks,
                                              quantize_kv)
from repro_torch.kernels.quantize.ref import quantize_blocks_ref

__all__ = ["KVQuantConfig", "dequantize_blocks", "dequantize_kv",
           "quantize_blocks", "quantize_blocks_ref", "quantize_kv"]
