"""musicgen-medium [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284]

Transformer backbone only; the EnCodec conv codec is a stub: `input_specs()`
supplies precomputed frame embeddings (sum of the 4 codebook embeddings).
vocab=2048 per codebook; the delay interleave pattern is out of scope.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio_stub",
    num_codebooks=4,
))
