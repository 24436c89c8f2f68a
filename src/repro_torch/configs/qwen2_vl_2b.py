"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191]

Transformer backbone only; the ViT vision encoder + projector is a stub:
`input_specs()` supplies precomputed patch embeddings (B, S, D) and 3-D
M-RoPE position ids (3, B, S).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    rope_mode="mrope",
    frontend="vision_stub",
    tie_embeddings=True,
))
