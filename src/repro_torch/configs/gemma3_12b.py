"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family; 12B config] 48L d_model=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144, head_dim=256, sliding window 1024 for local layers.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    source="hf:google/gemma-3-1b-pt (gemma-3 family card)",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262_144,
    attention_type="local_global",
    local_global_ratio=5,
    window_size=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
