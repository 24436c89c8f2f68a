"""yi-9b [dense] — llama-arch GQA. [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
))
