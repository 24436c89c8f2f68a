"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # d_model / ssm_head_dim
    num_kv_heads=64,
    d_ff=14336,              # channel-mix hidden
    vocab_size=65_536,
    ssm_type="rwkv6",
    ssm_head_dim=64,
    rope_mode="none",
))
