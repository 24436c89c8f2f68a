"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block. [arXiv:2411.15242]

54 layers modeled as 9 superblocks x (5 Mamba2 layers + 1 shared-weight
attention layer): the Zamba trick stores the attention block's parameters
once and reuses them at every superblock.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32_000,
    ssm_type="mamba2",
    ssm_state_dim=64,
    ssm_head_dim=64,
    hybrid_ssm_per_attn=5,
))
