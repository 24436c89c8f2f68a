"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    attention_type="sliding",
    window_size=4096,
    num_experts=8,
    experts_per_token=2,
))
