"""stablelm-3b [dense] — MHA-style (kv=heads). [hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b (stablelm family card)",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50_304,
))
