"""Model/config registry (the port's own copy of ``repro.configs.base``).

Every architecture is a `ModelConfig`; reduced variants for CPU tests are
derived with `reduced()`. The dataclass, its defaults and `reduced()` are
kept field for field identical to the JAX package's, so one config value
describes the same model in both packages.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation (paper / model card)
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None   # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 512
    # attention pattern
    attention_type: str = "full"     # full | sliding | local_global
    window_size: int = 4096
    local_global_ratio: int = 0      # N local layers per 1 global (gemma3: 5)
    rope_theta: float = 10_000.0
    rope_mode: str = "standard"      # standard | mrope | none
    # mixture of experts
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # state-space / recurrent
    ssm_type: str = ""               # "" | rwkv6 | mamba2
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    # hybrid (zamba2-style): superblock = N ssm layers + 1 shared attn layer
    hybrid_ssm_per_attn: int = 0
    # modality frontend stub: model consumes embeddings instead of token ids
    frontend: str = "none"           # none | vision_stub | audio_stub
    num_codebooks: int = 0           # musicgen
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # training
    remat: bool = True
    loss_chunk: int = 512            # chunked cross-entropy block (big vocabs)
    attn_chunk: int = 1024           # chunked-attention query block

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks + head) of the
        dense family, the only one this package serves so far."""
        if self.family not in ("dense", "vlm", "audio") or self.num_experts:
            raise NotImplementedError(
                f"param_count for the {self.family} family comes with its "
                f"slice of the port")
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * self.num_heads * hd * 2 + d * self.num_kv_heads * hd * 2
        n = self.num_layers * (attn + 3 * d * self.d_ff + 2 * d)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        return n


_REGISTRY: dict[str, ModelConfig] = {}

ARCH_MODULES = ["gemma3_12b", "stablelm_3b", "yi_9b"]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    key = name.replace("-", "_").replace(".", "_")
    for k, v in _REGISTRY.items():
        if k == name or k.replace("-", "_").replace(".", "_") == key:
            return v
    raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")


def list_configs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            vocab: int = 512, seq_ok: bool = True) -> ModelConfig:
    """Reduced same-family variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
    num_heads = 4
    head_dim = 64
    num_kv = min(cfg.num_kv_heads, num_heads)
    if cfg.num_kv_heads >= cfg.num_heads:
        num_kv = num_heads           # MHA-style archs stay MHA
    elif cfg.num_kv_heads * 2 >= cfg.num_heads:
        num_kv = 2
    else:
        num_kv = 1
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=d_model * 2,
        vocab_size=vocab,
        window_size=min(cfg.window_size, 32),
        loss_chunk=64,
        attn_chunk=32,
        remat=False,
    )
    if cfg.num_experts:
        kw["num_experts"] = 4
        kw["experts_per_token"] = min(cfg.experts_per_token, 2)
    if cfg.attention_type == "local_global":
        kw["local_global_ratio"] = 1
        kw["num_layers"] = 2         # 1 superblock: 1 local + 1 global
    if cfg.family == "hybrid":
        kw["hybrid_ssm_per_attn"] = 1
        kw["num_layers"] = 2         # 1 superblock: 1 mamba + shared attn
        kw["ssm_state_dim"] = min(cfg.ssm_state_dim or 16, 16)
    if cfg.ssm_type == "rwkv6":
        kw["ssm_head_dim"] = 32
    return replace(cfg, **kw)
