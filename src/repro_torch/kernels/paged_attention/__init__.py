from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_ref"]
