from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_verify)
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_attention_verify_ref)

__all__ = ["paged_attention", "paged_attention_ref", "paged_attention_verify",
           "paged_attention_verify_ref"]
