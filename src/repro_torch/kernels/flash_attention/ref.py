"""Plain PyTorch version of the flash-attention kernel: materialized-scores
softmax attention with the kernel's masking (counterpart of
``repro.kernels.flash_attention.ref``), and the same function on the
model's (B, S, H, hd) layout with GQA and the row log-sum-exp."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(S: int, causal: bool, window, device):
    """(S, S) bool, True = attend: key position <= query position under
    `causal`, and > query position - window under a window."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref_lse(q, k, v, *, scale=None, causal=True, window=None):
    """q, k, v: (BH, S, hd) -> (out (BH, S, hd) in q's dtype, row
    log-sum-exp (BH, S) f32); scores, softmax and p·v in f32."""
    BH, S, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = attention_mask(S, causal, window, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    return out, lse


def attention_ref(q, k, v, *, scale=None, causal=True, window=None):
    """q, k, v: (BH, S, hd) -> (BH, S, hd)."""
    return attention_ref_lse(q, k, v, scale=scale, causal=causal,
                             window=window)[0]


def flash_attention_ref(q, k, v, *, scale=None, causal=True, window=None):
    """The kernel's function on its own layout: q (B, S, H, hd), k and v
    (B, S, Hkv, hd) with H % Hkv == 0. Returns (out (B, S, H, hd), lse
    (B, H, S) f32). K/V are repeated per query head, as the reference's
    ``ops.flash_attention`` does before its kernel."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    def to_bh(t):
        return t.transpose(1, 2).reshape(B * H, S, hd)

    out, lse = attention_ref_lse(to_bh(q), to_bh(k), to_bh(v), scale=scale,
                                 causal=causal, window=window)
    return (out.reshape(B, H, S, hd).transpose(1, 2),
            lse.reshape(B, H, S))
