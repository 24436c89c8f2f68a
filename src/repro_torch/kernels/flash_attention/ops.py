"""GQA-aware flash attention over (B, S, H, hd) layouts, with its gradient.

``flash_attention`` dispatches by device: a CPU tensor takes the plain
version (``ref``); a CUDA tensor launches the hand-written kernel or
raises — there is no fallback. Launches count under
``repro_torch.kernels.launch_counts["flash_attention"]``.

The forward runs inside ``FlashAttention``, a ``torch.autograd.Function``
whose backward is PyTorch code (``attention_backward``) that recomputes the
probabilities one query chunk at a time from the saved row log-sum-exp.
The reference has no backward kernel either: XLA differentiates its
checkpointed chunk (``repro.models.attention._chunked_attention``), and this
backward is the counterpart of that autodiff.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

# query rows per chunk of the backward pass: bounds its f32 score-sized
# temporaries to (B, H, BWD_CHUNK, keys)
BWD_CHUNK = 512


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"want q (B, S, H, hd) and k, v (B, S, Hkv, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    if (tuple(v.shape) != tuple(k.shape) or k.shape[:2] != q.shape[:2]
            or k.shape[3] != hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads "
                         f"{k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    if q.dtype not in SUPPORTED_DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: want "
                        f"one of {SUPPORTED_DTYPES}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")
    if q.is_cuda and hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} unsupported: the kernel takes "
                         f"multiples of 8 up to 256")


def _forward_plain(q, k, v, scale, causal, window):
    return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                               window=window)


def _forward_kernel(q, k, v, scale, causal, window):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the "
                         "kernel loads rows in 16-byte vectors)")
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    flash_attention_cuda(q, k, v, out, lse, scale, causal, window)
    kernels.launch_counts["flash_attention"] += 1
    return out, lse


def attention_backward(q, k, v, out, lse, dout, *, scale, causal=True,
                       window=None, chunk=BWD_CHUNK):
    """Gradients (dq, dk, dv) of softmax attention, from the forward's
    output and row log-sum-exp, in f32, one chunk of `chunk` query rows at
    a time. Each chunk reads only the keys its mask can admit (from the
    window's reach to its last row under the causal mask):

      P = exp(q·kᵀ·scale − lse) (0 where masked), dP = dO·vᵀ,
      D = rowsum(dO ∘ O), dS = P ∘ (dP − D),
      dq = dS·k·scale, dk = dSᵀ·q·scale, dv = Pᵀ·dO,

    with the dk/dv of a kv head summed over its group of query heads.
    Shapes as ``flash_attention``; lse (B, H, S) f32. Returns tensors of
    q's, k's and v's dtypes."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv

    def groups(t):            # (B, S, H, hd) -> (B, Hkv, rep, S, hd) f32
        return t.float().reshape(B, S, Hkv, rep, hd).permute(0, 2, 3, 1, 4)

    qg, og, dog = groups(q), groups(out), groups(dout)
    kg = k.float().permute(0, 2, 1, 3)                     # (B, Hkv, S, hd)
    vg = v.float().permute(0, 2, 1, 3)
    lse_g = lse.reshape(B, Hkv, rep, S)
    delta = (dog * og).sum(-1)                             # (B, Hkv, rep, S)
    dq = torch.empty((B, Hkv, rep, S, hd), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, Hkv, S, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    pos = torch.arange(S, device=q.device)
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        k0 = max(0, c0 - window + 1) if window is not None else 0
        k1 = c1 if causal else S
        n, kn = c1 - c0, k1 - k0
        qc = qg[:, :, :, c0:c1].reshape(B, Hkv, rep * n, hd)
        doc = dog[:, :, :, c0:c1].reshape(B, Hkv, rep * n, hd)
        kc, vc = kg[:, :, k0:k1], vg[:, :, k0:k1]
        mask = torch.ones((n, kn), dtype=torch.bool, device=q.device)
        qp, kp = pos[c0:c1, None], pos[None, k0:k1]
        if causal:
            mask &= kp <= qp
        if window is not None:
            mask &= kp > qp - window
        s = (qc @ kc.transpose(-1, -2)).view(B, Hkv, rep, n, kn) * scale
        p = torch.where(mask, torch.exp(s - lse_g[:, :, :, c0:c1, None]), 0.0)
        dp = (doc @ vc.transpose(-1, -2)).view(B, Hkv, rep, n, kn)
        ds = (p * (dp - delta[:, :, :, c0:c1, None])).view(B, Hkv, rep * n, kn)
        p = p.view(B, Hkv, rep * n, kn)
        dq[:, :, :, c0:c1] = (ds @ kc).view(B, Hkv, rep, n, hd) * scale
        dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qc) * scale
        dv[:, :, k0:k1] += p.transpose(-1, -2) @ doc
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA tensors) or its plain version (CPU
    tensors), saving the output and row log-sum-exp; backward:
    ``attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        forward = _forward_kernel if q.is_cuda else _forward_plain
        out, lse = forward(q, k, v, scale, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.window = scale, causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, lse, dout,
                                        scale=ctx.scale, causal=ctx.causal,
                                        window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd) with H % Hkv == 0, one
    dtype (f32 or bf16). Returns (B, S, H, hd) in q's dtype, differentiable
    in q, k and v. On CUDA, hd must be a multiple of 8 up to 256; S is any
    length."""
    _check(q, k, v, window)
    return FlashAttention.apply(q, k, v, q.shape[-1] ** -0.5, causal, window)
