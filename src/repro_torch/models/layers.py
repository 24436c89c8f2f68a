"""Shared layer primitives: norms, MLPs, embeddings, RoPE (standard and
M-RoPE).

Functional like ``repro.models.layers``: parameters are plain dicts of
tensors and every ``*`` function is pure. Parameters are stored in
``cfg.dtype``; norms, the SiLU and RoPE run in float32 and cast back, as the
reference does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ----------------------------------------------------------------- init utils
def dense_init(shape, dtype, gen: torch.Generator, device, scale=None):
    """Normal(0, 1) · 1/√fan_in (fan_in = shape[-2], the contracted axis of
    a weight stored (in, out), with a leading stack axis allowed)."""
    fan_in = shape[-2] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(shape, dtype, gen: torch.Generator, device):
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


# ----------------------------------------------------------------------- norm
def rmsnorm(params, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# ------------------------------------------------------------------------ mlp
def swiglu(params, x):
    g = x @ params["w_gate"]
    h = x @ params["w_in"]
    act = F.silu(g.float()).to(x.dtype) * h
    return act @ params["w_out"]


# ----------------------------------------------------------------------- rope
def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # computed in float64 by numpy and cast to float32, as the reference
    # does; cached so a decode step copies nothing from the host
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta=10_000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, hd/2)
    angles = angles[..., None, :]                                 # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim, sections=(16, 24, 24)):
    """The (t, h, w) sections of the head_dim/2 frequency slots, rescaled
    for head dims whose half is not their sum by the reference's numpy
    code (``np.round``: half to even; the last section takes the rest)."""
    half = head_dim // 2
    secs = np.asarray(sections)
    if secs.sum() != half:
        secs = np.round(secs * half / secs.sum()).astype(int)
        secs[-1] = half - secs[:-1].sum()
    return secs


@functools.lru_cache(maxsize=None)
def _mrope_select_on(head_dim: int, sections: tuple, device: torch.device):
    # the stream of each frequency slot; cached so a decode step copies
    # nothing from the host
    secs = mrope_sections(head_dim, sections)
    sel = np.concatenate([np.full(n, i) for i, n in enumerate(secs)])
    return torch.as_tensor(sel, dtype=torch.long, device=device)


def apply_mrope(x, positions3, theta=10_000.0, sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE. x: (..., S, H, hd); positions3: (3, ...,
    S) temporal / height / width ids. Frequency slot j turns by the
    position of the stream its section names; with three equal streams
    this is :func:`apply_rope` bit for bit (the same angles, position ·
    freq, in float32)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)            # (hd/2,)
    sel = _mrope_select_on(hd, tuple(sections), x.device)         # (hd/2,)
    pos = torch.movedim(positions3[sel], 0, -1)             # (..., S, hd/2)
    angles = (pos.float() * freqs)[..., None, :]            # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ embedding
def embed(params, ids):
    return params["table"][ids]


def unembed(params, x):
    """Tied unembedding: (..., d) @ (vocab, d)^T."""
    return x @ params["table"].T
