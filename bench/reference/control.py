"""The precision control: the plain reference with every matrix product in
float8, as an fp8 GEMM runs it. The forward's operands are rounded to e4m3
(a scale per row of the activations, per column of the weights); in
training the backward's products take the incoming gradient rounded to e5m2
(a scale per row for the input's gradient, per column for the weight's)
against the rounded forward operands. The products themselves and
everything else stay in float32.
"""
from __future__ import annotations

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
MAX = {E4M3: 448.0, E5M2: 57344.0}


def _round(x, dim, fmt=E4M3):
    """x rounded to float8 `fmt` with one scale per slice along `dim`."""
    amax = torch.amax(torch.abs(x), dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / MAX[fmt]
    return (x / scale).to(fmt).float() * scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _round(x, -1), _round(w.float(), -2)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gx = _round(g, -1, E5M2) @ wq.transpose(-1, -2)
        gw = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1)
              @ _round(g, -2, E5M2).reshape(-1, g.shape[-1]))
        return gx, gw


def fp8_linear(x, w):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Fp8Product.apply(x, w)
    return _round(x, -1) @ _round(w.float(), -2)
