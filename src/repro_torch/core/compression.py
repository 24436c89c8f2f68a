"""Gradient/parameter compression — survey §6.3, quantization and
sparsification (counterpart of ``repro.core.compression``).

Quantizers (§6.3.1):
  stochastic_round        reduced floating precision with expectation-
                          preserving rounding [Gupta et al. 2015]
  int8 / int4 (QSGD)      multi-level stochastic quantization with per-block
                          scales [Alistarh et al. 2017]: kernel B9 on the
                          card (``kernels.quantize.quantize_blocks``)
  ternary                 {−1, 0, +1}·scale [TernGrad, Wen et al. 2017]
  onebit                  sign + per-tensor mean magnitude [Seide et al. 2014]

Sparsifiers (§6.3.2):
  topk                    relative threshold (top-k%) [Aji & Heafield 2017]
  threshold               static absolute threshold [Strom 2015]

Every compressor supports **error feedback** (the survey's "local gradient
accumulation"): the residual ``g − decompress(compress(g + r))`` is carried
to the next step. DGC momentum correction [Lin et al. 2018] is
``dgc_update``. ``Compressor.ratio`` gives the analytical compression ratio.

A ``jax`` key becomes a ``torch.Generator`` on the tensor's device; the two
give different numbers, so each random function has a noise-taking inner
step (``round_with_noise``, ``ternarize_with_noise``,
``quantize_blocks(flat, noise)``) that the tests feed the reference's noise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels.quantize import dequantize_blocks, quantize_blocks
from repro_torch.tree import leaves_with_path, tree_from_leaves, tree_map

_BITS_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


# ------------------------------------------------------------------ primitives
def _next_after(x, direction):
    """Next representable value of x (same dtype) toward ±inf: a step of one
    on the bit pattern, as the reference does (-0.0 steps like +0.0)."""
    bits = x.view(_BITS_VIEW[x.dtype])
    pos_step = torch.where(x.float() >= 0, 1, -1).to(bits.dtype)
    step = pos_step if direction > 0 else -pos_step
    return (bits + step).view(x.dtype)


def round_with_noise(x, u, target=torch.bfloat16):
    """Stochastic rounding of x to `target` given uniform noise u of x's
    shape: up with probability (x − down) / (up − down)."""
    x = x.float()
    down = x.to(target)
    down_f = down.float()
    up = torch.where(x >= down_f, _next_after(down, +1),
                     _next_after(down, -1))
    up_f = up.float()
    denom = torch.where(up_f == down_f, 1.0, up_f - down_f)
    p_up = torch.clamp((x - down_f) / denom, 0.0, 1.0)
    return torch.where(u < p_up, up, down)


def stochastic_round(x, gen, target=torch.bfloat16):
    """Round x (f32) to `target` such that E[round(x)] = x [Gupta et al.
    2015]; noise from `gen`."""
    return round_with_noise(x, _uniform(x.shape, gen, x.device), target)


def quantize_int(x, gen, bits=8, block=256):
    """QSGD-style per-block scaled stochastic integer quantization: kernel B9
    on the card, with the noise (rows, block) drawn from `gen`. Returns (q
    int8 (rows, block), scales f32 (rows,), shape)."""
    rows = -(-x.numel() // block)
    noise = _uniform((rows, block), gen, x.device)
    q, scales = quantize_blocks(x.reshape(-1), noise, bits=bits, block=block)
    return q, scales, x.shape


def dequantize_int(q, scale, shape):
    return dequantize_blocks(q, scale, math.prod(shape)).reshape(shape)


def ternarize_with_noise(x, u):
    """TernGrad given uniform noise u: g → s·sign(g)·b, b ~ Bernoulli(|g|/s),
    s = max|g|."""
    x = x.float()
    s = torch.amax(torch.abs(x))
    s = torch.where(s == 0, 1.0, s)
    p = torch.abs(x) / s
    return s * torch.sign(x) * (u < p)


def ternarize(x, gen):
    return ternarize_with_noise(x, _uniform(x.shape, gen, x.device))


def onebit(x):
    """1-bit SGD: sign(g) scaled by mean |g| per tensor [Seide et al. 2014]."""
    x = x.float()
    return torch.sign(x) * torch.mean(torch.abs(x))


def topk_sparsify(x, frac):
    """Keep the top-`frac` fraction by |value| (ties at the threshold kept);
    returns the dense masked tensor (index+value transport is modelled
    analytically in ``ratio``)."""
    x = x.float()
    a = torch.abs(x)
    k = max(1, int(x.numel() * frac))
    thresh = torch.topk(a.reshape(-1), k).values[-1]
    return torch.where(a >= thresh, x, 0.0)


def threshold_sparsify(x, tau):
    x = x.float()
    return torch.where(torch.abs(x) >= tau, x, 0.0)


# ------------------------------------------------------------------ Compressor
@dataclass(frozen=True)
class Compressor:
    """compress: (g, generator) -> g̃ f32 (the lossy round trip), with the
    wire size per element in `bits_per_element`. `fn` returns a new tensor
    (error feedback updates its input in place afterwards)."""
    name: str
    fn: Callable          # (x, gen) -> x̃
    bits_per_element: float

    def __call__(self, x, gen=None):
        return self.fn(x, gen)

    def ratio(self) -> float:
        return 32.0 / self.bits_per_element

    def compress_with_feedback(self, grads, residual, gen=None):
        """Error-feedback compression over a tree (survey: local gradient
        accumulation). Returns (sent, residual): each sent leaf in its
        gradient's dtype; the f32 residual leaves are updated in place to
        (g + r) − sent. Without `gen` a fresh generator seeded 0 is made on
        every call, as the reference uses PRNGKey(0) on every call, so every
        step draws the same noise; the noise is drawn leaf after leaf in
        ``leaves_with_path`` order."""
        res = [r for _, r in leaves_with_path(residual)]
        outs = []
        for (path, g), r in zip(leaves_with_path(grads), res):
            if gen is None:
                gen = torch.Generator(device=g.device)
                gen.manual_seed(0)
            r.add_(g)                               # the corrected gradient
            sent = self.fn(r, gen)
            outs.append((path, sent.to(g.dtype)))
            r.sub_(sent)
        return tree_from_leaves(outs), residual


def make_compressor(name: str, *, bits=8, frac=0.01, tau=1e-3,
                    block=256) -> Compressor:
    if name == "none":
        return Compressor("none", lambda x, g: x.to(torch.float32, copy=True),
                          32.0)
    if name == "stochastic_bf16":
        return Compressor(name, lambda x, g: stochastic_round(x, g).float(),
                          16.0)
    if name in ("int8", "int4", "qsgd"):
        b = {"int8": 8, "int4": 4}.get(name, bits)

        def f(x, g, b=b):
            return dequantize_int(*quantize_int(x, g, bits=b, block=block))
        return Compressor(name, f, b + 32.0 / block)
    if name == "ternary":
        return Compressor(name, ternarize, math.log2(3))
    if name == "onebit":
        return Compressor(name, lambda x, g: onebit(x), 1.0)
    if name == "topk":
        # value (32b) + index (32b) per kept element
        return Compressor(name, lambda x, g: topk_sparsify(x, frac),
                          64.0 * frac)
    if name == "topk_int8":
        # per KEPT element: 32b index + 8b value + the per-block scale
        # amortized over the kept values (Strom-2015-style sparse payload)
        def f(x, g):
            return dequantize_int(*quantize_int(topk_sparsify(x, frac), g,
                                                bits=8, block=block))
        return Compressor(name, f, frac * (8 + 32 + 32.0 / block))
    if name == "threshold":
        return Compressor(name, lambda x, g: threshold_sparsify(x, tau),
                          64.0 * frac)
    raise ValueError(f"unknown compressor {name!r}")


# --------------------------------------------------- DGC momentum correction
def dgc_update(grads, velocity, residual, frac=0.01, momentum=0.9):
    """Deep Gradient Compression [Lin et al. 2018]: accumulate the velocity
    locally (momentum correction) and sparsify the accumulated velocity.
    Returns (sent, new_velocity, new_residual); the sent coordinates are
    cleared in both."""
    def per_leaf(g, v, r):
        v = momentum * v + g.float()             # local momentum
        acc = r + v                              # local gradient accumulation
        sent = topk_sparsify(acc, frac)
        mask = sent == 0.0
        return sent, v * mask, acc * mask

    trip = tree_map(per_leaf, grads, velocity, residual)
    return tuple(tree_map(lambda t, i=i: t[i], trip) for i in range(3))
