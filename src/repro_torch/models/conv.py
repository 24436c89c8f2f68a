"""Convolution algorithms from survey §4.3 (the port's counterpart of
``repro.models.conv``): direct, im2col (Toeplitz/GEMM), FFT, and Winograd
F(2x2, 3x3).

All operate on NCHW inputs and OIHW kernels with VALID padding, matching
Eq. 2 of the paper, with the reference's signatures and layouts. Their work
and depth are modelled in ``core/workdepth.py`` (Table 6). ``conv_im2col``
computes its GEMM with ``kernels.matmul.matmul``: kernel B7 on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.matmul import matmul


def conv_direct(x, w):
    """Eq. 2 verbatim via F.conv2d (the reference's lax.conv, left to a
    library op there too). x: (N, C, H, W); w: (K, C, Ky, Kx). f32 stays
    IEEE f32 on the card: cuDNN's TF32 is switched off for this call only,
    every other cuDNN setting of the caller is kept."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, w)


def conv_im2col(x, w):
    """Toeplitz unrolling + one GEMM (§4.3 'processor-friendly' method)."""
    N, C, H, W = x.shape
    K, C2, Ky, Kx = w.shape
    Ho, Wo = H - Ky + 1, W - Kx + 1
    # patches: (N, Ho, Wo, C*Ky*Kx)
    patches = torch.stack([
        x[:, :, dy:dy + Ho, dx:dx + Wo]
        for dy in range(Ky) for dx in range(Kx)
    ], dim=-1)                                     # (N, C, Ho, Wo, Ky*Kx)
    patches = patches.permute(0, 2, 3, 1, 4).reshape(N * Ho * Wo,
                                                     C * Ky * Kx)
    kernel = w.reshape(K, C * Ky * Kx).T           # (C*Ky*Kx, K)
    out = matmul(patches, kernel)                  # THE GEMM
    return out.reshape(N, Ho, Wo, K).permute(0, 3, 1, 2)


def conv_fft(x, w):
    """Fourier-domain convolution (§4.3): y = IFFT(Σ_c FFT(x_c) ∘ FFT(w_c)).

    Correlation (as in Eq. 2) = convolution with a flipped kernel, handled by
    conjugation-free index flip before the transform.
    """
    N, C, H, W = x.shape
    K, _, Ky, Kx = w.shape
    Ho, Wo = H - Ky + 1, W - Kx + 1
    wf = torch.flip(w, (2, 3))                     # correlation -> convolution
    X = torch.fft.rfft2(x, s=(H, W))               # (N, C, H, W//2+1)
    Wt = torch.fft.rfft2(wf, s=(H, W))             # (K, C, H, W//2+1)
    Y = torch.einsum("nchw,kchw->nkhw", X, Wt)     # sum over channels
    y = torch.fft.irfft2(Y, s=(H, W))              # full conv result
    return y[:, :, Ky - 1:Ky - 1 + Ho, Kx - 1:Kx - 1 + Wo]


# Winograd F(2x2, 3x3) transform matrices [Lavin & Gray 2016, §4.3]
_B = np.array([[1, 0, 0, 0], [0, 1, -1, 1], [-1, 1, 1, 0], [0, 0, 0, -1]],
              np.float32)
_G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]],
              np.float32)
_A = np.array([[1, 0], [1, 1], [1, -1], [0, -1]], np.float32)


def conv_winograd(x, w):
    """Winograd minimal filtering F(2x2, 3x3) (§4.3):
       Y = A^T [ Σ_c (G g G^T) ∘ (B^T d B) ] A  per 4x4 tile."""
    N, C, H, W = x.shape
    K, _, Ky, Kx = w.shape
    assert (Ky, Kx) == (3, 3), "Winograd path is for 3x3 kernels (§4.3)"
    Ho, Wo = H - 2, W - 2
    m = 2
    tiles_y, tiles_x = Ho // m, Wo // m
    B, G, A = (torch.from_numpy(M).to(x.device, x.dtype)
               for M in (_B, _G, _A))

    # kernel transform: U = G g G^T  -> (K, C, 4, 4)
    U = torch.einsum("ij,kcjl,ml->kcim", G, w, G)

    # input tiles: d (N, C, ty, tx, 4, 4) with stride m — the reference's
    # stack of per-tile slices, as two strided windows (the same values)
    d = x.unfold(2, 4, m).unfold(3, 4, m)[:, :, :tiles_y, :tiles_x]
    V = torch.einsum("ji,nctxjl,lm->nctxim", B, d, B)   # B^T d B

    M = torch.einsum("kcim,nctxim->nktxim", U, V)       # elementwise ∘, Σ_c
    Y = torch.einsum("ji,nktxjl,lm->nktxim", A, M, A)   # (N, K, ty, tx, 2, 2)
    out = Y.permute(0, 1, 2, 4, 3, 5).reshape(N, K, tiles_y * m,
                                              tiles_x * m)
    return out[:, :, :Ho, :Wo]


ALGORITHMS = {
    "direct": conv_direct,
    "im2col": conv_im2col,
    "fft": conv_fft,
    "winograd": conv_winograd,
}
