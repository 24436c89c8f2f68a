"""Plain PyTorch version of the block quantizer (the port's copy of
``repro.kernels.quantize.ref``): the CPU path of ``ops.quantize_blocks``,
and what ``chip_smoke.py`` holds kernels B8/B9 against on the card."""
import torch


def quantize_blocks_ref(x, noise=None, bits=8, mode="stochastic"):
    """x, noise: (rows, block); noise unused in nearest mode. Returns (q
    int8, scales f32 (rows,)). The scale divides by a tensor: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which is not
    the reference's amax / maxq."""
    maxq = 2 ** (bits - 1) - 1
    x = x.float()
    amax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    div = torch.full((), float(maxq), dtype=torch.float32, device=x.device)
    scale = torch.where(amax == 0.0, 1.0, amax / div)
    y = x / scale
    if mode == "nearest":
        q = torch.round(y)                      # half to even, as jnp.round
    else:
        lo = torch.floor(y)
        q = lo + (noise < (y - lo)).float()
    return torch.clamp(q, -maxq - 1, maxq).to(torch.int8), scale[:, 0]


def dequantize_blocks_ref(q, scales):
    return q.float() * scales[:, None]
