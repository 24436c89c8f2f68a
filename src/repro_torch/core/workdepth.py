"""Work-Depth concurrency model — survey §2.5, Tables 4 & 6, §3.3.1 (the
port's own copy of ``repro.core.workdepth``, which imports no JAX).

W = total operations (vertices of the computation DAG), D = longest
dependency path. Average parallelism = W/D. Formulas follow the paper's
appendix conventions:

  conv(H, K, C_in, C_out):  W = H'·W'·C_out·(C_in·K_x·K_y)  multiply-adds...
  The paper's §3.3.1 LeNet numbers imply per-output-pixel work
  C_in·K²·C_out counted as fused multiply-accumulate "operations", and
  D = ⌈log2 C_in⌉ + ⌈log2 K_x⌉ + ⌈log2 K_y⌉ per layer. We reproduce the
  published W = 665,832 / D = 41 for LeNet-5 inference exactly (test-pinned).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def _clog2(x):
    return int(math.ceil(math.log2(x))) if x > 1 else 0


@dataclass(frozen=True)
class WD:
    work: int
    depth: int

    @property
    def avg_parallelism(self) -> float:
        return self.work / max(self.depth, 1)

    def __add__(self, other: "WD") -> "WD":
        return WD(self.work + other.work, self.depth + other.depth)


# ------------------------------------------------------------------- Table 4
def fully_connected(N, C_in, C_out, phase="y") -> WD:
    w = N * C_in * C_out
    d = {"y": _clog2(C_in), "dw": _clog2(N), "dx": _clog2(C_out)}[phase]
    return WD(w, d)


def conv_direct(N, H, W_, C_in, C_out, Kx, Ky, phase="y") -> WD:
    Hp, Wp = H - Ky + 1, W_ - Kx + 1
    if phase == "dx":
        Hp, Wp = H, W_
    work = N * C_out * C_in * Hp * Wp * Kx * Ky
    depth = _clog2(Kx) + _clog2(Ky) + _clog2(C_in)
    return WD(work, depth)


def pooling(N, C, H, W_, Kx, Ky, phase="y") -> WD:
    if phase == "y":
        return WD(N * C * H * W_, _clog2(Kx) + _clog2(Ky))
    return WD(N * C * H * W_, 0)   # dx: O(1)


def activation(N, C, H, W_, phase="y") -> WD:
    return WD(N * C * H * W_, 0)   # O(1) depth


def batchnorm(N, C, H, W_, phase="y") -> WD:
    return WD(N * C * H * W_, _clog2(N))


def attention(N, S, H, hd, phase="y", window=None) -> WD:
    """GQA/MHA self-attention (beyond-paper extension of Table 4): scores +
    weighted sum. Sub-quadratic with a sliding window."""
    span = min(S, window) if window else S
    work = 2 * N * H * S * span * hd + N * H * S * span  # qk^T, softmax, pv
    depth = _clog2(hd) + _clog2(span) + 4
    return WD(work, depth)


# ------------------------------------------------------------------- Table 6
def conv_im2col(N, H, W_, C_in, C_out, Kx, Ky) -> WD:
    return conv_direct(N, H, W_, C_in, C_out, Kx, Ky)   # same W and D


def conv_fft(N, H, W_, C_in, C_out, Kx=None, Ky=None, c=5.0) -> WD:
    hw = H * W_
    work = int(c * hw * math.log2(hw) * (C_out * C_in + N * C_in + N * C_out)
               + hw * N * C_in * C_out)
    depth = 2 * _clog2(hw) + _clog2(C_in)
    return WD(work, depth)


def conv_winograd(N, H, W_, C_in, C_out, r, m) -> WD:
    """m×m tiles, r×r kernels (Table 6's α ≡ m − r + 1 … published formula)."""
    alpha = m - r + 1
    Ptiles = N * math.ceil(H / m) * math.ceil(W_ / m)
    work = int(alpha * (r ** 2 + alpha * r + 2 * alpha ** 2 + alpha * m + m ** 2)
               + C_out * C_in * Ptiles)
    depth = 2 * _clog2(r) + 4 * _clog2(alpha) + _clog2(C_in)
    return WD(work, depth)


# -------------------------------------------------------- §3.3.1 case studies
def lenet5_layers() -> dict[str, WD]:
    """Per-layer W-D for the paper's §3.3.1 LeNet-5 worked example, using the
    accounting that reproduces the published numbers:

      conv:  W = H_count²·C_out·C_in·K²      (paper uses the *output* size 28
             for conv1 but the *input* size 14 for conv2 — an internal
             inconsistency of the survey; we match it as printed and flag it
             in benchmarks/table5_networks.py)
             D = ⌈log2(C_in·K²)⌉ for conv1, but
             D = ⌈log2 Kx⌉+⌈log2 Ky⌉+⌈log2 C_in⌉ for conv2 (Table 6 form).
      pool:  W = 3·C·H_in² (3 ops per input element), D = 2·⌈log2 K⌉
      fc:    W = C_in·C_out, D = ⌈log2 C_in⌉   (matches Table 4 exactly)
    """
    return {
        "conv1": WD(28 * 28 * 6 * (1 * 5 * 5), _clog2(1 * 5 * 5)),        # 117600, 5
        "pool1": WD(3 * 6 * 28 * 28, _clog2(2) + _clog2(2)),              # 14112, 2
        "conv2": WD(14 * 14 * 16 * (6 * 5 * 5), _clog2(5) + _clog2(5) + _clog2(6)),  # 470400, 9
        "pool2": WD(3 * 16 * 10 * 10, _clog2(2) + _clog2(2)),             # 4800, 2
        "fc1": WD(400 * 120, _clog2(400)),                                # 48000, 9
        "fc2": WD(120 * 84, _clog2(120)),                                 # 10080, 7
        "fc3": WD(84 * 10, _clog2(84)),                                   # 840, 7
    }


def lenet5_inference() -> WD:
    """Reproduces the paper's published totals: W = 665,832, D = 41."""
    total = WD(0, 0)
    for wd in lenet5_layers().values():
        total += wd
    return total


# published per-layer numbers (used for the pinned test + Table 5 benchmark)
LENET5_PAPER = {
    "conv1": (117_600, 5),
    "pool1": (14_112, 2),
    "conv2": (470_400, 9),
    "pool2": (4_800, 2),
    "fc1": (48_000, 9),
    "fc2": (10_080, 7),
    "fc3": (840, 7),
    "total": (665_832, 41),
}


def lenet5_paper_total() -> WD:
    w = sum(v[0] for k, v in LENET5_PAPER.items() if k != "total")
    d = sum(v[1] for k, v in LENET5_PAPER.items() if k != "total")
    return WD(w, d)


# --------------------------------------------------------- Table 5 networks
def network_table5():
    """Table 5: published parameter/operation counts for the five networks."""
    return {
        "LeNet": {"params": 60e3, "layers": 7, "ops": None},
        "AlexNet": {"params": 61e6, "layers": 13, "ops": 725e6},
        "GoogLeNet": {"params": 6.8e6, "layers": 27, "ops": 1566e6},
        "ResNet": {"params": (1.7e6, 60.2e6), "layers": (50, 152), "ops": (1000e6, 2300e6)},
        "DenseNet": {"params": (15.3e6, 30e6), "layers": (40, 250), "ops": (600e6, 1130e6)},
    }


# ------------------------------------------------------ transformer extension
def transformer_train_wd(cfg, batch, seq) -> WD:
    """Whole-decoder W-D for one training step (fwd+bwd ≈ 3× fwd work,
    +⌈log2 N·S⌉ gradient-reduction depth) — our beyond-paper extension of the
    paper's per-network analysis to the assigned architectures."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    total = WD(0, 0)
    for _ in range(1):  # per layer, multiplied below
        pass
    per_layer = WD(0, 0)
    if cfg.family == "ssm":
        per_layer += WD(batch * seq * 6 * d * d, _clog2(d))       # projections
        per_layer += WD(batch * seq * d * cfg.ssm_head_dim, _clog2(cfg.ssm_head_dim) + seq // max(seq, 1))
        per_layer += WD(batch * seq * 3 * d * cfg.d_ff, _clog2(d))
    else:
        window = cfg.window_size if cfg.attention_type == "sliding" else None
        h = cfg.num_heads
        per_layer += WD(batch * seq * 2 * d * (cfg.num_heads + cfg.num_kv_heads) * hd,
                        _clog2(d))
        per_layer += attention(batch, seq, h, hd, window=window)
        ff = cfg.d_ff * (cfg.experts_per_token or 1)
        per_layer += WD(batch * seq * 3 * d * ff, _clog2(d))
    total = WD(per_layer.work * cfg.num_layers * 3,               # fwd+bwd
               per_layer.depth * cfg.num_layers * 2)
    total += WD(batch * seq * d * cfg.vocab_size * 3, _clog2(d) + _clog2(cfg.vocab_size))
    total += WD(0, _clog2(batch * seq))                           # grad reduce
    return total
