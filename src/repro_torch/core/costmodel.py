"""Analytical cost models from survey §2.5 (α-β / simplified LogP) plus the
parallelism communication-volume models of §5 and the roofline terms used by
the dry-run analysis (the port's own copy of ``repro.core.costmodel``, which
imports no JAX; nothing on the port's main path calls it — the launch
scripts of ROADMAP A16 read it).

All times in seconds; m = number of elements, gamma = bytes per element,
L = α latency, G = β cost/byte, P = #processors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


# ------------------------------------------------------ §2.5 collective models
def t_tree(P, m, L, G, gamma=4):
    return 2 * math.log2(P) * (L + gamma * m * G)


def t_butterfly(P, m, L, G, gamma=4):
    return math.log2(P) * (L + gamma * m * G)


def t_pipeline(P, m, L, G, gamma=4):
    return 2 * (P - 1) * (L + gamma * (m / P) * G)


def t_rabenseifner(P, m, L, G, gamma=4):
    return 2 * L * math.log2(P) + 2 * gamma * m * G * (P - 1) / P


def t_lower_bound(P, m, L, G, gamma=4):
    """T ≥ L·log2(P) + 2γmG(P−1)/P [Chan et al. 2007, no redundant compute]."""
    return L * math.log2(P) + 2 * gamma * m * G * (P - 1) / P


def best_allreduce(P, m, L, G, gamma=4):
    algos = {
        "tree": t_tree(P, m, L, G, gamma),
        "butterfly": t_butterfly(P, m, L, G, gamma),
        "ring": t_pipeline(P, m, L, G, gamma),
        "rabenseifner": t_rabenseifner(P, m, L, G, gamma),
    }
    return min(algos.items(), key=lambda kv: kv[1])


def t_parameter_server(P, m, L, G, gamma=4):
    """PS ≡ reduce-then-broadcast = T_tree (survey §6.2)."""
    return t_tree(P, m, L, G, gamma)


# ------------------------------------------- §5 parallelism comm volume/step
def dp_comm_bytes(n_params, gamma=4):
    """Data parallelism: one gradient allreduce per step (§5.1)."""
    return gamma * n_params


def tp_comm_bytes_fc(batch, d_in, d_out, layers, gamma=4):
    """Model parallelism on FC stacks: activations all-gathered per layer
    boundary (§5.2's all-to-all)."""
    return gamma * batch * (d_in + d_out) * layers


def hybrid_comm_bytes(n_conv_params, n_fc_params, batch, fc_act, gamma=4):
    """Krizhevsky hybrid (§5.4): allreduce conv grads + all-to-all FC acts."""
    return gamma * (n_conv_params + batch * fc_act)


def pipeline_bubble_fraction(stages, microbatches):
    """GPipe bubble: (S−1)/(S−1+M) idle fraction (§5.3 latency discussion)."""
    return (stages - 1) / (stages - 1 + microbatches)


# -------------------------------------------------------------- TPU roofline
@dataclass(frozen=True)
class HW:
    peak_flops: float = 197e12      # bf16 FLOP/s per chip (TPU v5e)
    hbm_bw: float = 819e9           # bytes/s per chip
    ici_bw: float = 50e9            # bytes/s per link
    hbm_bytes: float = 16 * 2**30   # 16 GiB


V5E = HW()

# One NVIDIA H100 SXM, for the port's card. The bf16 rate and HBM rate are
# the data sheet's dense figures that PERF.md's kernel bounds already use;
# NVLink 4 is 900 GB/s bidirectional a card (data sheet), 450e9 a
# direction; the memory is what torch.cuda.get_device_properties(0)
# .total_memory reports on the card (chip_smoke.py prints it).
H100 = HW(peak_flops=989e12,           # bf16 dense FLOP/s (data sheet)
          hbm_bw=3.35e12,              # bytes/s (data sheet, HBM3)
          ici_bw=450e9,                # NVLink bytes/s a direction
          hbm_bytes=85_017_493_504)    # total_memory on the card


def roofline_terms(hlo_flops, hlo_bytes, collective_bytes, chips, hw=V5E):
    """The three §Roofline terms, in seconds (global quantities in, /chips)."""
    return {
        "compute_s": hlo_flops / (chips * hw.peak_flops),
        "memory_s": hlo_bytes / (chips * hw.hbm_bw),
        "collective_s": collective_bytes / (chips * hw.ici_bw),
    }


def dominant_term(terms):
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])


def model_flops(n_params_active, tokens):
    """MODEL_FLOPS = 6·N·D (survey-era rule of thumb; N active for MoE)."""
    return 6.0 * n_params_active * tokens
