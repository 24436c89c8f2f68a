"""Model FLOPs of every prompt and output token that the window's steps
outside the trace processed (``bench.counts.forward_flops``: the k routed
experts, attention at the pairs attended, the LM head for each emitted
token) over those steps' wall time, as a share of the card's bfloat16
peak. The traced steps are left out: the profiler slows their issue."""
from bench import counts


def step_flops(m, st) -> float:
    w = counts.window(m)
    rows = sum(n for _, n in st["prefill"]) + len(st["decode"])
    pairs = (sum(counts.pairs(a, n, w) for a, n in st["prefill"])
             + sum(min(k, w) if w else k for k in st["decode"]))
    return counts.forward_flops(m, rows, pairs, st["emitted"])


def read(cap):
    m = cap.record["model"]
    steps = [st for st in cap.record["steps"] if not st["traced"]]
    wall = sum(st["wall_s"] for st in steps)
    flops = sum(step_flops(m, st) for st in steps)
    if not flops or wall <= 0:
        return None
    return flops / wall / counts.H100["bf16_flops"] * 100
