"""Model FLOPs of the window's training steps outside the trace
(``bench.counts.train_step_flops``: three times the forward, no
recomputation) over those steps' time, as a share of the card's bfloat16
peak."""
from bench import counts


def read(cap):
    r = cap.record
    f = sum(counts.train_step_flops(r["model"], st["rows"], st["seq"])
            for st in r["steps"] if not st["traced"])
    if not f or r["untraced_s"] <= 0:
        return None
    return f / r["untraced_s"] / counts.H100["bf16_flops"] * 100
