"""B6, the flash-attention forward kernel (``flash_fwd``, by kernel name):
the least time its calls in the traced steps could take
(``bench.counts.b6_call`` at the steps' batch and sequence: the larger of
causal FLOPs over the bfloat16 peak and bytes over the HBM peak) as a
share of their device time."""
from bench import counts


def read(cap):
    n, s = cap.op_seconds("flash_fwd")
    r = cap.record
    traced = [st for st in r["steps"] if st["traced"]]
    if not n or not s or not traced:
        return None
    m = r["model"]
    f, b = counts.b6_call(m, traced[0]["rows"], traced[0]["seq"],
                          counts.window(m))
    return n * counts.roofline_s(f, b) / s * 100
