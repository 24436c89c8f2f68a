"""B1, the paged decode kernel over whole contexts (``paged_decode_tc`` and
its merge, by kernel name): the bytes its calls in the traced steps need
(``bench.counts.paged_decode_bytes`` of each step's decoding slots, once a
layer) over the HBM peak, as a share of their device time."""
from bench import counts


def read(cap):
    n, s = cap.op_seconds("paged_decode_tc")
    r = cap.record
    m, e = r["model"], r["engine"]
    nbytes = sum(m["num_layers"] * counts.paged_decode_bytes(
        m, st["decode"], e["max_slots"], e["block_size"])
        for st in r["steps"] if st["traced"] and st["decode"])
    if not n or not s or not nbytes:
        return None
    return nbytes / counts.H100["hbm_bytes_per_s"] / s * 100
