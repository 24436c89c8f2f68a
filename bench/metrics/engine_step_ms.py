"""Host milliseconds of one ``Engine.step()`` call (scheduling, block
bookkeeping and issuing the step's device work), averaged over the
window's steps outside the trace, by the host clock."""


def read(cap):
    host = [st["host_s"] for st in cap.record["steps"] if not st["traced"]]
    return sum(host) / len(host) * 1e3 if host else None
