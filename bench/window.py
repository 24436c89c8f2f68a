"""The window's share of the engine's counters: ``Engine.stats`` is taken
at the window's start and end (``capture.record["stats"]``), and a reader
divides the difference of one key by that of another. The engine counts
its spans' host seconds and its requests' waits only while no profiler
records, so these differences leave the traced steps out."""


def delta(cap, key):
    """window_end[key] - window_start[key], or None where the record, its
    counters or the key is missing."""
    stats = (cap.record or {}).get("stats") or {}
    start, end = stats.get("window_start"), stats.get("window_end")
    if not start or not end or key not in start or key not in end:
        return None
    return end[key] - start[key]


def per_ms(cap, seconds_key, count_key):
    """Milliseconds of `seconds_key` per `count_key` over the window; None
    where either is missing or nothing was counted."""
    s, n = delta(cap, seconds_key), delta(cap, count_key)
    if s is None or not n:
        return None
    return s / n * 1e3
