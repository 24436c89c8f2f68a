"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` over a
fixed number of the window's steps, a synchronize at each end, reduced to
what the per-layer metrics read.

  * device operations (kernels, copies, sets) by name: count and seconds;
  * busy seconds: the union of their intervals on the device timeline;
  * spans: for each named ``record_function`` range on the host (the
    program's "engine/prefill", "engine/decode", the benchmark's
    "bench/optimizer"), how many ran and the device seconds of the
    operations launched inside them;
  * the breakdown the result line carries: the device operations that took
    most time, and the idle gaps between them summed by what the host was
    doing at each gap's middle.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

TOP = 10
LABELLED_GAPS = 2000


@dataclass
class Capture:
    window_s: float
    busy_s: float
    ops: dict                      # name -> [count, seconds]
    spans: dict                    # name -> [count, device seconds]
    breakdown: dict
    # what the run did, raw, for the readers: the configuration, the mix,
    # a record of every step of the window, times and counters
    record: dict = field(default_factory=dict)

    def op_seconds(self, *needles) -> tuple:
        """(count, seconds) of the device operations whose name holds any
        of `needles`."""
        n = s = 0
        for name, (c, t) in self.ops.items():
            if any(x in name for x in needles):
                n, s = n + c, s + t
        return n, s


def traced(fn):
    """(profile, window seconds, fn's result) of fn run under the profiler,
    between two synchronizes."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window = time.perf_counter() - t0
    return prof, window, out


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def summarize(prof, window_s: float, span_names) -> Capture:
    events = prof.events()
    span_names = set(span_names)
    host = [e for e in events if not _is_device(e) and not e.is_async]
    notes = {e.name for e in host if getattr(e, "is_user_annotation", False)}
    notes |= span_names
    spans = {n: [0, 0.0] for n in span_names}
    for e in host:
        if e.name in span_names:
            spans[e.name][0] += 1
            spans[e.name][1] += e.device_time_total / 1e6
    dev = [e for e in events if _is_device(e) and e.name not in notes
           and not getattr(e, "is_user_annotation", False)]
    ops: dict = {}
    for e in dev:
        c = ops.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += (e.time_range.end - e.time_range.start) / 1e6
    # the union of the device intervals, and the gaps between them
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, t in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, (s + cur_e) / 2))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    breakdown = {"device_ops": [[k, v[1]] for k, v in top_ops],
                 "idle_gaps": _label_gaps(host, gaps, notes)}
    return Capture(window_s=window_s, busy_s=busy / 1e6, ops=ops,
                   spans=spans, breakdown=breakdown)


def _label_gaps(host, gaps, notes) -> list:
    """The longest gaps (µs, middle µs), summed by what the host was doing
    at each middle: the innermost host operation there, under the
    innermost named range that holds it."""
    gaps = sorted(gaps, reverse=True)[:LABELLED_GAPS]
    mids = sorted((m, i) for i, (_, m) in enumerate(gaps))
    keys = [m for m, _ in mids]
    op = [None] * len(gaps)
    note = [None] * len(gaps)
    for e in host:
        a, b = e.time_range.start, e.time_range.end
        lo, hi = bisect.bisect_left(keys, a), bisect.bisect_right(keys, b)
        for j in range(lo, hi):
            i = mids[j][1]
            slot = note if e.name in notes else op
            if slot[i] is None or (b - a) < slot[i][1]:
                slot[i] = (e.name, b - a)
    out: dict = {}
    for i, (length, _) in enumerate(gaps):
        what = op[i][0] if op[i] else "host outside any operation"
        if note[i]:
            what = f"{note[i][0]} > {what}"
        out[what] = out.get(what, 0.0) + length / 1e6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            ][:TOP]
