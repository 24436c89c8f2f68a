"""Serving telemetry: metrics registry, request-lifecycle tracing and
recompile tracking for the continuous-batching engine.

Ported from ``repro.serving.telemetry`` without JAX: ``abstract_signature``
flattens dicts, lists and tuples of tensors itself, and ``span`` opens a
``torch.profiler.record_function`` range where the reference opened a
``jax.profiler.TraceAnnotation``, but only while a profiler records
(``repro_torch.spans``); with no profiler it counts the span's calls and
host seconds instead. PyTorch compiles nothing per shape, so
``RecompileTracker`` counts the distinct argument signatures each step
function was called with (the set a CUDA-graph capture per bucket would
have to cover).

This module is the one place the serving signals live (time-to-first-token,
queue wait, per-step host/device time, step-call signatures); the engine
and block pool publish into it instead of keeping ad-hoc ``stats`` dicts.
Two exporters read it: a JSON Lines event log (``Telemetry.export_jsonl``,
parsed back into timelines by ``replay_jsonl``) and a Prometheus text
snapshot (``MetricsRegistry.prometheus_text``).

Three pieces, composable but independently usable:

  * ``MetricsRegistry`` — named ``Counter`` / ``Gauge`` / ``Histogram``
    metrics. Histograms answer arbitrary quantiles from a bounded-memory
    streaming sketch (exact until the buffer first compacts, rank error
    ~1/cap after).
  * ``RequestTracer`` — append-only event log of per-request lifecycle
    events (``arrive``/``admit``/``prefix_hit``/``prefill_chunk``/
    ``first_token``/``decode_token``/``evict``/``defrag``/``finish``) with
    monotonic ``time.perf_counter`` timestamps, so TTFT, queue wait, and
    per-phase latency are *derived* (``derive_timeline``) rather than
    guessed. ``first_token`` and ``decode_token`` are issue stamps: the
    host's time when it queued the step that computes the token, before
    the device has run it; a client receives the value later.
  * ``RecompileTracker`` — wraps the engine's step functions and counts unique
    (function, arg shapes/dtypes) signatures: the number of distinct step
    variants a serving run dispatched (``unique`` per function, ``total``
    over all), the set a graph capture per bucket would have to cover.

``Telemetry`` bundles the three behind one ``enabled`` switch
(``EngineConfig.telemetry``): when disabled every record call is a cheap
early return, no events are stored, and engine outputs are unchanged —
telemetry never touches device code, only host bookkeeping around it.
Its ``span`` labels the engine's layer boundaries: a profiler range while
a profiler records, else two counters a span name
(``engine_span_<name>_calls_total`` and
``engine_span_<name>_host_seconds_total``), which therefore hold the
untraced steps alone (``span_totals``).

Metric naming scheme (the reference's engine README, Telemetry section):
``<subsystem>_<quantity>_<unit>`` with ``_total`` for counters and
``_seconds`` for duration histograms, e.g. ``engine_decode_steps_total``,
``engine_request_ttft_seconds``, ``pool_evictions_total``.
"""
from __future__ import annotations

import json
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.spans import _NULL_SPAN, recording, span  # noqa: F401

# Canonical request-lifecycle event names, in lifecycle order. ``evict`` and
# ``defrag`` are pool-wide events recorded with ``rid=None``. ``preempt`` /
# ``resume`` bracket an oversubscription rollback: the victim's state is
# evicted and it re-enters the prefill phase on resume, so the rank machine
# in ``validate_order`` resets at each ``resume``. ``verify`` is the
# speculative-decoding acceptance record (drafted/accepted counts); it ranks
# WITH ``decode_token`` — each verify step emits both, in either order.
EVENTS = ("arrive", "admit", "prefix_hit", "prefill_chunk", "first_token",
          "verify", "decode_token", "preempt", "resume", "evict", "defrag",
          "finish")

_LIFECYCLE_RANK = {"arrive": 0, "admit": 1, "resume": 1, "prefix_hit": 2,
                   "prefill_chunk": 3, "first_token": 4, "verify": 5,
                   "decode_token": 5, "preempt": 6, "finish": 7}
_ONCE = ("arrive", "admit", "first_token", "finish")


class TelemetryError(ValueError):
    """Metric registration conflict or event-stream invariant violation."""


# ---------------------------------------------------------------- metrics
class Counter:
    """Monotonically non-decreasing value (int or float increments)."""
    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise TelemetryError(f"counter {self.name!r}: negative inc {n}")
        self.value += n


class Gauge:
    """Instantaneous value: ``set`` to a level or ``add`` a delta."""
    kind = "gauge"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def add(self, d) -> None:
        self.value += d


class Histogram:
    """Streaming-quantile histogram with bounded memory.

    Weighted samples accumulate in a buffer; when it reaches ``2*cap`` it is
    sorted and adjacent pairs merge (weighted-mean value, summed weight),
    halving it back to ``cap``. Until the first compaction, ``quantile`` is
    EXACT — identical to ``np.percentile(data, q)`` (linear interpolation) —
    and afterwards the rank error is bounded by the largest merged weight
    over the total count (~1/cap per compaction generation).
    ``count``/``sum``/``min``/``max`` are exact always.
    """
    kind = "histogram"

    def __init__(self, name: str, help: str = "", cap: int = 4096):
        if cap < 2:
            raise TelemetryError(f"histogram {name!r}: cap must be >= 2")
        self.name, self.help, self.cap = name, help, int(cap)
        self._v: list = []
        self._w: list = []
        self._dirty = False
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x) -> None:
        x = float(x)
        self._v.append(x)
        self._w.append(1.0)
        self._dirty = True
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if len(self._v) >= 2 * self.cap:
            self._compact()

    def _sort(self):
        v, w = np.asarray(self._v), np.asarray(self._w)
        if self._dirty:
            o = np.argsort(v, kind="stable")
            v, w = v[o], w[o]
            self._v, self._w = v.tolist(), w.tolist()
            self._dirty = False
        return v, w

    def _compact(self) -> None:
        v, w = self._sort()
        tail = len(v) % 2
        if tail:                        # odd buffer: largest sample rides along
            v_last, w_last = float(v[-1]), float(w[-1])
            v, w = v[:-1], w[:-1]
        wp = w[0::2] + w[1::2]
        vp = (v[0::2] * w[0::2] + v[1::2] * w[1::2]) / wp
        self._v, self._w = vp.tolist(), wp.tolist()
        if tail:
            self._v.append(v_last)
            self._w.append(w_last)

    def quantile(self, q) -> float:
        """The q-th percentile (q in [0, 100]) of everything observed."""
        if not 0 <= q <= 100:
            raise TelemetryError(f"quantile {q} outside [0, 100]")
        if self.count == 0:
            return math.nan
        v, w = self._sort()
        if len(v) == 1:
            return float(v[0])
        # sample i sits at rank position C_{i-1} + (w_i - 1)/2; with unit
        # weights that is exactly i, so np.interp below reproduces
        # np.percentile's linear interpolation bit for bit.
        c = np.cumsum(w)
        pos = c - 1.0 - (w - 1.0) / 2.0
        t = (c[-1] - 1.0) * (q / 100.0)
        return float(np.interp(t, pos, v))

    def quantiles(self, qs=(50, 99)) -> dict:
        return {q: self.quantile(q) for q in qs}


class MetricsRegistry:
    """Get-or-create registry of named metrics; one per serving stack so the
    engine, scheduler, and block pool export through a single snapshot."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TelemetryError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", cap: int = 4096) -> Histogram:
        return self._get(Histogram, name, help, cap=cap)

    def get(self, name: str):
        return self._metrics[name]

    def names(self) -> list:
        return list(self._metrics)

    def snapshot(self) -> dict:
        """Plain-python view: scalars for counters/gauges, summary dicts for
        histograms."""
        out = {}
        for name, m in self._metrics.items():
            if m.kind == "histogram":
                out[name] = {"count": m.count, "sum": m.sum,
                             "min": m.min, "max": m.max,
                             "p50": m.quantile(50), "p99": m.quantile(99)}
            else:
                out[name] = m.value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text-format snapshot. Histograms are exported as
        summaries (quantile-labelled samples + ``_sum``/``_count``)."""
        lines = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if m.kind == "histogram":
                lines.append(f"# TYPE {name} summary")
                if m.count:
                    for q in (0.5, 0.9, 0.99):
                        lines.append(
                            f'{name}{{quantile="{q}"}} {m.quantile(q * 100)}')
                lines.append(f"{name}_sum {m.sum}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"# TYPE {name} {m.kind}")
                lines.append(f"{name} {m.value}")
        return "\n".join(lines) + "\n"


# ----------------------------------------------------------------- tracing
class Event(NamedTuple):
    t: float                    # monotonic seconds (time.perf_counter)
    rid: Optional[int]          # None for pool-wide events (evict/defrag)
    name: str
    data: Optional[dict]


class RequestTracer:
    """Append-only lifecycle event log, indexed globally and per request."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.events: list = []
        self._by_rid: dict = {}

    def record(self, rid, name: str, **data) -> float:
        t = self.clock()
        ev = Event(t, rid, name, data or None)
        self.events.append(ev)
        if rid is not None:
            self._by_rid.setdefault(rid, []).append(ev)
        return t

    def request_events(self, rid) -> list:
        return list(self._by_rid.get(rid, ()))

    def request_ids(self) -> list:
        return list(self._by_rid)

    def first(self, rid, name: str) -> Optional[float]:
        for ev in self._by_rid.get(rid, ()):
            if ev.name == name:
                return ev.t
        return None


def derive_timeline(events) -> dict:
    """Fold one request's event stream into its derived timeline: TTFT =
    ``first_token - arrive``, queue wait = ``admit - arrive``, end-to-end =
    ``finish - arrive``, the per-token decode timeline, and the preemption
    view — ``preempts`` (rollback count) and ``preempted_s`` (total time
    spent evicted, summed over matched preempt→resume pairs; a stream that
    ends while still evicted contributes its open interval up to the last
    event's timestamp). Speculative decoding: a ``decode_token`` event may
    carry ``tokens=n`` (the accepted run of one verify step) — the decode
    timeline counts every ACCEPTED token, n entries at that timestamp, so
    TPOT statistics stay per-token rather than per-engine-step; drafted /
    accepted totals are summed from the ``verify`` events."""
    tl = {"events": list(events), "arrive": None, "admit": None,
          "first_token": None, "finish": None, "prefill_chunks": 0,
          "decode_tokens": [], "prefix_hit_tokens": 0,
          "preempts": 0, "preempted_s": 0.0,
          "draft_tokens": 0, "accepted_tokens": 0}
    pend = None                        # open preempt awaiting its resume
    for ev in events:
        if ev.name in _ONCE and tl[ev.name] is None:
            tl[ev.name] = ev.t
        elif ev.name == "prefill_chunk":
            tl["prefill_chunks"] += 1
        elif ev.name == "decode_token":
            tl["decode_tokens"].extend(
                [ev.t] * (ev.data or {}).get("tokens", 1))
        elif ev.name == "verify":
            tl["draft_tokens"] += (ev.data or {}).get("drafted", 0)
            tl["accepted_tokens"] += (ev.data or {}).get("accepted", 0)
        elif ev.name == "prefix_hit":
            # cumulative over resumes: a rollback's re-admission usually
            # re-aliases the blocks registered at preemption
            tl["prefix_hit_tokens"] += (ev.data or {}).get("tokens", 0)
        elif ev.name == "preempt":
            tl["preempts"] += 1
            pend = ev.t
        elif ev.name == "resume":
            if pend is not None:
                tl["preempted_s"] += ev.t - pend
                pend = None
    if pend is not None and events:
        tl["preempted_s"] += events[-1].t - pend
    for key, a, b in (("queue_wait", "arrive", "admit"),
                      ("ttft", "arrive", "first_token"),
                      ("e2e", "arrive", "finish")):
        tl[key] = (tl[b] - tl[a]
                   if tl[a] is not None and tl[b] is not None else None)
    return tl


def validate_order(events) -> None:
    """Assert one request's lifecycle invariants: timestamps never regress,
    arrive ≤ admit ≤ (prefix_hit | prefill_chunk)* ≤ first_token ≤
    decode_token* ≤ finish, and the one-shot events occur at most once.

    Preemption segments the stream: ``preempt`` is legal any time after
    ``admit``, nothing but ``resume`` may follow it (the request is evicted
    — though a stream may END evicted), and ``resume`` resets the rank
    floor so the request re-runs prefix_hit / prefill_chunk / decode_token
    phases; ``resume`` without an open ``preempt`` is an error. One-shot
    events stay globally one-shot across segments (``first_token`` fires in
    whichever segment first completes prefill). Raises ``TelemetryError``
    with the offending pair."""
    if not events:
        raise TelemetryError("empty event stream")
    names = [e.name for e in events]
    for n in _ONCE:
        if names.count(n) > 1:
            raise TelemetryError(f"duplicate {n!r} event")
    if names[0] != "arrive":
        raise TelemetryError(f"stream starts with {names[0]!r}, not 'arrive'")
    if "finish" in names and names[-1] != "finish":
        raise TelemetryError("events recorded after 'finish'")
    floor = _LIFECYCLE_RANK["arrive"]
    evicted = False
    prev = events[0]
    for ev in events[1:]:
        if ev.t < prev.t:
            raise TelemetryError(
                f"timestamp regression: {prev.name}@{prev.t} -> "
                f"{ev.name}@{ev.t}")
        rank = _LIFECYCLE_RANK.get(ev.name)
        if rank is None:
            raise TelemetryError(f"unknown lifecycle event {ev.name!r}")
        if evicted:
            if ev.name != "resume":
                raise TelemetryError(
                    f"{ev.name!r} recorded while evicted (preempt without "
                    f"resume)")
            evicted = False
            floor = rank                       # segment restart: rank resets
        elif ev.name == "resume":
            raise TelemetryError("'resume' without a preceding 'preempt'")
        elif ev.name == "preempt":
            if floor < _LIFECYCLE_RANK["admit"]:
                raise TelemetryError("'preempt' before 'admit'")
            evicted = True
            floor = rank
        else:
            if rank < floor:
                raise TelemetryError(
                    f"lifecycle order violated: {prev.name!r} before "
                    f"{ev.name!r}")
            floor = rank
        prev = ev


# -------------------------------------------------------- recompile tracking
def abstract_signature(args) -> tuple:
    """Hashable key of a step call's arguments: container structure +
    per-leaf (shape, dtype). Leaves are tensors, numpy arrays or Python
    scalars; dicts, lists and tuples are walked in order."""
    if isinstance(args, dict):
        return ("dict",) + tuple((k, abstract_signature(v))
                                 for k, v in args.items())
    if isinstance(args, (list, tuple)):
        return (type(args).__name__,) + tuple(abstract_signature(a)
                                              for a in args)
    if isinstance(args, torch.Tensor):
        return (tuple(args.shape), str(args.dtype))
    return (np.shape(args), np.result_type(args).name)


class RecompileTracker:
    """Wrap step functions; count unique (function, signature) pairs.

    The count is the number of distinct compiled step variants this serving
    run dispatched — the metric AOT-compiled prefill buckets must hold at
    "known set, counted up front, zero at serving time".
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.seen: dict = {}            # fn name -> set of trace keys
        reg = registry if registry is not None else MetricsRegistry()
        self._counter = reg.counter(
            "engine_compiled_variants_total",
            "distinct (step fn, arg shapes/dtypes) trace keys dispatched")

    def wrap(self, name: str, fn):
        seen = self.seen.setdefault(name, set())
        counter = self._counter

        def tracked(*args):
            key = abstract_signature(args)
            if key not in seen:
                seen.add(key)
                counter.inc()
            return fn(*args)

        tracked.__name__ = f"tracked_{name}"
        tracked.__wrapped__ = fn
        return tracked

    def unique(self, name: str) -> int:
        """Distinct signatures `name` was called with."""
        return len(self.seen.get(name, ()))

    def variants(self) -> dict:
        return {name: len(keys) for name, keys in self.seen.items()}

    @property
    def total(self) -> int:
        """Distinct (function, signature) pairs over every wrapped step."""
        return sum(len(keys) for keys in self.seen.values())


# ----------------------------------------------------------------- bundle
class _TimedSpan:
    """Adds one call and the host seconds from enter to exit to a span's
    two counters."""
    __slots__ = ("calls", "seconds", "t0")

    def __init__(self, calls: Counter, seconds: Counter):
        self.calls, self.seconds = calls, seconds

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *a):
        self.seconds.inc(time.perf_counter() - self.t0)
        self.calls.inc()
        return False


class Telemetry:
    """One serving stack's telemetry: registry + tracer + recompile tracker
    + engine-step timeline, behind a single ``enabled`` switch.

    ``step_timing`` additionally blocks on device results inside the engine's
    timed path so each step's host/device split is real compute time, not
    async dispatch (mirrors serving_bench's latency pass); it is off by
    default because blocking serializes the host-ahead pipeline.
    """

    def __init__(self, enabled: bool = True, step_timing: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = bool(enabled)
        self.step_timing = bool(step_timing) and self.enabled
        self.clock = clock
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = RequestTracer(clock=clock)
        self.recompiles = RecompileTracker(self.registry)
        self.steps: list = []           # per-step dicts (step_timing only)
        self._h_host = self.registry.histogram(
            "engine_step_host_seconds",
            "per-step host scheduling time (step_timing runs only)")
        self._h_dev = self.registry.histogram(
            "engine_step_device_seconds",
            "per-step blocked device time (step_timing runs only)")
        self._spans: dict = {}          # span name -> (calls, seconds)

    # -- recording (no-ops when disabled) --------------------------------
    def record(self, rid, event: str, **data) -> Optional[float]:
        if not self.enabled:
            return None
        return self.tracer.record(rid, event, **data)

    def span(self, name: str):
        """While a profiler records, the `torch.profiler.record_function`
        range `name`, so traces are labeled per phase; otherwise a context
        that adds one call and its host seconds to the span's counters. A
        no-op context manager when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        if recording():
            return span(name)
        return _TimedSpan(*self.span_counters(name))

    def span_counters(self, name: str) -> tuple:
        """(calls, host seconds) counters of span `name`, registered as
        ``engine_span_<name>_calls_total`` and
        ``engine_span_<name>_host_seconds_total`` ("/" in the name as
        "_")."""
        counters = self._spans.get(name)
        if counters is None:
            slug = name.replace("/", "_")
            counters = self._spans[name] = (
                self.registry.counter(
                    f"engine_span_{slug}_calls_total",
                    f"{name} spans closed with no profiler recording"),
                self.registry.counter(
                    f"engine_span_{slug}_host_seconds_total",
                    f"host seconds inside {name} spans with no profiler "
                    f"recording"))
        return counters

    def span_totals(self) -> dict:
        """{span name: (calls, host seconds)} of every span counted."""
        return {name: (c.value, s.value)
                for name, (c, s) in self._spans.items()}

    def record_step(self, *, host_s: float, device_s: float, **data) -> None:
        if not self.step_timing:
            return
        self._h_host.observe(host_s)
        self._h_dev.observe(device_s)
        self.steps.append({"step": len(self.steps), "host_s": host_s,
                           "device_s": device_s, **data})

    # -- views -----------------------------------------------------------
    def request_timeline(self, rid) -> dict:
        return derive_timeline(self.tracer.request_events(rid))

    # -- exporters -------------------------------------------------------
    def export_jsonl(self, path) -> int:
        """Write the event log as JSON Lines (one event per line). Returns
        the number of events written. ``replay_jsonl`` parses it back into
        per-request timelines."""
        with open(path, "w") as f:
            for ev in self.tracer.events:
                row = {"t": ev.t, "rid": ev.rid, "event": ev.name}
                if ev.data:
                    row["data"] = ev.data
                f.write(json.dumps(row) + "\n")
        return len(self.tracer.events)

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()


def replay_jsonl(path) -> dict:
    """Parse a JSONL trace back into ``{rid: derived timeline}`` — the same
    TTFT / queue-wait / decode-timeline view a live ``Telemetry`` computes,
    so traces from a serving run can be analyzed offline."""
    by_rid: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            rid = row.get("rid")
            if rid is None:
                continue
            by_rid.setdefault(rid, []).append(
                Event(row["t"], rid, row["event"], row.get("data")))
    return {rid: derive_timeline(sorted(evs, key=lambda e: e.t))
            for rid, evs in by_rid.items()}
