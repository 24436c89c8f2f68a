"""Host milliseconds a step inside the engine's "engine/emit" spans: the
bookkeeping of what each device call produced (token records, finished
requests, lifecycle records, gauges), over the window's untraced steps
("engine/step" calls), from the engine's span counters."""
from bench import window


def read(cap):
    return window.per_ms(cap, "span_host_s.engine/emit",
                         "span_calls.engine/step")
