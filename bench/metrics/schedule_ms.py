"""Host milliseconds a step inside the engine's "engine/schedule" spans:
the host work before each device call (preemption, admission with its
table writes, block growth, the batches and their arrays), over the
window's untraced steps ("engine/step" calls), from the engine's span
counters."""
from bench import window


def read(cap):
    return window.per_ms(cap, "span_host_s.engine/schedule",
                         "span_calls.engine/step")
