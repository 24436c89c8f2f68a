"""Host milliseconds to issue one packed prefill call: the engine's
"engine/prefill" span (the model's Python and every launch, no
synchronize), per call, over the window's untraced steps, from the
engine's span counters."""
from bench import window


def read(cap):
    return window.per_ms(cap, "span_host_s.engine/prefill",
                         "span_calls.engine/prefill")
