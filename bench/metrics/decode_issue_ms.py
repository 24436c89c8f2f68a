"""Host milliseconds to issue one decode call: the engine's "engine/decode"
span, which holds the call from its arguments to its return (the model's
Python and every launch, no synchronize), per call, over the window's
untraced steps, from the engine's span counters."""
from bench import window


def read(cap):
    return window.per_ms(cap, "span_host_s.engine/decode",
                         "span_calls.engine/decode")
