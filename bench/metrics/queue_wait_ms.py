"""Mean milliseconds from a request's arrival to its admission, over the
requests admitted in the window outside the traced steps (the engine's
``engine_untraced_queue_wait_seconds_total``: ``queue_wait_s`` over
``admitted``)."""
from bench import window


def read(cap):
    return window.per_ms(cap, "queue_wait_s", "admitted")
