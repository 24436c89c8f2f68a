"""Mean milliseconds from a request's admission to the issue of its first
token (the prefill chunks it waits for and runs), over the requests whose
first token was issued in the window outside the traced steps (the
engine's ``engine_untraced_prefill_wait_seconds_total``:
``prefill_wait_s`` over ``first_tokens``)."""
from bench import window


def read(cap):
    return window.per_ms(cap, "prefill_wait_s", "first_tokens")
