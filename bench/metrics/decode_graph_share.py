"""Share of the window's decode steps that the engine replayed from its
captured CUDA graph (``decode_graph_replays`` over ``decode_steps`` in
``Engine.stats``); nothing where the engine keeps no such counter."""
from bench import window


def read(cap):
    replays, steps = (window.delta(cap, "decode_graph_replays"),
                      window.delta(cap, "decode_steps"))
    if replays is None or not steps:
        return None
    return replays / steps * 100
