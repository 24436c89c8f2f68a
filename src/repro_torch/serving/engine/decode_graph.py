"""The engine's decode call captured once as a CUDA graph and replayed.

The decode step (``engine._step_fns``' ``decode_fn``) always runs at the
same shapes, ``max_slots`` rows and a block table of width P, and reads
nothing back to the host: inactive slots are masked, the MoE's capacity
follows the row count, and the paged kernel's split count follows P. So
one capture holds every launch of the step, the hand-written paged
kernels' among them, and a replay issues them all at once, where the
model's Python would issue them one by one (~900 launches a step for a
16-layer MoE decoder).

A capture records what the step does to fixed storage: the static input
buffers (tokens, tables, seq_lens, active), the params, and the pools,
which the step updates in place. So a call copies its four inputs into
the static buffers and replays, and hands back copies of the outputs
(greedy, logits, the new seq_lens), because the next replay rewrites the
graph's own and the engine keeps earlier steps' token vectors as lazy
refs. The engine moves no params or pool leaf to new storage (its
defragment and resume write in place); a call that finds one moved
raises rather than replay over freed memory.

The capture warms the step up on the capture's own stream first, with
every slot inactive, so its writes land in the pools' scratch block; the
capture itself runs nothing. The kernel wrappers count the warm-ups' and
the capture's launches (``repro_torch.kernels.launch_counts``) as they
issue them; a replay runs none of their Python and counts nothing there
(the engine counts replays, ``decode_graph_replays``). While a profiler
records, a replay runs inside an operator's range (``REPLAY_RANGE``), so
that the profiler files the graph's kernels, by their own names, under
the span around the call.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.spans import recording
from repro_torch.tree import tree_leaves

# warm-up calls before the capture: the first brings up the libraries'
# handles and workspaces on the capture stream, the second runs as the
# capture will
WARMUP_CALLS = 2
# the profiler's name for a replay
REPLAY_RANGE = "decode_graph.replay"


def _storage(params, pool) -> tuple:
    return tuple(a.data_ptr() for a in tree_leaves(params)
                 + tree_leaves(pool))


class DecodeGraph:
    """``fn(params, pool, tokens, tables, seq_lens, active) -> (greedy,
    logits, seq_lens, pool)`` as one replayed graph. `like` holds the four
    inputs (their shapes, dtypes and device). `graph_cls` makes the graph
    (``torch.cuda.CUDAGraph`` by default; tests give a stand-in with its
    ``capture_begin`` / ``capture_end`` / ``replay``). `captures`, a
    registry counter, counts the capture."""

    def __init__(self, fn, like, *, captures, graph_cls=None):
        self.fn = fn
        self.graph_cls = graph_cls or torch.cuda.CUDAGraph
        self.captures = captures
        # every slot inactive: positions and lengths 0, every write to the
        # scratch block
        self.static = tuple(torch.zeros_like(t) for t in like)
        dev = self.static[0].device
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.graph = None
        self.outputs = None
        self.storage = None

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        return torch.cuda.stream(self.stream)

    def _rejoin(self):
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(
                self.stream)
            torch.cuda.synchronize(self.stream.device)

    def capture(self, params, pool) -> None:
        """Warm the step up and capture it over `params` and `pool`; what
        the step cannot capture raises here."""
        with self._on_stream():
            for _ in range(WARMUP_CALLS):
                self.fn(params, pool, *self.static)
        self._rejoin()
        with self._on_stream():
            graph = self.graph_cls()
            graph.capture_begin()
            try:
                outputs = self.fn(params, pool, *self.static)[:3]
            finally:
                graph.capture_end()
        self._rejoin()
        self.graph, self.outputs = graph, outputs
        self.storage = _storage(params, pool)
        self.captures.inc()

    def __call__(self, params, pool, tokens, tables, seq_lens, active):
        if _storage(params, pool) != self.storage:
            raise RuntimeError(
                "a params or pool leaf moved to new storage since the decode "
                "step was captured; the graph would replay over the old one")
        for dst, src in zip(self.static, (tokens, tables, seq_lens, active)):
            dst.copy_(src)
        if recording():
            # an operator's range, not a user's: the profiler ties the
            # kernels of the graph's launch to the operator around it (and
            # so to the span around that, "engine/decode"), and to no user
            # range
            with torch._C._profiler._RecordFunctionFast(REPLAY_RANGE):
                self.graph.replay()
        else:
            self.graph.replay()
        greedy, logits, lens = (t.clone() for t in self.outputs)
        return greedy, logits, lens, pool
