"""Profiler ranges that cost next to nothing while no profiler records.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records (``torch.autograd._profiler_enabled()``), and a shared
no-op context manager otherwise: a range opened with no profiler running
still costs its ~13 µs of host time, the check about a hundredth of that.
So the port can label every layer boundary of its steps and leave the
labels in. ``spanned(name)`` runs a whole function inside such a range.

The port's ranges are named "<layer>/<part>", one prefix a layer:
``engine/*`` (``serving.engine``: step, schedule, prefill, decode, verify,
emit and the small device calls), ``serve/*`` (``serving.serve``),
``moe/*`` (``models.moe``: apply, experts, balance), ``remat/*``
(``core.parallelism.checkpoint``, which every checkpoint of the models
goes through: forward, recompute) and ``train/*``
(``train.trainer``: grads, optimizer). ``PREFIXES`` lists them, for
readers of a profile that must tell the ranges' device-side mirrors from
kernels. ``serving.telemetry`` re-exports `span` and adds host-time
counters to the engine's ranges (``Telemetry.span``).
"""
from __future__ import annotations

import functools

import torch

PREFIXES = ("engine/", "serve/", "moe/", "remat/", "train/")

recording = torch.autograd._profiler_enabled


class _NullSpan:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str):
    """A profiler range `name` while a profiler records, else a no-op."""
    if recording():
        return torch.profiler.record_function(name)
    return _NULL_SPAN


def spanned(name: str):
    """Decorator: the function runs inside the profiler range `name` while
    a profiler records, and is called as it is otherwise."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            if recording():
                with torch.profiler.record_function(name):
                    return fn(*args, **kw)
            return fn(*args, **kw)
        return run
    return wrap
