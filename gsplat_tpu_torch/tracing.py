"""Spans and counters inside the port.

``span(name)`` marks a layer's work.  With tracing off (the default) it
returns one shared no-op context: a flag test, no clock read, no
``record_function`` and no allocation.  With tracing on (``on()``) it opens
``torch.profiler.record_function("gsplat." + name)`` if a profiler is
recording, which then shows the span on its own clock beside the device's
operations, and keeps a record in memory: the name, the enclosing span of
the same thread, the current iteration and the start and end on
``time.perf_counter_ns``.  ``take()`` hands the records over and clears them.

``count(name, n)`` adds to a plain integer counter and is always on.  The
counters live in ``_kernels.launch_counts`` beside the kernels' launches, one
registry that ``counters()`` copies.  ``sync(n)`` is the span around a host
readback of ``n`` device values, counted in ``host_syncs``; copies from the
host that wait for the device's queue open a ``sync`` span alone.

Tracing is switched on by its caller (a benchmark's traced window, or
``Trainer.train``'s profiler window); no environment variable or flag turns
it on.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

from gsplat_tpu_torch import _kernels

PREFIX = "gsplat."

_on = False
_iteration = -1          # the Trainer's current iteration, for every thread
_records = []            # one dict a span, in the order spans opened
_local = threading.local()
# the autograd engine's thread opens spans too
_lock = threading.Lock()


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "fn", "stack")

    def __init__(self, name: str, iteration):
        global _iteration
        if iteration is not None:
            _iteration = iteration
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.rec = {"name": name, "parent": stack[-1] if stack else None,
                    "iter": _iteration, "thread": threading.get_ident(),
                    "start": 0, "end": None}
        # the range costs ~10 us a span, so it is opened only where a
        # profiler records to see it
        self.fn = (torch.profiler.record_function(PREFIX + name)
                   if torch.autograd._profiler_enabled() else _NULL)

    def __enter__(self):
        self.fn.__enter__()
        with _lock:
            self.stack.append(len(_records))
            _records.append(self.rec)
        self.rec["start"] = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.rec["end"] = time.perf_counter_ns()
        self.stack.pop()
        self.fn.__exit__(*exc)
        return False


def span(name: str, iteration: int = None):
    """The span ``name``; ``iteration`` (the Trainer's ``iter`` span) sets
    the iteration that this and later spans, on any thread, carry."""
    if not _on:
        return _NULL
    return _Span(name, iteration)


def count(name: str, n: int = 1):
    with _lock:
        c = _kernels.launch_counts
        c[name] = c.get(name, 0) + n


def sync(n: int = 1):
    """The span around a host readback of ``n`` device values, counted in
    ``host_syncs``."""
    count("host_syncs", n)
    return span("sync")


def on(enabled: bool = True) -> bool:
    """Turns tracing on (or off); returns whether it was on."""
    global _on
    was, _on = _on, bool(enabled)
    return was


def enabled() -> bool:
    return _on


def counters() -> dict:
    """A snapshot of every counter, the kernels' launches included."""
    with _lock:
        return dict(_kernels.launch_counts)


def take() -> dict:
    """``{"spans": records, "counters": counters()}``; clears the records.
    A record's ``parent`` is the index of its enclosing span's record in
    ``spans`` (None at a thread's outermost span)."""
    global _records
    with _lock:
        spans, _records = _records, []
    return {"spans": spans, "counters": counters()}
