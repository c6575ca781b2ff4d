"""Spans at the port's layer boundaries, for torch.profiler.

`span(name)` is a context manager. While a profiler records on this process
it is `record_function("movslam." + name)`, so the span lands in the
profiler's trace on the clock of the device activity beside it; otherwise it
is one shared no-op context, which allocates nothing and creates no
RecordFunction. No setting turns the spans on: any torch.profiler session
that records host activity (ProfilerActivity.CPU) sees them. PERF.md §3 lists
the names and where each one sits.
"""
from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

PREFIX = "movslam."
_OFF = contextlib.nullcontext()


def span(name):
    """A span named PREFIX + name while a profiler is on, else a no-op."""
    if _profiler_enabled():
        return record_function(PREFIX + name)
    return _OFF
