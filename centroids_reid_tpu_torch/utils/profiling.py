"""Profiling hooks (counterpart of ``centroids_reid_tpu/utils/profiling.py``).

* ``profile_trace(log_dir)``: a ``torch.profiler`` trace of the enclosed
  work (host and, where there is a card, device), written as a Chrome /
  Perfetto trace to ``<log_dir>/traces/trace.json``; ``fit`` wires it to
  ``TPU.PROFILE``;
* ``annotate(name)``: a span. The switch is a running ``torch.profiler``
  (``TPU.PROFILE``, a benchmark's traced window): with none running it is
  one shared null context, a flag check and nothing else; under one it is
  a ``record_function`` range (a ``user_annotation`` in the trace) and is
  also kept in an in-memory record of at most ``MAX_SPANS`` spans, the
  oldest dropped. A profiler that traces the card alone keeps no host
  range, so the record is where such a window's spans are read;
* ``count(name, n)``: adds ``n`` to a counter while a profiler runs;
* ``spans()``, ``counts()`` and ``reset()`` read and clear the record;
* ``step_marker(name, step)``: a range named with the step number.

A span's ``start`` and ``end`` are on the clock of the profiler's Chrome
trace: microseconds since the Unix epoch less the trace's
``baseTimeNanoseconds``, the epoch time floored to a whole number of
``TRACE_BASE_S`` seconds (``torch/profiler/_chrome_trace_export.py``).
A reader places a device event's launch (its runtime event, matched by
correlation id) or an idle gap of the card inside the span the host was
in.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 65_536
TRACE_BASE_S = 7_889_238   # the Chrome trace's time base, epoch seconds
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(log_dir, "traces")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class Span(NamedTuple):
    """One recorded span: ``parent`` is the ``index`` of the span that
    held it on the same thread (-1 for a root); ``start`` and ``end`` are
    Chrome-trace microseconds."""

    index: int
    name: str
    parent: int
    start: float
    end: float


class _Record:
    """The spans (``[index, name, parent, start_ns, end_ns]``, end None
    while open) and counters recorded under a running profiler."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.spans = collections.deque(maxlen=MAX_SPANS)
            self.next = 0
            self.counts = collections.Counter()

    def open(self, name: str) -> list:
        stack = self.local.__dict__.setdefault("stack", [])
        with self.lock:
            slot = [self.next, name, stack[-1][0] if stack else -1, 0, None]
            self.next += 1
            self.spans.append(slot)
        stack.append(slot)
        slot[3] = time.time_ns()
        return slot

    def close(self, slot: list) -> None:
        slot[4] = time.time_ns()
        stack = self.local.stack
        if stack and stack[-1] is slot:
            stack.pop()


_RECORD = _Record()


class _Span:
    __slots__ = ("name", "_range", "_slot")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._slot = _RECORD.open(self.name)
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        _RECORD.close(self._slot)
        return False


def annotate(name: str):
    """A span named ``name``: recorded under a running profiler, free
    otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        with _RECORD.lock:
            _RECORD.counts[name] += int(n)


def _trace_us(ns: int) -> float:
    base = ns // 1_000_000_000 // TRACE_BASE_S * TRACE_BASE_S
    return (ns - base * 1_000_000_000) / 1e3


def spans() -> List[Span]:
    """The closed spans kept, oldest first."""
    with _RECORD.lock:
        kept = [list(s) for s in _RECORD.spans if s[4] is not None]
    return [Span(i, n, p, _trace_us(a), _trace_us(b))
            for i, n, p, a, b in kept]


def counts() -> Dict[str, int]:
    with _RECORD.lock:
        return dict(_RECORD.counts)


def reset() -> None:
    """Drops every recorded span and counter."""
    _RECORD.clear()


def step_marker(name: str, step: int):
    """A range on the profiler timeline named ``<name>#<step>``."""
    return torch.profiler.record_function(f"{name}#{step}")
