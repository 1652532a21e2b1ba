"""The program's own spans and counters (``centroids_reid_tpu_torch.
utils.profiling``), read against a traced window's ``Trace``.

The program records a span (``annotate``) and a counter (``count``) only
while a profiler runs, and stamps spans on the Chrome trace's clock. The
evaluations read here are the roots named ``eval`` that overlap the
``Trace``'s own events, so the device-only window's evaluations are read
and the host-traced one's are not. A program without the record (an
older commit) reads as None, as does a trace without device events (the
CPU dry run) where a reader needs them."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple


def _profiling():
    try:
        from centroids_reid_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def counts() -> Dict[str, int]:
    p = _profiling()
    return p.counts() if p is not None else {}


def _window(trace) -> Optional[Tuple[float, float]]:
    """The first and last microsecond of the trace's events."""
    lo, hi = [], []
    for e in trace.device + trace.host:
        lo.append(e["ts"])
        hi.append(e["ts"] + e.get("dur", 0))
    for ts, _ in trace.launch.values():
        lo.append(ts)
        hi.append(ts)
    return (min(lo), max(hi)) if lo else None


def evaluations(obs) -> Optional[List[tuple]]:
    """[(root span, its direct children)] of each evaluation in the traced
    window of ``obs``, or None where there is none."""
    p, trace = _profiling(), obs.get("trace")
    if p is None or trace is None:
        return None
    win = _window(trace)
    if win is None:
        return None
    kept = p.spans()
    roots = [s for s in kept if s.name == "eval" and s.parent == -1
             and s.start < win[1] and s.end > win[0]]
    if not roots:
        return None
    kids = {r.index: [] for r in roots}
    for s in kept:
        if s.parent in kids:
            kids[s.parent].append(s)
    return [(r, kids[r.index]) for r in roots]


def span_ms(obs, name: str) -> Optional[float]:
    """Host milliseconds an evaluation spends in the spans ``name``."""
    evs = evaluations(obs)
    if not evs:
        return None
    us = sum(c.end - c.start for _, kids in evs for c in kids
             if c.name == name)
    return us / 1e3 / len(evs)


def launched_ms(obs, name: str) -> Optional[float]:
    """Device milliseconds an evaluation of the events whose launch (the
    runtime call of the same correlation id) lies inside a span ``name``."""
    evs, trace = evaluations(obs), obs.get("trace")
    if not evs or not trace.device:
        return None
    spans = sorted((c.start, c.end) for _, kids in evs for c in kids
                   if c.name == name)
    starts = [a for a, _ in spans]
    us = 0.0
    for e in trace.device:
        launch = trace.launch.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and launch[0] <= spans[i][1]:
            us += e["dur"]
    return us / 1e3 / len(evs)


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _minus(lo: float, hi: float, cut) -> List[Tuple[float, float]]:
    """[lo, hi] less the union of the intervals ``cut``."""
    out, at = [], lo
    for a, b in _union(cut):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def _covered(union, starts, a: float, b: float) -> float:
    """Microseconds of [a, b] that the sorted disjoint ``union`` covers."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(union) and union[i][0] < b:
        got += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
        i += 1
    return got


def idle_ms_in(obs, names) -> Optional[float]:
    """Device-idle milliseconds an evaluation that lie inside a child span
    named in ``names`` or in the root's own self time (the root less all
    its children)."""
    evs, trace = evaluations(obs), obs.get("trace")
    if not evs or not trace.device:
        return None
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in trace.device)
    starts = [a for a, _ in busy]
    us = 0.0
    for root, kids in evs:
        for a, b in _minus(root.start, root.end,
                           [(c.start, c.end) for c in kids
                            if c.name not in names]):
            us += (b - a) - _covered(busy, starts, a, b)
    return us / 1e3 / len(evs)
