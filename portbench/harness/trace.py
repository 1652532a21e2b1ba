"""The traced window: ``torch.profiler`` over the card and the host, read
back from its Chrome trace.

Device time is that of kernels, copies and sets. ``busy_s`` is the union
of their intervals, ``window_s`` the host wall of the traced window, which
ends in a synchronize. The breakdown charges each idle gap to the host
range (an operator, an ``annotate`` range) that the thread which launched
the next device event was in, matched by correlation id. Readers get the
``Trace`` itself, so a later reader may match kernel names or ranges of
its own."""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Trace:
    """What one traced window left: device events, host ranges and the
    runtime calls that launched each device event."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and e.get("dur", 0) >= 0]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        self.launch = {}   # correlation id -> (ts, tid)
        for e in events:
            if (e.get("cat", "").startswith("cuda_")
                    and "correlation" in e.get("args", {})):
                self.launch[e["args"]["correlation"]] = (e["ts"], e["tid"])

    def busy_s(self) -> float:
        """Seconds in which some device event ran (interval union)."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        busy, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took most time, by name."""
        tot = defaultdict(float)
        for e in self.device:
            tot[e.get("name", "?")] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time by what the host was doing: each gap between
        device events goes to the shortest host range, on the thread that
        launched the next device event, that holds the gap's middle
        ("host outside any range" when none does); the ``n`` largest
        sums."""
        ev = sorted(self.device, key=lambda e: e["ts"])
        by_tid = defaultdict(list)
        for h in self.host:
            by_tid[h["tid"]].append((h["ts"], h["ts"] + h.get("dur", 0),
                                     h.get("name", "?")))
        starts = {}
        for tid, rs in by_tid.items():
            rs.sort()
            starts[tid] = [r[0] for r in rs]
        tot = defaultdict(float)
        end = None
        for e in ev:
            if end is not None and e["ts"] > end:
                tot[self._host_at((end + e["ts"]) / 2, e, by_tid,
                                  starts)] += (e["ts"] - end) / 1e6
            end = max(end or e["ts"], e["ts"] + e["dur"])
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t, device_event, by_tid, starts) -> str:
        """The innermost host range holding time ``t`` on the thread that
        launched ``device_event``: on one thread ranges nest, so it is the
        latest-starting one that has not ended by ``t``."""
        launch = self.launch.get(device_event.get("args", {}).get(
            "correlation"))
        if launch is None or launch[1] not in by_tid:
            return "host outside any range"
        rs = by_tid[launch[1]]
        i = bisect.bisect_right(starts[launch[1]], t) - 1
        for j in range(i, max(-1, i - 4096), -1):
            if rs[j][1] >= t:
                return rs[j][2]
        return "host outside any range"

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


class traced:
    """``with traced(scratch) as t: ...`` profiles the block (the card, and
    the host unless ``host`` is False: the host profiler's cost per
    operation would lengthen the window and inflate the idle share) and
    leaves ``t.trace`` (a ``Trace``) once the block has synchronized;
    the Chrome trace is written to ``scratch`` and deleted after reading."""

    def __init__(self, scratch: str, device: str = "cuda", host: bool = True):
        self.scratch = scratch
        self.device = device
        self.host = host
        self.trace: Optional[Trace] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self.host or self.device != "cuda" \
            else []
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if self.device == "cuda":
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        path = os.path.join(self.scratch, "trace.json")
        self._prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.trace = Trace(events, wall)
        return False
