"""Profiling hooks (counterpart of ``centroids_reid_tpu/utils/profiling.py``).

* ``profile_trace(log_dir)``: a ``torch.profiler`` trace of the enclosed
  work (host and, where there is a card, device), written as a Chrome /
  Perfetto trace to ``<log_dir>/traces/trace.json``; ``fit`` wires it to
  ``TPU.PROFILE``;
* ``annotate(name)``: a named range on that trace (``record_function``).
"""

from __future__ import annotations

import contextlib
import os

import torch


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


def annotate(name: str):
    """Named region on the profiler timeline."""
    return torch.profiler.record_function(name)
