"""Graceful-preemption guard: SIGTERM -> checkpoint + clean exit
(counterpart of ``centroids_reid_tpu/utils/preemption.py``).

- First signal: a flag is set; ``fit`` observes it at the next epoch
  boundary, saves a ring checkpoint for the finished epoch before any
  periodic validation (the grace window is for the save), skips the
  end-of-training double test, and returns with
  ``metrics["preempted"] = 1.0``. The multi-run loop
  (``engine/runner.run_main``) stops submitting further seeds.
- Second signal: the original disposition was restored when the first one
  fired, so a repeated SIGTERM terminates immediately.
- Several processes: ``should_stop`` is a collective (the flags' maximum),
  so a signal delivered to any process stops every process at the same
  epoch, none left waiting in the next epoch's collectives.

Gated by ``TPU.GRACEFUL_PREEMPTION`` (default on).
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

from ..parallel.mesh import any_process
from ..parallel.mesh import process_count as _process_count


class PreemptionGuard:
    """Context manager installing a one-shot graceful SIGTERM handler.

    Use as ``with PreemptionGuard(enabled=...) as guard:`` around the
    epoch loop; poll ``guard.should_stop()`` once per epoch. The handler
    is restored on exit, so sequential ``fit`` calls in one process
    (tests, multi-run loops) never leak dispositions.

    A signal handler can only be installed from the main thread; entered
    from another thread, the guard installs nothing and its flag stays
    False.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._flag = False
        self._previous: dict = {}

    # -- lifecycle --------------------------------------------------------
    def __enter__(self) -> "PreemptionGuard":
        if not self.enabled:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal would raise ValueError
        self._previous[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                       self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for s, old in self._previous.items():
            try:
                # only restore what we still own: _handle already restored
                # the original disposition for the signal that fired
                # (== not `is`: each self._handle access creates a fresh
                # bound-method object; bound methods compare by value)
                if signal.getsignal(s) == self._handle:
                    signal.signal(s, old)
            except (ValueError, TypeError):  # pragma: no cover
                pass
        self._previous.clear()

    def _handle(self, signum, frame) -> None:
        self._flag = True
        # escalate: a second delivery of the same signal acts immediately
        old = self._previous.get(signum)
        if old is not None:
            try:
                signal.signal(signum, old)
            except (ValueError, TypeError):  # pragma: no cover
                pass

    @property
    def signalled(self) -> bool:
        """This process's local flag (no collective)."""
        return self._flag

    def should_stop(self, process_count: Optional[int] = None) -> bool:
        """The stop decision, polled once per epoch. With more than one
        process (``process_count``, by default the process group's size)
        every enabled process must call it at the same point: an
        ``all_reduce(MAX)`` of the local flags, so a signal to any process
        stops them all. A process whose handler could not be installed
        (a worker thread) takes part with its flag False; only
        ``enabled=False``, the same everywhere, skips the collective. With
        one process, the local flag."""
        if not self.enabled:
            return False
        if process_count is None:
            process_count = _process_count()
        if process_count <= 1:
            return self._flag
        return any_process(self._flag)
