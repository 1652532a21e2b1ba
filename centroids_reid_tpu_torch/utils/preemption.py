"""Graceful-preemption guard: SIGTERM -> checkpoint + clean exit
(counterpart of ``centroids_reid_tpu/utils/preemption.py``, one process).

- First signal: a flag is set; ``fit`` observes it at the next epoch
  boundary, saves a ring checkpoint for the finished epoch before any
  periodic validation (the grace window is for the save), skips the
  end-of-training double test, and returns with
  ``metrics["preempted"] = 1.0``. The multi-run loop
  (``engine/runner.run_main``) stops submitting further seeds.
- Second signal: the original disposition was restored when the first one
  fired, so a repeated SIGTERM terminates immediately.
- One process only: ``should_stop`` takes no collective (a stop decision
  across processes waits for multi-GPU, ROADMAP.md queue 1 item 6).

Gated by ``TPU.GRACEFUL_PREEMPTION`` (default on).
"""

from __future__ import annotations

import signal
import threading


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

    def should_stop(self) -> bool:
        """The stop decision, polled once per epoch (this process only)."""
        return self.enabled and self._flag
