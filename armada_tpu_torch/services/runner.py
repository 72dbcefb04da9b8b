"""Scheduling runners: synchronous (in-cycle) and asynchronous (background).

The reference's runner seam (internal/scheduler/scheduling/runner/types.go:13,
async.go:33): the sync runner solves inside the cycle; the async runner
overlaps the solve with event I/O by scheduling against a snapshot in a
background thread (state machine Idle -> Running -> ResultReady), and the
cycle loop applies finished results on a later tick. Events derived from a
snapshot are safe to apply late: the ingester ignores transitions for jobs
that went terminal in between (at-least-once, idempotent application).
"""

from __future__ import annotations

import threading

IDLE, RUNNING, READY = "idle", "running", "ready"


class SyncRunner:
    """Solve inline; results available immediately (runner/sync.go)."""

    synchronous = True
    state = IDLE

    def submit(self, work) -> None:
        self._result = work()
        self.state = READY

    def poll(self):
        if self.state == READY:
            self.state = IDLE
            result, self._result = self._result, None
            return result
        return None

    @property
    def idle(self) -> bool:
        return self.state == IDLE


class AsyncRunner:
    """Background-thread solve (runner/async.go). One solve in flight at a
    time; the submitting cycle returns immediately and a later cycle picks
    up the result."""

    synchronous = False

    def __init__(self):
        self._lock = threading.Lock()
        self.state = IDLE
        self._result = None
        self._error: Exception | None = None

    def submit(self, work) -> None:
        with self._lock:
            if self.state != IDLE:
                return  # a solve is already in flight
            self.state = RUNNING

        def run():
            try:
                result = work()
                with self._lock:
                    self._result = result
                    self.state = READY
            except Exception as e:  # surfaced at the next poll
                with self._lock:
                    self._error = e
                    self.state = READY

        threading.Thread(target=run, daemon=True).start()

    def poll(self):
        """Finished result or None; re-raises a failed solve's error."""
        with self._lock:
            if self.state != READY:
                return None
            self.state = IDLE
            result, self._result = self._result, None
            error, self._error = self._error, None
        if error is not None:
            raise error
        return result

    def wait(self, timeout: float = 30.0) -> bool:
        """Test helper: block until the in-flight solve finishes."""
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self.state != RUNNING:
                    return True
            time.sleep(0.005)
        return False

    @property
    def idle(self) -> bool:
        with self._lock:
            return self.state == IDLE
