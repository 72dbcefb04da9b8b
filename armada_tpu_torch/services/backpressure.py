"""Store backpressure: pause intake when the event store backs up.

Port of the reference's etcd health monitoring re-targeted at this repo's
store: the reference scrapes etcd's db-size-vs-quota fractions and marks
the cluster unhealthy past a configured fraction
(internal/common/etcdhealth/etcdhealth.go:36-44), and the executor wires
the monitor so pod creation pauses while unhealthy
(internal/executor/application.go:63-101). Here the store is the event
log plus its materialized views, so the signals are:

  - log disk footprint vs a capacity quota (storeCapacityBytes x
    storeFractionOfCapacityLimit — the db-size fraction analogue);
  - ingest lag of registered views (a store nobody can drain is backed
    up even if small).

When unhealthy: the submit service rejects new work (the reference's
submit-side shedding), and lease replies carry store_healthy=false so
executor agents pause creating pods for NEW leases until the store
recovers (unacked leases are simply re-sent — at-least-once).
"""

from __future__ import annotations

import os
import time


class StoreHealthMonitor:
    def __init__(
        self,
        log,
        capacity_bytes: int = 0,
        fraction_of_capacity_limit: float = 0.8,
        max_ingest_lag_events: int = 0,
        check_interval_s: float = 5.0,
    ):
        """capacity_bytes=0 disables the size signal;
        max_ingest_lag_events=0 disables the lag signal."""
        self.log = log
        self.capacity_bytes = capacity_bytes
        self.fraction_of_capacity_limit = fraction_of_capacity_limit
        self.max_ingest_lag_events = max_ingest_lag_events
        self.check_interval_s = check_interval_s
        self._lag_sources: list = []  # (name, () -> int)
        self._last_check = 0.0
        self._healthy = True
        self._reason = ""

    def add_lag_source(self, name: str, fn) -> None:
        self._lag_sources.append((name, fn))

    def _disk_bytes(self) -> int:
        directory = getattr(self.log, "dir", None)
        if directory is None:
            return 0  # in-memory log: no disk signal
        total = 0
        try:
            for entry in os.scandir(directory):
                if entry.is_file():
                    total += entry.stat().st_size
        except OSError:
            return 0
        return total

    def check(self, now: float | None = None) -> tuple[bool, str]:
        """(healthy, reason); recomputed at most every check_interval_s
        (the reference's scrapeInterval)."""
        now = time.time() if now is None else now
        if now - self._last_check < self.check_interval_s:
            return self._healthy, self._reason
        self._last_check = now
        if self.capacity_bytes > 0:
            used = self._disk_bytes()
            fraction = used / self.capacity_bytes
            if fraction > self.fraction_of_capacity_limit:
                self._healthy = False
                self._reason = (
                    f"storeSizeExceeded: log uses {used} bytes "
                    f"({fraction:.2f} of capacity {self.capacity_bytes}, "
                    f"limit {self.fraction_of_capacity_limit})"
                )
                return self._healthy, self._reason
        if self.max_ingest_lag_events > 0:
            for name, fn in self._lag_sources:
                lag = int(fn())
                if lag > self.max_ingest_lag_events:
                    self._healthy = False
                    self._reason = (
                        f"ingestLagExceeded: {name} is {lag} events behind "
                        f"(limit {self.max_ingest_lag_events})"
                    )
                    return self._healthy, self._reason
        self._healthy, self._reason = True, ""
        return True, ""

    def __call__(self) -> bool:
        return self.check()[0]


class CompositeGate:
    """Combine monitors exposing check() -> (healthy, reason); the first
    unhealthy one wins. Lets submit-side shedding consume store capacity
    AND round-deadline pressure through one gate."""

    def __init__(self, *monitors):
        self.monitors = [m for m in monitors if m is not None]

    def check(self) -> tuple[bool, str]:
        for monitor in self.monitors:
            healthy, reason = monitor.check()
            if not healthy:
                return False, reason
        return True, ""

    def __call__(self) -> bool:
        return self.check()[0]


class RoundDeadlinePressure:
    """Per-pool round-truncation backpressure.

    A round that hits the scheduling budget (maxSchedulingDuration) commits
    a partial placement and reports `round_truncated`; that is graceful
    degradation, not failure. But a pool truncating round after round is a
    sustained-overload signal: intake should shed before the backlog (and
    per-round latency) grows without bound. This tracker counts CONSECUTIVE
    truncated rounds per pool; at `threshold` the pool trips, and one full
    (untruncated) round clears it. A pool that stops running rounds
    entirely (its executors expired) decays after `stale_after_s` instead
    of holding the gate tripped forever. Same check()/__call__ surface as
    StoreHealthMonitor so it composes into the health multi-checker and
    submit-side shedding."""

    def __init__(self, threshold: int = 3, stale_after_s: float = 600.0):
        import threading

        self.threshold = max(1, int(threshold))
        self.stale_after_s = stale_after_s
        self._streaks: dict[str, tuple[int, float]] = {}  # pool -> (n, ts)
        # Written by the scheduler cycle thread, read from gRPC submit
        # and health worker threads.
        self._lock = threading.Lock()

    def note_round(
        self, pool: str, truncated: bool, now: float | None = None
    ) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            if truncated:
                n, _ = self._streaks.get(pool, (0, now))
                self._streaks[pool] = (n + 1, now)
            else:
                self._streaks.pop(pool, None)

    def streak(self, pool: str) -> int:
        with self._lock:
            return self._streaks.get(pool, (0, 0.0))[0]

    def tripped_pools(self, now: float | None = None) -> dict[str, int]:
        now = time.monotonic() if now is None else now
        with self._lock:
            stale = [
                pool
                for pool, (_, ts) in self._streaks.items()
                if now - ts > self.stale_after_s
            ]
            for pool in stale:
                # No rounds for a long time: the overload signal is gone
                # with the pool; a dead pool must not shed the whole
                # fleet's intake.
                self._streaks.pop(pool, None)
            return {
                pool: n
                for pool, (n, _) in self._streaks.items()
                if n >= self.threshold
            }

    def check(self, now: float | None = None) -> tuple[bool, str]:
        tripped = self.tripped_pools(now)
        if not tripped:
            return True, ""
        detail = ", ".join(
            f"{pool}: {n} consecutive truncated rounds"
            for pool, n in sorted(tripped.items())
        )
        return False, f"roundDeadlinePressure: {detail}"

    def __call__(self) -> bool:
        return self.check()[0]
