"""The durable event log: append-only, jobset-keyed, cursor-consumed.

Plays the role of Apache Pulsar in the reference (the single source of
truth; ingesters consume with failover subscriptions and at-least-once
delivery, internal/common/ingest/ingestion_pipeline.go:64). The interface is
transport-agnostic: InMemoryEventLog serves tests, the simulator and
single-process deployments; a partitioned/file-backed implementation can
slot in behind the same interface for multi-process deployments.

Consumption is cursor-based (monotonic sequence numbers), exactly like the
reference's serial columns: a consumer acks by advancing its cursor, and a
restarted consumer replays from its last cursor (at-least-once).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from .model import EventSequence


@dataclass(frozen=True)
class LogEntry:
    offset: int
    sequence: EventSequence


class EventLog:
    """Interface: append event sequences, read from a cursor."""

    def publish(self, sequence: EventSequence) -> int:
        raise NotImplementedError

    def read(self, cursor: int, limit: int = 1000) -> list[LogEntry]:
        raise NotImplementedError

    @property
    def end_offset(self) -> int:
        raise NotImplementedError

    @property
    def start_offset(self) -> int:
        """First readable offset (> 0 once a durable log is compacted)."""
        return 0

    def compact(self, up_to: int) -> int:
        """Drop history below `up_to` if the implementation supports it.
        Returns the number of storage units removed (0 = no-op)."""
        return 0


class InMemoryEventLog(EventLog):
    """Append-only in-process log, thread-safe; offsets are contiguous."""

    def __init__(self):
        self._entries: list[LogEntry] = []
        self._lock = threading.Lock()
        self._watchers: list[threading.Condition] = []

    def publish(self, sequence: EventSequence) -> int:
        with self._lock:
            offset = len(self._entries)
            self._entries.append(LogEntry(offset=offset, sequence=sequence))
        for cond in list(self._watchers):
            with cond:
                cond.notify_all()
        return offset

    def publish_many(self, sequences) -> int:
        last = -1
        for seq in sequences:
            last = self.publish(seq)
        return last

    def read(self, cursor: int, limit: int = 1000) -> list[LogEntry]:
        with self._lock:
            return self._entries[cursor : cursor + limit]

    def read_jobset(self, queue: str, jobset: str, cursor: int = 0) -> list[LogEntry]:
        """Per-jobset view (the event API's Redis-stream equivalent)."""
        with self._lock:
            return [
                e
                for e in self._entries[cursor:]
                if e.sequence.queue == queue and e.sequence.jobset == jobset
            ]

    @property
    def end_offset(self) -> int:
        with self._lock:
            return len(self._entries)

    def watcher(self) -> threading.Condition:
        cond = threading.Condition()
        self._watchers.append(cond)
        return cond

    def remove_watcher(self, cond: threading.Condition):
        try:
            self._watchers.remove(cond)
        except ValueError:
            pass


def from_reference_events(entries) -> list[LogEntry]:
    """The JAX package's log entries (`LogEntry` of its events.log, as
    its `read()` returns them) as the port's, field for field, for
    publishing into a port log: `log.publish_many(e.sequence for e in
    from_reference_events(ref_log.read(0, n)))` replays a reference
    deployment's history into the port."""
    from ..utils.carry import to_port

    return [to_port(e) for e in entries]
