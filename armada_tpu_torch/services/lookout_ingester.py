"""Lookout ingester: an INDEPENDENT materialized view of the event log.

The reference runs three ingesters off the same Pulsar stream, one per
view (internal/lookoutingester/{ingester,instructions,
lookoutdb}.go): lookout's view is denormalized job/run rows for the UI,
materialized separately from the scheduler's jobdb so UI load never
contends with scheduling and the view can lag/catch up independently.
This ingester does the same against the shared log: its own cursor, its
own row store, and lag observability (common/ingest topic_delay_monitor).
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field

from .. import events as ev


@dataclass
class LookoutRun:
    run_id: str
    executor: str = ""
    node: str = ""
    pool: str = ""
    leased: float = 0.0
    started: float = 0.0
    finished: float = 0.0
    state: str = "leased"
    error: str = ""
    # Executor diagnostic dump (job_run.debug, getjobrundebugmessage.go).
    debug: str = ""
    # Why the scheduler ended this run (preemption reason — the
    # getjobrunschedulerterminationreason.go surface).
    termination_reason: str = ""


@dataclass
class LookoutRow:
    """Denormalized job row (lookoutdb insertion.go job/job_run tables)."""

    job_id: str
    queue: str
    jobset: str
    state: str = "queued"
    priority: int = 0
    priority_class: str = ""
    requests: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    submitted: float = 0.0
    last_transition: float = 0.0
    cancelled: float = 0.0
    error: str = ""
    error_category: str = ""
    runs: list = field(default_factory=list)

    @property
    def latest_run(self) -> LookoutRun | None:
        return self.runs[-1] if self.runs else None


class LookoutStore:
    """The lookout view: rows by job id + jobset/queue indexes, built by
    replaying the log. Thread-safe (UI reads while the ingester writes)."""

    def __init__(self, log, error_rules=(), checkpoint=None):
        self.log = log
        self.error_rules = error_rules
        self.rows: dict[str, LookoutRow] = {}
        self.run_to_job: dict[str, str] = {}  # run_id -> job_id
        self.cursor = 0
        self._lock = threading.Lock()
        if checkpoint is not None:
            # Bounded restart (services/checkpoint.py): seed rows, then
            # sync() replays only the suffix past the cursor.
            self.cursor, state = checkpoint
            self.rows.update(state["rows"])
            self.run_to_job.update(state["run_to_job"])
        self.cursor = max(self.cursor, log.start_offset)

    def checkpoint_state(self):
        with self._lock:
            # Rows are mutated in place by _apply: deep-copy so a
            # checkpoint written after more syncs doesn't see newer state
            # under an older cursor.
            return self.cursor, {
                "rows": copy.deepcopy(self.rows),
                "run_to_job": dict(self.run_to_job),
            }

    # ---- ingestion ----

    def sync(self, limit: int = 10_000) -> int:
        """Apply new log entries to the view; returns number applied."""
        applied = 0
        while True:
            entries = self.log.read(self.cursor, limit)
            if not entries:
                return applied
            with self._lock:
                for entry in entries:
                    for event in entry.sequence.events:
                        self._apply(entry.sequence, event)
                self.cursor = entries[-1].offset + 1
            applied += len(entries)

    @property
    def lag_events(self) -> int:
        """Events behind the log end (ingester lag metric)."""
        return max(0, self.log.end_offset - self.cursor)

    def _apply(self, seq, event):
        from ..jobdb.ingest import categorize_error

        if isinstance(event, ev.SubmitJob):
            if event.job.id in self.rows:
                return
            self.rows[event.job.id] = LookoutRow(
                job_id=event.job.id,
                queue=seq.queue,
                jobset=seq.jobset,
                priority=event.job.priority,
                priority_class=event.job.priority_class,
                requests=dict(event.job.requests),
                annotations=dict(event.job.annotations),
                submitted=event.created,
                last_transition=event.created,
            )
            return
        if isinstance(event, ev.CancelJobSet):
            for row in self.rows.values():
                if (
                    row.queue == seq.queue
                    and row.jobset == seq.jobset
                    and row.state
                    in ("queued", "leased", "pending", "running")
                ):
                    row.state = "cancelled"
                    row.cancelled = event.created
                    row.last_transition = event.created
            return
        row = self.rows.get(getattr(event, "job_id", ""))
        if row is None:
            return
        t = getattr(event, "created", 0.0)
        if isinstance(event, ev.CancelJob):
            row.state, row.cancelled, row.last_transition = "cancelled", t, t
        elif isinstance(event, ev.ReprioritiseJob):
            row.priority = event.priority
        elif isinstance(event, ev.JobRunLeased):
            row.state, row.last_transition = "leased", t
            row.runs.append(
                LookoutRun(
                    run_id=event.run_id,
                    executor=event.executor,
                    node=event.node_id,
                    pool=event.pool,
                    leased=t,
                )
            )
            self.run_to_job[event.run_id] = row.job_id
        elif isinstance(event, ev.JobRunPending):
            row.state, row.last_transition = "pending", t
            if row.latest_run:
                row.latest_run.state = "pending"
        elif isinstance(event, ev.JobRunRunning):
            row.state, row.last_transition = "running", t
            if row.latest_run:
                row.latest_run.state = "running"
                row.latest_run.started = t
        elif isinstance(event, ev.JobRunSucceeded):
            if row.latest_run:
                row.latest_run.state = "succeeded"
                row.latest_run.finished = t
        elif isinstance(event, ev.JobSucceeded):
            row.state, row.last_transition = "succeeded", t
        elif isinstance(event, ev.JobRunPreempted):
            row.state, row.last_transition = "preempted", t
            if row.latest_run:
                row.latest_run.state = "preempted"
                row.latest_run.finished = t
                row.latest_run.termination_reason = event.reason
        elif isinstance(event, ev.JobRunErrors):
            if row.latest_run:
                row.latest_run.state = "failed"
                row.latest_run.finished = t
                row.latest_run.error = event.error
                row.latest_run.debug = event.debug
            row.error = event.error
            row.error_category = categorize_error(event.error, self.error_rules)
        elif isinstance(event, ev.JobRequeued):
            row.state, row.last_transition = "queued", t
        elif isinstance(event, ev.JobErrors):
            row.state, row.last_transition = "failed", t
            row.error = event.error
            row.error_category = categorize_error(event.error, self.error_rules)

    # ---- reads (thread-safe snapshots) ----

    def all_rows(self) -> list[LookoutRow]:
        with self._lock:
            return list(self.rows.values())

    def get(self, job_id: str) -> LookoutRow | None:
        with self._lock:
            return self.rows.get(job_id)

    def materialize(self, rows, convert):
        """convert(row) for each row under the store lock: rows mutate in
        place under the ingester, so converters get internally consistent
        snapshots (queryapi page materialization)."""
        with self._lock:
            return [convert(r) for r in rows]

    def get_run(self, run_id: str) -> LookoutRun | None:
        """Run-level drilldown (job_run row by run_id)."""
        with self._lock:
            row = self.rows.get(self.run_to_job.get(run_id, ""))
            if row is None:
                return None
            for r in row.runs:
                if r.run_id == run_id:
                    return r
            return None

    def prune(self, older_than: float) -> int:
        """Drop terminal rows older than the retention window (the lookout
        pruner, internal/lookout/pruner)."""
        terminal = ("succeeded", "failed", "cancelled", "preempted")
        with self._lock:
            drop = [
                jid
                for jid, row in self.rows.items()
                if row.state in terminal and row.last_transition < older_than
            ]
            for jid in drop:
                for run in self.rows[jid].runs:
                    self.run_to_job.pop(run.run_id, None)
                del self.rows[jid]
        return len(drop)
