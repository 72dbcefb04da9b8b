"""Event-log -> jobdb materialization (the scheduler ingester).

The reference converts EventSequences into typed DbOperations applied to
Postgres (internal/scheduleringester/{instructions,dbops}.go,
~40 op types) which the scheduler then delta-polls into its in-memory jobDb
(scheduler.go:441 syncState). Single-process deployments here skip the SQL
hop: events apply straight to the JobDb inside one transaction, with the
same state-machine semantics. The cursor the caller tracks is the log
offset — identical recovery model (replay from cursor, at-least-once,
idempotent application).
"""

from __future__ import annotations

import re
from dataclasses import replace

from .. import events as ev
from .jobdb import Job, JobDb, JobRun, JobState, RunState

# Run states an executor-side lifecycle event may still act on. Events
# addressing a run OUTSIDE these states are stale echoes — typically a
# partitioned executor's report landing after _expire_stale_executors
# already failed the run and requeued the job — and must be dropped:
# applying them would resurrect a zombie run or hand one job two
# terminal outcomes (the split-brain model in docs/architecture.md).
# RPC fencing rejects such reports at the API for remote agents; this
# guard is the defense for in-process publishers and log replays.
_LIVE_RUN = (RunState.LEASED, RunState.PENDING, RunState.RUNNING)


def apply_entry(txn, entry, error_rules=()) -> None:
    seq: ev.EventSequence = entry.sequence
    for event in seq.events:
        _apply_event(txn, seq, event, error_rules)


def _apply_event(txn, seq: ev.EventSequence, event, error_rules=()) -> None:
    if isinstance(event, ev.SubmitJob):
        if txn.get(event.job.id) is not None:
            return  # idempotent replay
        txn.upsert(
            Job(
                spec=event.job,
                state=JobState.QUEUED,
                priority=event.job.priority,
                submitted=event.created,
            )
        )
        return

    if isinstance(event, ev.CancelJobSet):
        for job in txn.jobs_for_jobset(seq.queue, seq.jobset):
            if not job.state.terminal:
                txn.upsert(job.with_(state=JobState.CANCELLED))
        return

    job = txn.get(getattr(event, "job_id", ""))
    if job is None or job.state.terminal:
        return

    if isinstance(event, ev.CancelJob):
        txn.upsert(job.with_(state=JobState.CANCELLED))
    elif isinstance(event, ev.ReprioritiseJob):
        txn.upsert(job.with_(priority=event.priority))
    elif isinstance(event, ev.JobRunLeased):
        runs = job.runs
        prev = job.latest_run
        if prev is not None and prev.state in _LIVE_RUN:
            # A new lease supersedes a still-live attempt (a raced or
            # replayed history; normal flow fails the run before the
            # requeue). Close it out so no job ever holds two active
            # runs — the terminal outcome belongs to the NEW run.
            runs = runs[:-1] + (
                replace(
                    prev,
                    state=RunState.FAILED,
                    finished=event.created,
                ),
            )
        run = JobRun(
            id=event.run_id,
            job_id=job.id,
            executor=event.executor,
            node_id=event.node_id,
            pool=event.pool,
            scheduled_at_priority=event.scheduled_at_priority,
            state=RunState.LEASED,
            attempt=job.num_attempts,
            leased=event.created,
        )
        txn.upsert(job.with_(state=JobState.LEASED, runs=runs + (run,)))
    elif isinstance(event, ev.JobRunPending):
        run = job.latest_run
        if run and run.id == event.run_id and run.state == RunState.LEASED:
            run = replace(run, state=RunState.PENDING)
            txn.upsert(job.with_(state=JobState.PENDING, runs=job.runs[:-1] + (run,)))
    elif isinstance(event, ev.JobRunRunning):
        run = job.latest_run
        if run and run.id == event.run_id and run.state in _LIVE_RUN:
            run = replace(run, state=RunState.RUNNING, started=event.created)
            txn.upsert(job.with_(state=JobState.RUNNING, runs=job.runs[:-1] + (run,)))
    elif isinstance(event, ev.JobRunSucceeded):
        run = job.latest_run
        if run and run.id == event.run_id and run.state in _LIVE_RUN:
            run = replace(run, state=RunState.SUCCEEDED, finished=event.created)
            txn.upsert(job.with_(runs=job.runs[:-1] + (run,)))
    elif isinstance(event, ev.JobSucceeded):
        # Success is run-anchored: it lands only when the LATEST run
        # actually reported SUCCEEDED. A partitioned executor's stale
        # [JobRunSucceeded(run-old), JobSucceeded] batch drops its run
        # event (run-old is FAILED from the expiry) and this guard then
        # drops the job event too — whether the job is still QUEUED or
        # already re-leased to a new run. Exactly one terminal outcome,
        # decided by the scheduler's expiry.
        run = job.latest_run
        if run is not None and run.state == RunState.SUCCEEDED:
            txn.upsert(job.with_(state=JobState.SUCCEEDED))
    elif isinstance(event, ev.JobRunPreempted):
        run = job.latest_run
        if run and run.id == event.run_id and run.state in _LIVE_RUN:
            run = replace(run, state=RunState.PREEMPTED, finished=event.created)
            # requeue=True (drain orchestration): only the run dies; the
            # job goes back to QUEUED to reschedule elsewhere — same
            # job-level outcome as the JobRunErrors+JobRequeued expiry
            # path, but the run records a preemption with its reason.
            state = (
                JobState.QUEUED
                if getattr(event, "requeue", False)
                else JobState.PREEMPTED
            )
            txn.upsert(job.with_(state=state, runs=job.runs[:-1] + (run,)))
    elif isinstance(event, ev.JobRunErrors):
        run = job.latest_run
        if run and run.id == event.run_id and run.state in _LIVE_RUN:
            run = replace(
                run,
                state=RunState.FAILED,
                finished=event.created,
                retryable=bool(getattr(event, "retryable", True)),
            )
            failed_nodes = job.failed_nodes + ((run.node_id,) if run.node_id else ())
            txn.upsert(
                job.with_(runs=job.runs[:-1] + (run,), failed_nodes=failed_nodes,
                          error=event.error,
                          error_category=categorize_error(event.error, error_rules))
            )
    elif isinstance(event, ev.JobRequeued):
        txn.upsert(job.with_(state=JobState.QUEUED))
    elif isinstance(event, ev.JobErrors):
        txn.upsert(
            job.with_(
                state=JobState.FAILED,
                error=event.error,
                error_category=categorize_error(event.error, error_rules),
            )
        )


def categorize_error(error: str, rules) -> str:
    """First-match regex classification of a run error
    (internal/executor/categorizer/classifier.go)."""
    for pattern, category in rules or ():
        if re.search(pattern, error or ""):
            return category
    return "uncategorised" if error else ""


class SchedulerIngester:
    """Cursor-tracked consumer materializing the log into a JobDb."""

    def __init__(
        self,
        log,
        jobdb: JobDb,
        error_rules=(),
        settings_handler=None,
        transition_observer=None,
    ):
        self.log = log
        self.jobdb = jobdb
        self.error_rules = error_rules
        # Optional hook for control-plane settings events (executor cordon,
        # priority override): called for every event so the owner's
        # materialized settings stay current on the same cursor as the
        # jobdb — a standby catches up on its first post-failover sync.
        self.settings_handler = settings_handler
        # Optional hook (txn, event, sequence) called BEFORE each job
        # event applies: feeds state-transition metrics with
        # time-in-previous-state (metrics/state_metrics.go checkpoint
        # intervals) and the per-job journey ledger
        # (services/job_timeline.py) — the sequence carries the
        # publisher's trace context.
        self.transition_observer = transition_observer
        self.cursor = 0

    def sync(self, limit: int = 10_000) -> int:
        """Apply new log entries; returns number applied."""
        applied = 0
        while True:
            entries = self.log.read(self.cursor, limit)
            if not entries:
                return applied
            txn = self.jobdb.write_txn()
            try:
                for entry in entries:
                    if self.transition_observer is not None:
                        for event in entry.sequence.events:
                            self.transition_observer(
                                txn, event, entry.sequence
                            )
                    apply_entry(txn, entry, self.error_rules)
                    if self.settings_handler is not None:
                        for event in entry.sequence.events:
                            self.settings_handler(event)
                txn.commit()
            except Exception:
                txn.abort()
                raise
            self.cursor = entries[-1].offset + 1
            applied += len(entries)
