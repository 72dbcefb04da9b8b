"""Per-job lifecycle timeline: the job-journey ledger.

Answers "why is my job pending and where did its time go" for ONE job
end-to-end — the reference covers this with OTel traces plus per-round
scheduling reports, but our `services/reports.py` keeps only the most
recent round's `job_reasons` and discards the history every cycle. This
store accumulates, per job, every state transition (fed from the
scheduler ingester's transition observer) and every round it was
reported unschedulable (fed from `RoundReport.job_reasons`), bounded in
both directions:

  - per job: transitions capped at `max_entries`; unschedulable rounds
    are AGGREGATED per reason (count + first/last timestamp) instead of
    stored per round, so a job pending for 10k rounds costs a handful
    of reason buckets, not 10k entries;
  - across jobs: at most `max_jobs` journeys, oldest evicted first
    (terminal journeys preferred), so a million-job control plane pays
    a bounded ledger, like the reports repository's retained_jobs cap.

The journey also records the job's W3C trace context (the submit
EventSequence's `traceparent`), which is how the scheduler continues
the submitting client's trace onto lease events and executors echo it
on run reports (utils/tracing.py). Queryable through the gRPC
`JobTrace` method, `GET /api/jobtrace/<id>` on lookout, and the
`armadactl job-trace <id>` CLI verb.
"""

from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..utils.tracing import parse_traceparent


@dataclass
class ReasonAgg:
    """One unschedulable reason's bounded aggregate for a job."""

    count: int = 0
    first_ts: float = 0.0
    last_ts: float = 0.0
    pools: set = field(default_factory=set)


@dataclass
class JobJourney:
    job_id: str
    queue: str = ""
    jobset: str = ""
    traceparent: str = ""  # the submit batch's W3C context
    submitted: float = 0.0
    # None until the first lease: simulator time starts at 0.0, so a
    # falsy-zero check would misclassify a first-cycle lease as
    # never-leased and let requeue churn multi-count the lease metrics.
    leased: float | None = None
    entries: list = field(default_factory=list)  # (ts, kind, detail)
    reasons: dict = field(default_factory=OrderedDict)  # reason -> ReasonAgg
    rounds_unschedulable: int = 0
    terminal: bool = False

    @property
    def trace_id(self) -> str:
        parsed = parse_traceparent(self.traceparent)
        return parsed[0] if parsed else ""


def _fmt_ts(ts: float) -> str:
    """Epoch seconds render as wall clock; small values are virtual sim
    time and render as an offset."""
    if ts >= 1e9:
        return _time.strftime("%H:%M:%S", _time.localtime(ts))
    return f"t+{ts:.0f}s"


class JobTimelineStore:
    """Thread-safe bounded ledger: written by the scheduler/ingester
    thread, read by gRPC/HTTP worker threads."""

    def __init__(self, max_jobs: int = 100_000, max_entries: int = 64,
                 max_reasons: int = 32):
        self.max_jobs = max_jobs
        self.max_entries = max_entries
        self.max_reasons = max_reasons
        self._jobs: OrderedDict[str, JobJourney] = OrderedDict()
        # O(1) eviction candidates, preference order: finished journeys
        # first, then jobs that at least reached a lease — so under a
        # >max_jobs live backlog the LONG-PENDING journeys (the ones
        # job-trace exists to explain) are the last to go. Every removal
        # cleans both indexes, so each stays a subset of _jobs (bounded).
        self._terminal: OrderedDict[str, None] = OrderedDict()
        self._leased: OrderedDict[str, None] = OrderedDict()
        self._lock = threading.Lock()

    # ---- writes ------------------------------------------------------

    def _journey(self, job_id: str) -> JobJourney:
        j = self._jobs.get(job_id)
        if j is None:
            j = JobJourney(job_id=job_id)
            self._jobs[job_id] = j
            self._evict()
        return j

    def _evict(self) -> None:
        if len(self._jobs) <= self.max_jobs:
            return
        if self._terminal:
            victim, _ = self._terminal.popitem(last=False)
        elif self._leased:
            victim, _ = self._leased.popitem(last=False)
        else:
            # Everything is live and pending: drop the NEWEST journey
            # (the one just inserted, with the least history) — under a
            # full-of-pending ledger the longest-pending records are
            # exactly the ones job-trace exists to explain, so new jobs
            # go untracked until terminal evictions free space.
            victim, _ = self._jobs.popitem(last=True)
        self._jobs.pop(victim, None)
        self._terminal.pop(victim, None)
        self._leased.pop(victim, None)

    def _append(self, j: JobJourney, ts: float, kind: str, detail: str = ""):
        if len(j.entries) < self.max_entries:
            j.entries.append((ts, kind, detail))
        else:
            # Full ledger: overwrite the last slot so the terminal entry
            # is always visible even on pathological churn.
            j.entries[-1] = (ts, kind, detail)

    def observe_event(self, event, sequence=None) -> None:
        """Record one ingested job event (called from the scheduler's
        transition observer, BEFORE the event applies to the jobdb)."""
        from ..events import (
            CancelJob,
            JobErrors,
            JobRequeued,
            JobRunErrors,
            JobRunLeased,
            JobRunPending,
            JobRunPreempted,
            JobRunRunning,
            JobSucceeded,
            SubmitJob,
        )

        created = float(getattr(event, "created", 0.0) or 0.0)
        tp = getattr(sequence, "traceparent", "") if sequence is not None else ""
        with self._lock:
            if isinstance(event, SubmitJob):
                if event.job is None:
                    return
                j = self._journey(event.job.id)
                j.queue = event.job.queue or (
                    sequence.queue if sequence is not None else ""
                )
                j.jobset = event.job.jobset or (
                    sequence.jobset if sequence is not None else ""
                )
                j.submitted = created
                if tp:
                    j.traceparent = tp
                self._append(j, created, "submitted")
                return
            job_id = getattr(event, "job_id", "")
            if not job_id:
                return
            if isinstance(event, JobRunLeased):
                j = self._journey(job_id)
                j.leased = created
                if job_id in self._jobs:
                    self._leased[job_id] = None
                self._append(
                    j, created, "leased",
                    f"{event.node_id} on {event.executor} (pool {event.pool})",
                )
            elif isinstance(event, JobRunPending):
                self._append(self._journey(job_id), created, "pending")
            elif isinstance(event, JobRunRunning):
                self._append(self._journey(job_id), created, "running")
            elif isinstance(event, JobRunPreempted):
                # Every preemption must carry its attribution (aggressor
                # queue/gang + mechanism, or drain/reconciliation): an
                # empty reason records as "unknown", which the chaos-sim
                # tier-1 test asserts never happens for any producer.
                self._append(
                    self._journey(job_id), created, "preempted",
                    event.reason or "unknown",
                )
            elif isinstance(event, JobRunErrors):
                self._append(
                    self._journey(job_id), created, "run-failed", event.error
                )
            elif isinstance(event, JobRequeued):
                self._append(self._journey(job_id), created, "requeued")
            elif isinstance(event, JobSucceeded):
                self._finish(job_id, created, "succeeded")
            elif isinstance(event, JobErrors):
                self._finish(job_id, created, "failed", event.error)
            elif isinstance(event, CancelJob):
                self._finish(job_id, created, "cancelled", event.reason)

    def _finish(self, job_id: str, created: float, kind: str,
                detail: str = "") -> None:
        j = self._journey(job_id)
        j.terminal = True
        if job_id in self._jobs:
            self._terminal[job_id] = None
        self._append(j, created, kind, detail)

    def note_round_reasons(self, pool: str, now: float,
                           job_reasons: dict) -> dict:
        """Fold one round's per-job unschedulable reasons into the
        per-job aggregates; returns reason -> count totals for the
        round (what `scheduler_unschedulable_reason_total` observes)."""
        totals: dict[str, int] = {}
        with self._lock:
            for job_id, reason in job_reasons.items():
                totals[reason] = totals.get(reason, 0) + 1
                j = self._journey(job_id)
                j.rounds_unschedulable += 1
                agg = j.reasons.get(reason)
                if agg is None:
                    if len(j.reasons) >= self.max_reasons:
                        continue  # reason vocabulary cap; count still ticks
                    agg = j.reasons[reason] = ReasonAgg(first_ts=now)
                agg.count += 1
                agg.last_ts = now
                agg.pools.add(pool)
        return totals

    def note_solver_failover(self, job_ids, now: float, detail: str) -> None:
        """Stamp a round's solver-failover attribution onto every job it
        leased: the journey then explains that the placement came from a
        fallback rung (`armadactl job-trace`), not the primary solve."""
        with self._lock:
            for job_id in job_ids:
                self._append(self._journey(job_id), now, "solver-failover",
                             detail)

    # ---- reads -------------------------------------------------------

    def rounds_unschedulable(self, job_id: str) -> int:
        with self._lock:
            j = self._jobs.get(job_id)
            return j.rounds_unschedulable if j is not None else 0

    def traceparent(self, job_id: str) -> str:
        with self._lock:
            j = self._jobs.get(job_id)
            return j.traceparent if j is not None else ""

    def traceparents(self, job_ids) -> dict:
        """job_id -> traceparent ("" when unknown), one lock acquisition
        for the whole batch — the lease-reply and lease-sequence builders
        annotate thousands of jobs per round through this."""
        with self._lock:
            jobs = self._jobs
            return {
                jid: (jobs[jid].traceparent if jid in jobs else "")
                for jid in job_ids
            }

    def has_leased(self, job_id: str) -> bool:
        """True once a lease was ever recorded for the job — the
        queue-wait/rounds-to-schedule metrics observe only the FIRST
        lease, so preemption/requeue churn cannot multi-count a job."""
        with self._lock:
            j = self._jobs.get(job_id)
            return j is not None and j.leased is not None

    def get(self, job_id: str) -> dict | None:
        """JSON-able journey for the query surfaces."""
        with self._lock:
            j = self._jobs.get(job_id)
            if j is None:
                return None
            return {
                "job_id": j.job_id,
                "queue": j.queue,
                "jobset": j.jobset,
                "trace_id": j.trace_id,
                "traceparent": j.traceparent,
                "submitted": j.submitted,
                "leased": j.leased if j.leased is not None else 0.0,
                "rounds_unschedulable": j.rounds_unschedulable,
                "reasons": {
                    reason: {
                        "count": agg.count,
                        "first_ts": agg.first_ts,
                        "last_ts": agg.last_ts,
                        "pools": sorted(agg.pools),
                    }
                    for reason, agg in j.reasons.items()
                },
                "entries": [
                    {"ts": ts, "kind": kind, "detail": detail}
                    for ts, kind, detail in j.entries
                ],
            }

    def render(self, job_id: str, doc: dict | None = None) -> str:
        """The human journey: one line per transition, unschedulable
        history folded into per-reason aggregate lines placed at their
        first occurrence. Callers that already hold get()'s doc pass it
        in (one ledger lock and one doc build per request, and no
        get/render race against a concurrent eviction)."""
        if doc is None:
            doc = self.get(job_id)
        if doc is None:
            return f"no journey recorded for job {job_id}"
        head = f"job {doc['job_id']}"
        if doc["queue"]:
            head += f" · queue {doc['queue']}"
        if doc["jobset"]:
            head += f" · jobset {doc['jobset']}"
        if doc["trace_id"]:
            head += f" · trace {doc['trace_id']}"
        lines: list[tuple[float, str]] = []
        for e in doc["entries"]:
            detail = f" {e['detail']}" if e["detail"] else ""
            lines.append(
                (e["ts"], f"{e['kind']} {_fmt_ts(e['ts'])}{detail}")
            )
        if doc["rounds_unschedulable"]:
            parts = [
                f"{reason} ×{agg['count']}"
                for reason, agg in doc["reasons"].items()
            ]
            first = min(
                (a["first_ts"] for a in doc["reasons"].values()),
                default=doc["submitted"],
            )
            last = max(
                (a["last_ts"] for a in doc["reasons"].values()), default=first
            )
            lines.append(
                (
                    # Epsilon past the first occurrence: sorts after the
                    # transition that was recorded at the same instant.
                    first + 1e-9,
                    f"{doc['rounds_unschedulable']} rounds unschedulable "
                    f"({_fmt_ts(first)}–{_fmt_ts(last)}): " + ", ".join(parts),
                )
            )
        lines.sort(key=lambda kv: kv[0])
        return "\n".join([head] + [f"  {text}" for _, text in lines])
