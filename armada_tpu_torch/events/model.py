"""Event-sourced state transitions: the single source of truth.

Equivalent in information content to the reference's EventSequence protobuf
(pkg/armadaevents/events.proto:66-97): every job/run state
transition is an event in a durable, jobset-keyed log; the scheduler database,
the event API and the query views are all materializations of this log.
Python dataclasses here; the wire encoding (msgpack/proto) lives with the
transports that need it.
"""

from __future__ import annotations

import os as _os
import time as _time
from dataclasses import dataclass, field

from ..core.types import JobSpec

_B32 = "0123456789abcdefghjkmnpqrstvwxyz"


def _ulid() -> str:
    t = int(_time.time() * 1000) & ((1 << 48) - 1)
    v = (t << 80) | int.from_bytes(_os.urandom(10), "big")
    return "".join(_B32[(v >> (5 * i)) & 31] for i in range(25, -1, -1))


def new_id(prefix: str = "id") -> str:
    """Globally unique, time-ordered id (ULID: 48-bit ms timestamp +
    80-bit randomness), like the reference's util.NewULID
    (internal/common/util/ulid.go). A process-local
    counter would collide with replayed ids after a restart on the
    durable log (freshly issued ids repeating ones already in the log),
    making the ingester's idempotent-replay guard silently drop new
    submissions."""
    return f"{prefix}-{_ulid()}"


@dataclass(frozen=True)
class Event:
    """Base event; `created` is seconds since epoch (virtual time in sim)."""

    created: float = 0.0


@dataclass(frozen=True)
class SubmitJob(Event):
    job: JobSpec = None  # type: ignore[assignment]
    deduplication_id: str = ""


@dataclass(frozen=True)
class CancelJob(Event):
    job_id: str = ""
    reason: str = ""


@dataclass(frozen=True)
class CancelJobSet(Event):
    reason: str = ""


@dataclass(frozen=True)
class ReprioritiseJob(Event):
    job_id: str = ""
    priority: int = 0


@dataclass(frozen=True)
class JobRunLeased(Event):
    job_id: str = ""
    run_id: str = ""
    executor: str = ""
    node_id: str = ""
    pool: str = ""
    scheduled_at_priority: int = 0


@dataclass(frozen=True)
class JobRunPending(Event):
    """Pod created on the cluster, not yet running (lease acknowledged)."""

    job_id: str = ""
    run_id: str = ""


@dataclass(frozen=True)
class JobRunRunning(Event):
    job_id: str = ""
    run_id: str = ""


@dataclass(frozen=True)
class JobRunSucceeded(Event):
    job_id: str = ""
    run_id: str = ""


@dataclass(frozen=True)
class JobRunErrors(Event):
    job_id: str = ""
    run_id: str = ""
    error: str = ""
    retryable: bool = True
    # Executor-side diagnostic dump for the run (pod state / conditions /
    # container statuses) — the reference stores it compressed in the
    # lookout job_run.debug column (getjobrundebugmessage.go) for the UI's
    # debug drilldown, separate from the user-facing error.
    debug: str = ""


@dataclass(frozen=True)
class JobRunPreempted(Event):
    """The run was preempted. By default the JOB is terminal too (the
    reference's preemption semantics: the user resubmits). With
    `requeue=True` only the RUN dies and the job returns to QUEUED —
    the drain orchestrator's preempt-and-requeue path, where displaced
    work must reschedule elsewhere instead of failing
    (armada_tpu/whatif/drain.py)."""

    job_id: str = ""
    run_id: str = ""
    reason: str = ""
    requeue: bool = False


@dataclass(frozen=True)
class JobSucceeded(Event):
    job_id: str = ""


@dataclass(frozen=True)
class JobErrors(Event):
    job_id: str = ""
    error: str = ""


@dataclass(frozen=True)
class JobRequeued(Event):
    job_id: str = ""


@dataclass(frozen=True)
class QueueUpsert(Event):
    """Control-plane event: queue created/updated (the reference's
    controlplaneevents.Event, pkg/controlplaneevents/events.proto)."""

    name: str = ""
    priority_factor: float = 1.0
    cordoned: bool = False
    # Queue-level auth (pkg/client/queue permission model): owner names
    # and [{subjects: [...], verbs: [...]}] grants.
    owners: tuple = ()
    permissions: tuple = ()


@dataclass(frozen=True)
class QueueDelete(Event):
    name: str = ""


@dataclass(frozen=True)
class ExecutorCordon(Event):
    """Control-plane event: executor-level cordon toggled (the reference's
    executor settings upsert/delete, pkg/controlplaneevents/events.proto).
    Event-sourced so the setting survives control-plane restarts."""

    name: str = ""
    cordoned: bool = False


@dataclass(frozen=True)
class ExecutorFenced(Event):
    """Control-plane event: the scheduler reassigned an executor's runs
    (partition/outage expiry) and bumped its monotonic fencing token.
    Lease/report RPCs carrying an older token are rejected with
    FAILED_PRECONDITION until the executor completes an anti-entropy
    ExecutorSync — so a healed partition cannot resurrect zombie runs.
    Event-sourced so fences survive restarts and leader failover (a
    fence that reset to zero would re-admit stale reports).

    `synced=True` records the OTHER half of the lifecycle: the executor
    completed its ExecutorSync at this fence, clearing the advisory
    health breach. Also event-sourced, so a restarted scheduler's log
    replay does not resurrect 'awaiting post-fence sync' alarms for
    executors that healed long ago."""

    name: str = ""
    fence: int = 0
    synced: bool = False


@dataclass(frozen=True)
class PriorityOverride(Event):
    """Control-plane event: external queue priority override set/cleared
    (internal/scheduler/priorityoverride). cleared=True removes it."""

    queue: str = ""
    priority_factor: float = 0.0
    cleared: bool = False


@dataclass(frozen=True)
class FairnessPolicyChange(Event):
    """Control-plane event: a pool's fairness policy flipped (or was
    cleared back to the config default). `policy` is the canonical
    policy string (solver/policy.py spec_to_str); cleared=True removes
    the runtime override. Event-sourced so a restarted or failed-over
    scheduler solves the next round under the same objective."""

    pool: str = ""
    policy: str = ""
    cleared: bool = False


# Synthetic jobset key for control-plane (non-job) events: queue CRUD,
# executor settings, priority overrides.
CONTROL_PLANE_JOBSET = "__control-plane__"


@dataclass(frozen=True)
class EventSequence:
    """A batch of events for one (queue, jobset), the log's unit of
    publication (events.proto:66; jobset-keyed routing as in
    internal/common/pulsarutils/jobsetevents/)."""

    queue: str
    jobset: str
    events: tuple = ()
    user: str = ""
    # W3C trace context of the operation that produced this batch
    # (utils/tracing.py): submit RPCs stamp their server span here, the
    # scheduler continues the submitting trace onto lease events, and
    # executors echo it on run reports — so one trace id follows a job
    # across every process boundary. "" = untraced publisher.
    traceparent: str = ""
    # Idempotent-producer marker ("fd<shard>:<wal offset>") stamped by a
    # front-door shard ingester when it delivers a WAL entry into this
    # log (armada_tpu/frontdoor/partition.py). A restarted ingester scans
    # the suffix for its own markers to dedup redelivery — exactly-once
    # across crash/restart. "" for every direct publisher.
    ingest_marker: str = ""

    @staticmethod
    def of(queue: str, jobset: str, *events: Event, user: str = "",
           traceparent: str = "") -> "EventSequence":
        return EventSequence(queue=queue, jobset=jobset, events=tuple(events),
                             user=user, traceparent=traceparent)


def now() -> float:
    return _time.time()
