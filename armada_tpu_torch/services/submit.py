"""Submission API: validate, default, deduplicate, publish.

The in-process equivalent of the reference's submit server
(internal/server/submit/submit.go): SubmitJobs validates and
defaults each job, deduplicates by (queue, deduplication_id), converts to
SubmitJob events and publishes them to the event log; cancel/reprioritise
publish the corresponding jobset events. gRPC/REST transport wraps this
object in services/grpc_api.py.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

from ..core.config import SchedulingConfig
from ..core.types import JobSpec, QueueSpec
from ..events import (
    CancelJob,
    CancelJobSet,
    EventSequence,
    QueueDelete,
    QueueUpsert,
    ReprioritiseJob,
    SubmitJob,
)
from ..events.model import new_id

# Jobset key under which control-plane (queue CRUD) events are logged,
# mirroring the reference's separate controlPlaneEvents topic.
from ..events.model import CONTROL_PLANE_JOBSET  # noqa: F401 (re-export)


class SubmissionError(ValueError):
    pass


@dataclass
class Queue:
    """Control-plane queue record (pkg/client queue API). Owners and
    permission grants feed the transport's Authorizer
    (services/auth.py; permissions.go + queue permission subjects)."""

    spec: QueueSpec
    cordoned: bool = False
    labels: dict = field(default_factory=dict)
    owners: tuple = ()
    permissions: tuple = ()  # of auth.QueuePermission


class SubmitService:
    def __init__(self, config: SchedulingConfig, log, scheduler=None,
                 checkpoint=None, store_health=None, frontdoor=None,
                 slo=None):
        if frontdoor is not None:
            raise NotImplementedError(
                "the front door waits for the server slice (ROADMAP A7.9)"
            )
        if slo is not None:
            raise NotImplementedError(
                "the SLO tracker waits for the server slice (ROADMAP A7.9)"
            )
        self.config = config
        self.log = log
        self.scheduler = scheduler  # optional: queue updates pushed through
        # Optional SLO tracker (services/slo.py): submit() feeds the
        # frontdoor_submit_seconds signal — wall clock through admission
        # + the durable ack — at the ONE enforcement point every
        # transport funnels through, so gRPC and in-process submits
        # measure identically.
        self.slo = slo
        # Optional backpressure gate (services/backpressure.py): callable
        # -> (healthy, reason); submissions are shed while the store is
        # backed up (the reference rejects work on etcd capacity).
        self.store_health = store_health
        # Optional front door (armada_tpu/frontdoor): job submissions
        # route through per-tenant admission and a jobset-keyed shard WAL
        # (the ack point) instead of publishing straight to the log; the
        # shard ingesters deliver into the log exactly-once. Queue CRUD
        # and cancel/reprioritise stay on the direct path (control-plane
        # volume, not flood surface). When set, the front door's
        # admission owns backpressure shedding (it wraps the same gate),
        # so the raw store_health check above is skipped.
        self.frontdoor = frontdoor
        self.queues: dict[str, Queue] = {}
        self._dedup: dict[tuple, str] = {}  # (queue, dedup_id) -> job_id
        self._cursor = 0  # log offset the view reflects
        if checkpoint is not None:
            # Bounded restart (services/checkpoint.py): seed the registry
            # and dedup index, replay only the suffix.
            self._cursor, state = checkpoint
            self._dedup.update(state["dedup"])
            for queue in state["queues"].values():
                self.queues[queue.spec.name] = queue
                if self.scheduler is not None:
                    self.scheduler.upsert_queue(
                        queue.spec, cordoned=queue.cordoned
                    )
        self._replay()

    def checkpoint_state(self):
        return self._cursor, {
            "queues": dict(self.queues),
            "dedup": dict(self._dedup),
        }

    def _replay(self):
        """Rebuild queue registry and dedup index from the (durable) log —
        the control-plane materialized view (queues in Postgres + dedup
        table in the reference). Starts at the checkpoint cursor (or the
        log's compaction point) and remembers where it stopped; calling it
        again consumes the new suffix (idempotent re-application: local
        mutations were already applied at publish time), which advances
        the checkpoint cursor and, in file-lease HA, picks up queue events
        published by the other replica."""
        self._cursor = max(self._cursor, self.log.start_offset)
        entries = self.log.read(self._cursor, 10**9)
        if entries:
            self._cursor = entries[-1].offset + 1
        for entry in entries:
            for event in entry.sequence.events:
                if isinstance(event, QueueUpsert):
                    from .auth import QueuePermission

                    spec = QueueSpec(event.name, event.priority_factor)
                    perms = tuple(
                        QueuePermission(tuple(p["subjects"]), tuple(p["verbs"]))
                        if isinstance(p, dict)
                        else p
                        for p in getattr(event, "permissions", ())
                    )
                    self.queues[event.name] = Queue(
                        spec=spec,
                        cordoned=event.cordoned,
                        owners=tuple(getattr(event, "owners", ())),
                        permissions=perms,
                    )
                    if self.scheduler is not None:
                        self.scheduler.upsert_queue(spec, cordoned=event.cordoned)
                elif isinstance(event, QueueDelete):
                    self.queues.pop(event.name, None)
                elif isinstance(event, SubmitJob) and event.deduplication_id:
                    self._dedup[
                        (entry.sequence.queue, event.deduplication_id)
                    ] = event.job.id

    def sync(self):
        """Consume the log suffix (see _replay)."""
        self._replay()

    def _publish_queue_event(self, event):
        self.log.publish(EventSequence.of("", CONTROL_PLANE_JOBSET, event))

    # ---- queue CRUD (internal/server/queue) ----

    def create_queue(
        self,
        spec: QueueSpec,
        cordoned: bool = False,
        owners: tuple = (),
        permissions: tuple = (),
    ) -> Queue:
        if spec.name in self.queues:
            raise SubmissionError(f"queue {spec.name!r} already exists")
        q = Queue(
            spec=spec, cordoned=cordoned, owners=tuple(owners),
            permissions=tuple(permissions),
        )
        self.queues[spec.name] = q
        self._publish_queue_event(
            QueueUpsert(
                created=_time.time(),
                name=spec.name,
                priority_factor=spec.priority_factor,
                cordoned=cordoned,
                owners=tuple(owners),
                permissions=tuple(
                    {"subjects": list(p.subjects), "verbs": list(p.verbs)}
                    if not isinstance(p, dict)
                    else p
                    for p in permissions
                ),
            )
        )
        if self.scheduler is not None:
            self.scheduler.upsert_queue(spec, cordoned=cordoned)
        return q

    def update_queue(
        self,
        name: str,
        priority_factor: float | None = None,
        cordoned: bool | None = None,
    ) -> Queue:
        """Partial update: None leaves a field unchanged."""
        q = self.queues.get(name)
        if q is None:
            raise SubmissionError(f"queue {name!r} does not exist")
        if priority_factor is not None:
            q.spec = QueueSpec(name, priority_factor)
        if cordoned is not None:
            q.cordoned = cordoned
        self._publish_queue_event(
            QueueUpsert(
                created=_time.time(),
                name=name,
                priority_factor=q.spec.priority_factor,
                cordoned=q.cordoned,
            )
        )
        if self.scheduler is not None:
            self.scheduler.upsert_queue(q.spec, cordoned=q.cordoned)
        return q

    def delete_queue(self, name: str):
        if name in self.queues:
            self._publish_queue_event(
                QueueDelete(created=_time.time(), name=name)
            )
        self.queues.pop(name, None)

    def get_queue(self, name: str) -> Queue | None:
        return self.queues.get(name)

    # ---- submission (internal/server/submit/submit.go) ----

    def submit(
        self, queue: str, jobset: str, jobs: list[JobSpec],
        now: float | None = None, deadline_ts: float | None = None,
    ) -> list[str]:
        """Validate + publish; returns job ids (existing ids for dedup
        hits). `deadline_ts` is the caller's propagated deadline (same
        clock as `now`): expired work is dropped before the durable
        enqueue — acked work always applies, never half."""
        slo = self.slo
        measure = slo is not None and slo.observes("frontdoor_submit_seconds")
        started = _time.perf_counter() if measure else 0.0
        try:
            return self._submit(queue, jobset, jobs, now, deadline_ts)
        finally:
            if measure:
                # Shed/expired/errored submits count too: a front door
                # that fails fast still spent the user's latency budget.
                slo.observe(
                    "frontdoor_submit_seconds",
                    _time.perf_counter() - started,
                    now=now,
                )

    def _submit(
        self, queue: str, jobset: str, jobs: list[JobSpec],
        now: float | None = None, deadline_ts: float | None = None,
    ) -> list[str]:
        if self.store_health is not None and self.frontdoor is None:
            healthy, reason = self.store_health.check()
            if not healthy:
                raise SubmissionError(f"store backpressure: {reason}")
        if queue not in self.queues:
            raise SubmissionError(f"queue {queue!r} does not exist")
        now = _time.time() if now is None else now
        if self.frontdoor is not None:
            # Per-tenant admission (token buckets + quota-weighted
            # overload shedding) counts JOBS, not RPCs — raises
            # AdmissionError with a retry-after the transport forwards.
            self.frontdoor.admit(queue, len(jobs), now=now)
        self._validate_gangs(jobs)
        events = []
        job_ids = []
        added_dedup = []
        for job in jobs:
            job = self._validate_and_default(queue, jobset, job, now)
            dedup_key = None
            dedup_id = job.annotations.get("armadaproject.io/deduplication-id", "")
            if dedup_id:
                dedup_key = (queue, dedup_id)
                if dedup_key in self._dedup:
                    job_ids.append(self._dedup[dedup_key])
                    continue
            if dedup_key:
                self._dedup[dedup_key] = job.id
                added_dedup.append(dedup_key)
            job_ids.append(job.id)
            events.append(SubmitJob(created=now, job=job, deduplication_id=dedup_id))
        if events:
            # Stamp the caller's trace context (the gRPC server span the
            # transport opened around this handler, utils/tracing.py):
            # the ingester's journey ledger records it per job and the
            # scheduler continues it onto lease events — one trace id
            # from submit RPC through lease.
            from ..utils.tracing import TRACER

            seq = EventSequence.of(
                queue, jobset, *events,
                traceparent=TRACER.current_traceparent(),
            )
            if self.frontdoor is not None:
                # Durable shard-WAL append IS the acknowledgement; the
                # deadline is checked one last time immediately before it
                # (drop early, whole — never a half-applied batch). A
                # dropped batch must not leave phantom dedup entries: a
                # later retry with the same dedup ids has to re-publish.
                try:
                    self.frontdoor.append(
                        seq, deadline_ts=deadline_ts, now=now
                    )
                except Exception:
                    for key in added_dedup:
                        self._dedup.pop(key, None)
                    raise
            else:
                self.log.publish(seq)
        return job_ids

    def _validate_and_default(
        self, queue: str, jobset: str, job: JobSpec, now: float
    ) -> JobSpec:
        """Validation rules from internal/server/submit/validation/."""
        if not job.id:
            job = job.with_(id=new_id("job"))
        job = job.with_(queue=queue, jobset=jobset, submitted_ts=now)
        if not job.requests:
            raise SubmissionError(f"job {job.id}: no resource requests")
        factory = self.config.resource_factory()
        for name in job.requests:
            if name not in factory.name_to_index:
                raise SubmissionError(
                    f"job {job.id}: unsupported resource {name!r}"
                )
        pc_name = job.priority_class or self.config.default_priority_class
        if pc_name not in self.config.priority_classes:
            raise SubmissionError(
                f"job {job.id}: unknown priority class {pc_name!r}"
            )
        job = job.with_(priority_class=pc_name)
        if job.affinity is not None:
            valid_ops = {"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"}
            for term in job.affinity.terms:
                for expr in term.expressions:
                    if expr.operator not in valid_ops:
                        raise SubmissionError(
                            f"job {job.id}: unknown affinity operator "
                            f"{expr.operator!r}"
                        )
        if job.gang is not None:
            if job.gang.cardinality < 1:
                raise SubmissionError(f"job {job.id}: gang cardinality < 1")
        return job

    def _validate_gangs(self, jobs: list[JobSpec]):
        """Gang member agreement (internal/scheduler/gang_validator.go):
        every member of a gang submitted together must declare the same
        cardinality, node-uniformity label and priority class; a batch
        must not carry more members than the declared cardinality."""
        by_gang: dict[str, list[JobSpec]] = {}
        for job in jobs:
            if job.gang is not None and job.gang.id:
                by_gang.setdefault(job.gang.id, []).append(job)
        for gid, members in by_gang.items():
            first = members[0]
            for m in members[1:]:
                if m.gang.cardinality != first.gang.cardinality:
                    raise SubmissionError(
                        f"gang {gid}: members disagree on cardinality "
                        f"({m.gang.cardinality} vs {first.gang.cardinality})"
                    )
                if m.gang.node_uniformity_label != first.gang.node_uniformity_label:
                    raise SubmissionError(
                        f"gang {gid}: members disagree on node uniformity label"
                    )
                if (m.priority_class or "") != (first.priority_class or ""):
                    raise SubmissionError(
                        f"gang {gid}: members disagree on priority class"
                    )
            if len(members) > first.gang.cardinality:
                raise SubmissionError(
                    f"gang {gid}: {len(members)} members exceed declared "
                    f"cardinality {first.gang.cardinality}"
                )

    # ---- cancel / reprioritise ----

    def cancel_job(self, queue: str, jobset: str, job_id: str, reason: str = ""):
        self.log.publish(
            EventSequence.of(
                queue, jobset, CancelJob(created=_time.time(), job_id=job_id, reason=reason)
            )
        )

    def cancel_jobset(self, queue: str, jobset: str, reason: str = ""):
        self.log.publish(
            EventSequence.of(
                queue, jobset, CancelJobSet(created=_time.time(), reason=reason)
            )
        )

    def reprioritise_job(self, queue: str, jobset: str, job_id: str, priority: int):
        self.log.publish(
            EventSequence.of(
                queue,
                jobset,
                ReprioritiseJob(created=_time.time(), job_id=job_id, priority=priority),
            )
        )
