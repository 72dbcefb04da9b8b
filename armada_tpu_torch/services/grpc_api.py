"""gRPC API: remote submit/query/events/reports surface.

Plays the role of the reference's gRPC services (Submit/QueueService/
Event/Jobs, pkg/api/submit.proto:356-401, event.proto:279,
job.proto:102). Methods are hosted with grpc generic handlers and
JSON-encoded messages: same capability surface (remote clients, streaming
watch) without a protoc codegen step; a protobuf wire encoding can be added
as an alternate content type behind the same method table.

This is the port's copy of the JAX package's services/grpc_api.py, with
the same service names and wire, so a client of either package talks to
a server of the other. What differs: `grpc` is imported only where a
socket is opened or a status code is read (`serve`, `_proto_handler`,
the clients, `_retrying_call`, `is_fenced_error`, `_retry_after_of`),
as `google.protobuf` already was. The server's logic, `method_table()`
and the JSON codec `_encode`/`_decode`, runs without either: an in-process
caller passes a request through the codec to a handler, and a handler's
`FencedError` reaches it as it is.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import threading
import time as _time

from ..frontdoor.admission import AdmissionError, DeadlineExpired
from ..core.types import (
    Affinity,
    Gang,
    IngressConfig,
    JobSpec,
    MatchExpression,
    NodeSelectorTerm,
    QueueSpec,
    ServiceConfig,
    Toleration,
)
from ..jobdb import JobState
from ..utils.tracing import TRACEPARENT_HEADER, TRACER
from .queryapi import JobFilter, Order

SERVICE = "armada_tpu.Api"
# Binary-protobuf twin of the method table (proto/armada.proto): codegen
# clients in any protobuf language hit the same handlers through it.
PROTO_SERVICE = "armada_tpu.ProtoApi"


class FencedError(RuntimeError):
    """A lease/report call carried a fencing token older than the
    executor's current fence: the scheduler already reassigned that
    executor's runs (partition expiry), so the stale exchange must not
    land. Mapped to FAILED_PRECONDITION on both wire encodings; the
    agent's recovery is an anti-entropy ExecutorSync, which returns the
    current token."""


def is_fenced_error(exc) -> bool:
    """True for a FencedError raised in-process OR its FAILED_PRECONDITION
    image on the wire (what ApiClient/ProtoExecutorClient callers see)."""
    if isinstance(exc, FencedError):
        return True
    code = getattr(exc, "code", None)
    if not callable(code):
        return False
    import grpc

    try:
        return code() == grpc.StatusCode.FAILED_PRECONDITION
    except Exception:
        return False


# Absolute deadline (unix seconds) of the in-flight RPC, set by the unary
# wrappers from gRPC's propagated client deadline (context.time_remaining)
# so handlers — the submit path — can drop already-expired work early
# instead of half-processing it. None = the caller set no deadline.
_CALL_DEADLINE: contextvars.ContextVar = contextvars.ContextVar(
    "armada_call_deadline", default=None
)

# Trailing-metadata key carrying the server-computed earliest useful retry
# instant on RESOURCE_EXHAUSTED shed responses; ApiClient/ProtoApiClient
# honor it with a bounded jittered backoff.
RETRY_AFTER_KEY = "retry-after"


def _retry_after_of(exc) -> float | None:
    """Seconds the server asked us to wait, from a RESOURCE_EXHAUSTED
    RpcError's trailing metadata — None for every other failure (other
    codes, or exhaustion without a hint, e.g. a full what-if backlog)."""
    code = getattr(exc, "code", None)
    if not callable(code):
        return None
    import grpc

    try:
        if code() != grpc.StatusCode.RESOURCE_EXHAUSTED:
            return None
        tm = getattr(exc, "trailing_metadata", None)
        md = tm() if callable(tm) else None
        for key, value in md or ():
            if key.lower() == RETRY_AFTER_KEY:
                return max(0.0, float(value))
    except (TypeError, ValueError):
        return None
    return None


def _call_deadline(context) -> object:
    """Stamp the RPC's absolute deadline into _CALL_DEADLINE; returns the
    reset token (None when the caller set no deadline)."""
    remaining = context.time_remaining()
    if remaining is None:
        return None
    return _CALL_DEADLINE.set(_time.time() + remaining)


def _rpc_span(method: str, context):
    """Server span for one RPC, joined to the caller's trace via the
    W3C `traceparent` call metadata (the server-interceptor half of
    trace propagation; ApiClient/ProtoApiClient inject the header).
    Handlers run inside it, so anything they publish — e.g. a submit's
    EventSequence — can stamp the same trace id."""
    md = {k.lower(): v for k, v in (context.invocation_metadata() or ())}
    return TRACER.span(
        f"rpc.{method}",
        remote_parent=md.get(TRACEPARENT_HEADER),
        rpc=method,
    )


def _inject_traceparent(metadata: list | None) -> list | None:
    """Client-side half: append the current span's traceparent to the
    outgoing call metadata (no-op outside any span)."""
    tp = TRACER.current_traceparent()
    if not tp:
        return metadata
    return list(metadata or []) + [(TRACEPARENT_HEADER, tp)]


def _encode(obj) -> bytes:
    def default(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return dataclasses.asdict(o)
        if isinstance(o, JobState):
            return o.value
        if hasattr(o, "tolist"):
            return o.tolist()
        raise TypeError(f"unserializable {type(o)}")

    return json.dumps(obj, default=default).encode()


def _decode(data: bytes):
    return json.loads(data.decode()) if data else {}


def job_spec_from_dict(d: dict) -> JobSpec:
    gang = None
    if d.get("gang"):
        g = d["gang"]
        gang = Gang(
            id=g["id"],
            cardinality=int(g["cardinality"]),
            node_uniformity_label=g.get("node_uniformity_label", ""),
        )
    tolerations = tuple(
        Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in d.get("tolerations", ())
    )
    affinity = None
    if d.get("affinity"):
        raw = d["affinity"]
        # Two accepted shapes: the legacy JSON list-of-term-lists, and the
        # proto json_format mapping {"terms": [{"expressions": [...]}]}.
        terms = (
            [t.get("expressions", ()) for t in raw.get("terms", ())]
            if isinstance(raw, dict)
            else raw
        )
        affinity = Affinity(
            terms=tuple(
                NodeSelectorTerm(
                    expressions=tuple(
                        MatchExpression(
                            key=e["key"],
                            operator=e.get("operator", "In"),
                            values=tuple(str(v) for v in e.get("values", ())),
                        )
                        for e in term
                    )
                )
                for term in terms
            )
        )
    return JobSpec(
        id=d.get("id", ""),
        queue=d.get("queue", ""),
        jobset=d.get("jobset", ""),
        pools=tuple(d.get("pools", ())),
        priority=int(d.get("priority", 0)),
        priority_class=d.get("priority_class", ""),
        requests=dict(d.get("requests", {})),
        node_selector=dict(d.get("node_selector", {})),
        tolerations=tolerations,
        affinity=affinity,
        gang=gang,
        annotations=dict(d.get("annotations", {})),
        bid_prices={
            # Accept the proto json_format shape {"queued": q, "running": r}
            # alongside scalars and (queued, running) pairs; normalize to
            # the pair form bid_price_pair understands.
            k: (
                (float(v.get("queued", 0.0)), float(v.get("running", 0.0)))
                if isinstance(v, dict)
                else v
            )
            for k, v in dict(d.get("bid_prices", {})).items()
        },
        command=tuple(d.get("command", ())),
        services=tuple(
            ServiceConfig.from_obj(s) for s in d.get("services", ())
        ),
        ingresses=tuple(
            IngressConfig.from_obj(i) for i in d.get("ingresses", ())
        ),
    )


def _lease_req_from_proto_dict(req: dict) -> dict:
    """LeaseRequest json_format dict -> the JSON handler's layout: unwrap
    the map<int32, ResourceMap> nesting (json_format keys maps by string)."""
    for node in req.get("nodes", ()):
        unalloc = node.get("unallocatable_by_priority")
        if unalloc:
            node["unallocatable_by_priority"] = {
                k: dict(v.get("resources", {})) for k, v in unalloc.items()
            }
    return req


def _lease_resp_to_proto_dict(out: dict) -> dict:
    """JSON lease reply -> LeaseResponse-shaped dict: the jobspec travels
    as always-zlib bytes on the proto wire (base64 for ParseDict), like
    the reference's compressed lease payloads."""
    import base64
    import zlib

    leases = []
    for lease in out.get("leases", ()):
        lease = dict(lease)
        spec = lease.pop("spec", None)
        if isinstance(spec, dict) and "__zlib__" in spec:
            raw = base64.b64decode(spec["__zlib__"])
        else:
            raw = zlib.compress(json.dumps(spec).encode(), level=6)
        lease["spec_zlib"] = base64.b64encode(raw).decode()
        leases.append(lease)
    return {**out, "leases": leases}


def _whatif_req_from_proto_dict(req: dict) -> dict:
    """WhatIf/PlanDrain/ExecuteDrain json_format dict -> the JSON
    handler's layout: zero-valued optional scalars mean "unset" on the
    proto wire (proto3 has no presence for them), so strip them and the
    handlers apply the configured defaults."""
    out = {k: v for k, v in req.items() if v not in ("", 0, 0.0, False)}
    mutations = [
        {k: v for k, v in m.items() if v not in ("", 0, 0.0, False)}
        for m in req.get("mutations", ())
    ]
    if mutations:
        out["mutations"] = mutations
    return out


def _plan_resp_to_proto_dict(out: dict) -> dict:
    return {
        "plan_json": json.dumps(out.get("plan") or {}, default=str),
        "rendered": out.get("rendered", ""),
    }


def _status_resp_to_proto_dict(out: dict) -> dict:
    return {"status_json": json.dumps(out.get("status") or {}, default=str)}


class ProtoExecutorClient:
    """Executor-agent connector over the binary-protobuf wire: implements
    the agent's `_call` surface (ExecutorLease / ReportEvents) with
    LeaseRequest/LeaseResponse messages — what a non-Python executor
    build against proto/armada.proto speaks."""

    def __init__(self, target: str, token: str | None = None,
                 ca_cert: str | None = None):
        self._proto = ProtoApiClient(target, token=token, ca_cert=ca_cert)

    def _call(self, method: str, req: dict):
        from google.protobuf import json_format

        from ..proto import armada_pb2 as pb

        if method == "ExecutorLease":
            msg = pb.LeaseRequest(
                executor=req["executor"],
                pool=req.get("pool", "default"),
                acked_run_ids=list(req.get("acked_run_ids", ())),
                fence_token=int(req.get("fence_token", 0) or 0),
            )
            for n in req.get("nodes", ()):
                node = msg.nodes.add(
                    id=n["id"],
                    name=n.get("name", n["id"]),
                    pool=n.get("pool", ""),
                    unschedulable=bool(n.get("unschedulable", False)),
                )
                node.labels.update(
                    {k: str(v) for k, v in (n.get("labels") or {}).items()}
                )
                node.total_resources.update(
                    {
                        k: str(v)
                        for k, v in (n.get("total_resources") or {}).items()
                    }
                )
                node.usage.update(
                    {k: str(v) for k, v in (n.get("usage") or {}).items()}
                )
                for t in n.get("taints", ()):
                    node.taints.add(
                        key=t.get("key", ""),
                        value=t.get("value", ""),
                        effect=t.get("effect", "NoSchedule"),
                    )
                for prio, res in (
                    n.get("unallocatable_by_priority") or {}
                ).items():
                    node.unallocatable_by_priority[int(prio)].resources.update(
                        {k: str(v) for k, v in res.items()}
                    )
            resp = self._proto._unary("ExecutorLease", msg, pb.LeaseResponse)
            out = json_format.MessageToDict(
                resp,
                preserving_proto_field_name=True,
                always_print_fields_with_no_presence=True,
            )
            # spec_zlib bytes -> the JSON wire's {"__zlib__": b64} shape,
            # which the agent's decompress_obj already understands.
            for lease in out.get("leases", ()):
                lease["spec"] = {"__zlib__": lease.pop("spec_zlib", "")}
            return out
        if method == "ReportEvents":
            msg = pb.ReportEventsRequest(
                executor=str(req.get("executor", "")),
                fence_token=int(req.get("fence_token", 0) or 0),
            )
            for e in req.get("events", ()):
                msg.events.add(
                    type=e.get("type", ""),
                    job_id=e.get("job_id", ""),
                    run_id=e.get("run_id", ""),
                    queue=e.get("queue", ""),
                    jobset=e.get("jobset", ""),
                    created=float(e.get("created", 0.0)),
                    error=str(e.get("error", "")),
                    retryable=bool(e.get("retryable", True)),
                    debug=str(e.get("debug", "")),
                )
            self._proto._unary("ReportEvents", msg, pb.ReportEventsResponse)
            return {}
        if method == "ExecutorSync":
            msg = pb.ExecutorSyncRequest(executor=req["executor"])
            for r in req.get("runs", ()):
                msg.runs.add(
                    run_id=r.get("run_id", ""),
                    job_id=r.get("job_id", ""),
                    phase=r.get("phase", ""),
                )
            resp = self._proto._unary(
                "ExecutorSync", msg, pb.ExecutorSyncResponse
            )
            return json_format.MessageToDict(
                resp,
                preserving_proto_field_name=True,
                always_print_fields_with_no_presence=True,
            )
        raise ValueError(f"ProtoExecutorClient does not speak {method!r}")


class ApiServer:
    """Hosts submit/query/events/reports over one gRPC server."""

    def __init__(
        self,
        submit,
        scheduler,
        query,
        log,
        submit_checker=None,
        binoculars=None,
        auth=None,
        authorizer=None,
        event_index=None,
        store_health=None,
        frontdoor=None,
    ):
        self.submit = submit
        self.scheduler = scheduler
        self.query = query
        self.log = log
        self.submit_checker = submit_checker
        self.binoculars = binoculars
        # Optional front door (armada_tpu_torch/frontdoor): the submit handler
        # observes its latency histogram and counts deadline drops
        # against it; admission itself runs inside SubmitService.submit
        # (one enforcement point for every transport).
        self.frontdoor = frontdoor
        # Optional backpressure monitor (services/backpressure.py):
        # surfaced to executors in lease replies.
        self.store_health = store_health
        # Optional per-jobset event-stream index (services/event_index.py,
        # the event-ingester view): watchers read only their jobset's
        # offsets instead of scanning the whole log.
        self.event_index = event_index
        # Authentication chain + permission mapping (services/auth.py;
        # common/auth/{multi,permissions}.go). None = open server (tests,
        # trusted in-process deployments).
        self.auth = auth
        self.authorizer = authorizer
        # Per-executor circuit breaker on the lease path: an executor whose
        # exchanges keep failing (malformed payloads, injected faults) gets
        # fast-failed with UNAVAILABLE for a cooldown — absorbed by the
        # agent's backoff loop — instead of repeatedly erroring a worker
        # thread mid-cycle (services/chaos.py).
        from .chaos import CircuitBreaker

        self.lease_breaker = CircuitBreaker(
            failure_threshold=3, cooldown_s=30.0
        )

    def _authorize(self, method: str, principal, req: dict):
        """Per-method permission gate (the reference's auth interceptors +
        per-handler authorize calls, server/submit.go)."""
        from . import auth as A

        az = self.authorizer
        if az is None or principal is None:
            return
        queue = None
        if "queue" in req and self.submit is not None:
            queue = self.submit.get_queue(req.get("queue", ""))
        if method == "SubmitJobs":
            az.authorize_queue(principal, "submit", queue, A.SUBMIT_ANY_JOBS)
        elif method == "CancelJobs":
            az.authorize_queue(principal, "cancel", queue, A.CANCEL_ANY_JOBS)
        elif method == "ReprioritizeJobs":
            az.authorize_queue(
                principal, "reprioritize", queue, A.REPRIORITIZE_ANY_JOBS
            )
        elif method in ("CreateQueue", "UpdateQueue"):
            az.authorize_global(principal, A.CREATE_QUEUE)
        elif method == "DeleteQueue":
            az.authorize_global(principal, A.DELETE_QUEUE)
        elif method in (
            "CordonNode", "CordonExecutor", "SetPriorityOverride", "PolicySet"
        ):
            # A fairness-policy flip reshapes every queue's entitlement —
            # the same operator privilege as cordon/override writes.
            az.authorize_global(principal, A.CORDON)
        elif method == "ExecuteDrain":
            # Draining cordons + preempts: the same privilege as cordon.
            # WhatIf/PlanDrain are read-only shadow solves — any
            # authenticated principal may ask.
            az.authorize_global(principal, A.CORDON)
        elif method in ("ExecutorLease", "ReportEvents"):
            az.authorize_global(principal, A.EXECUTE_JOBS)
        elif method == "WatchJobSet":
            az.authorize_queue(principal, "watch", queue, A.WATCH_ALL_EVENTS)
        # Reads (GetQueue/ListQueues/GetJobs/reports/logs) require only an
        # authenticated principal.

    # ---- unary handlers ----

    def _submit_jobs(self, req):
        """Submit with the front door's protections when one is wired:
        the propagated client deadline gates entry (expired work drops
        before any processing — stage "gate" — or just before the WAL
        ack — stage "enqueue"), admission sheds with AdmissionError
        (RESOURCE_EXHAUSTED + retry-after on the wire), and the handler
        wall clock lands in frontdoor_submit_seconds by outcome."""
        fd = self.frontdoor
        metrics = getattr(fd, "metrics", None) if fd is not None else None
        started = _time.perf_counter()
        # "error" covers everything that is neither an ack nor a
        # deliberate shed/expiry (validation rejections, unknown queue):
        # those requests were never acked and must not skew the ok-path
        # ack-latency SLO.
        outcome = "error"
        try:
            deadline_ts = req.get("deadline_ts") or _CALL_DEADLINE.get()
            deadline_ts = float(deadline_ts) if deadline_ts else None
            if deadline_ts is not None and _time.time() >= deadline_ts:
                if fd is not None:
                    fd.note_deadline_drop("gate")
                raise DeadlineExpired(
                    "gate", "client deadline expired before admission"
                )
            jobs = [
                job_spec_from_dict(j).with_(
                    queue=req["queue"], jobset=req["jobset"]
                )
                for j in req["jobs"]
            ]
            if self.submit_checker is not None:
                check = self.submit_checker.check(jobs)
                if not check.schedulable:
                    raise ValueError(
                        f"jobs would never schedule: {check.reason}"
                    )
            ids = self.submit.submit(
                req["queue"], req["jobset"], jobs, deadline_ts=deadline_ts
            )
            outcome = "ok"
            return {"job_ids": ids}
        except AdmissionError:
            outcome = "shed"
            raise
        except DeadlineExpired:
            outcome = "expired"
            raise
        finally:
            if metrics is not None and metrics.registry is not None:
                metrics.frontdoor_submit_time.labels(
                    outcome=outcome
                ).observe(_time.perf_counter() - started)

    def _cancel_jobs(self, req):
        for job_id in req.get("job_ids", []):
            self.submit.cancel_job(
                req["queue"], req["jobset"], job_id, req.get("reason", "")
            )
        if req.get("cancel_jobset"):
            self.submit.cancel_jobset(req["queue"], req["jobset"], req.get("reason", ""))
        return {}

    def _reprioritize(self, req):
        for job_id in req.get("job_ids", []):
            self.submit.reprioritise_job(
                req["queue"], req["jobset"], job_id, int(req["priority"])
            )
        return {}

    def _create_queue(self, req):
        self.submit.create_queue(
            QueueSpec(req["name"], float(req.get("priority_factor", 1.0))),
            cordoned=bool(req.get("cordoned", False)),
        )
        return {}

    def _update_queue(self, req):
        pf = req.get("priority_factor")
        self.submit.update_queue(
            req["name"],
            priority_factor=float(pf) if pf is not None else None,
            cordoned=req.get("cordoned"),
        )
        return {}

    def _delete_queue(self, req):
        self.submit.delete_queue(req["name"])
        return {}

    def _get_queue(self, req):
        q = self.submit.get_queue(req["name"])
        if q is None:
            raise KeyError(f"queue {req['name']!r} not found")
        return {
            "name": q.spec.name,
            "priority_factor": q.spec.priority_factor,
            "cordoned": q.cordoned,
        }

    def _list_queues(self, req):
        return {
            "queues": [
                {
                    "name": q.spec.name,
                    "priority_factor": q.spec.priority_factor,
                    "cordoned": q.cordoned,
                }
                for q in self.submit.queues.values()
            ]
        }

    def _get_jobs(self, req):
        filters = [
            JobFilter(f["field"], f.get("value"), f.get("match", "exact"))
            for f in req.get("filters", [])
        ]
        order = Order(
            req.get("order_field", "submitted"), req.get("order_direction", "asc")
        )
        rows, total = self.query.get_jobs(
            filters, order, int(req.get("skip", 0)), int(req.get("take", 100))
        )
        return {"jobs": [dataclasses.asdict(r) for r in rows], "total": total}

    def _group_jobs(self, req):
        filters = [
            JobFilter(f["field"], f.get("value"), f.get("match", "exact"))
            for f in req.get("filters", [])
        ]
        return {
            "groups": self.query.group_jobs(
                req["group_by"], filters, req.get("aggregates", [])
            )
        }

    def _proxy_to_leader(self, method: str, req: dict):
        """Reports describe the LEADER's rounds: a follower in file-lease
        HA mode forwards report RPCs to the leader's advertised address
        (the reference proxies via the Lease-holder connection,
        internal/scheduler/reports client). Returns None when this
        instance should answer locally (it is the leader, the address is
        unknown, or it would dial itself)."""
        elector = getattr(self.scheduler, "is_leader", None)
        is_holder = getattr(elector, "is_holder", None)
        if elector is None or is_holder is None or is_holder():
            return None
        addr = getattr(elector, "leader_address", lambda: "")()
        if not addr or addr == getattr(elector, "advertise", ""):
            return None
        # One cached channel per leader address (a new channel per polled
        # report RPC would leak fds on followers).
        cached = getattr(self, "_leader_client", None)
        if cached is None or cached[0] != addr:
            if cached is not None:
                cached[1].channel.close()
            cached = (addr, ApiClient(addr))
            self._leader_client = cached
        try:
            return cached[1]._call(method, req)
        except Exception:
            return None  # leader unreachable: serve the local (stale) view

    def _scheduling_report(self, req):
        proxied = self._proxy_to_leader("SchedulingReport", req)
        if proxied is not None:
            return proxied
        return {"report": self.scheduler.reports.scheduling_report()}

    def _queue_report(self, req):
        proxied = self._proxy_to_leader("QueueReport", req)
        if proxied is not None:
            return proxied
        return {"report": self.scheduler.reports.queue_report(req["queue"])}

    def _job_report(self, req):
        proxied = self._proxy_to_leader("JobReport", req)
        if proxied is not None:
            return proxied
        return {"report": self.scheduler.reports.job_report(req["job_id"])}

    def _job_trace(self, req):
        """One job's end-to-end journey (services/job_timeline.py):
        every state transition plus the aggregated unschedulable-round
        history and the submit trace id. Proxied to the leader like the
        reports — the ledger describes the leader's rounds."""
        proxied = self._proxy_to_leader("JobTrace", req)
        if proxied is not None:
            return proxied
        timeline = getattr(self.scheduler, "timeline", None)
        if timeline is None:
            raise KeyError("job timeline not enabled")
        doc = timeline.get(req["job_id"])
        if doc is None:
            raise KeyError(f"no journey recorded for job {req['job_id']!r}")
        return {
            "journey": doc,
            "rendered": timeline.render(req["job_id"], doc=doc),
        }

    def _slo_status(self, req):
        """Declared SLOs with compliance + multi-window burn rates
        (services/slo.py). Leader-proxied like the reports — burn rates
        describe the leader's rounds, a follower's tracker is idle."""
        proxied = self._proxy_to_leader("SLOStatus", req)
        if proxied is not None:
            return proxied
        tracker = getattr(self.scheduler, "slo", None)
        if tracker is None:
            raise KeyError("SLO tracking not enabled on this server")
        return tracker.snapshot()

    def _doctor(self, req):
        """Self-healing-solve state (scheduler.doctor_report): failover
        ladder breaker states, recent admission-firewall rejections with
        their quarantine bundle paths, recent failovers. Leader-proxied
        — the ladder describes the leader's rounds."""
        proxied = self._proxy_to_leader("Doctor", req)
        if proxied is not None:
            return proxied
        report = getattr(self.scheduler, "doctor_report", None)
        if report is None:
            raise KeyError("doctor report not available on this server")
        return report()

    def _fairness_report(self, req):
        """Fairness observatory (observe/fairness.py): the latest per
        -pool share ledger, preemption attribution map and starvation
        alerts. Leader-proxied like the reports — the ledger describes
        the leader's rounds. Optional req["pool"] narrows to one pool
        (NOT_FOUND when no round has solved for it)."""
        proxied = self._proxy_to_leader("FairnessReport", req)
        if proxied is not None:
            return proxied
        tracker = getattr(self.scheduler, "fairness", None)
        if tracker is None:
            raise KeyError("fairness observatory not enabled on this server")
        pool = req.get("pool") or None
        if pool:
            doc = tracker.latest(pool)
            if doc is None:
                raise KeyError(f"no fairness ledger recorded for pool {pool!r}")
            snap = tracker.snapshot()
            return {
                "pools": {pool: doc},
                "alerts": [a for a in snap["alerts"] if a["pool"] == pool],
            }
        return tracker.snapshot()

    # ---- what-if planner (armada_tpu_torch/whatif) ----

    def _whatif_service(self):
        svc = getattr(self.scheduler, "whatif", None)
        if svc is None:
            raise KeyError("what-if planner not enabled on this server")
        return svc

    @staticmethod
    def _opt_float(req, key):
        value = req.get(key)
        return float(value) if value is not None else None

    def _what_if(self, req):
        """Shadow-solve a mutated fork of the last round and return the
        structured plan (displacements, gang ETAs, headroom). Runs on
        the planner's bounded worker — a full backlog fails fast with
        RESOURCE_EXHAUSTED instead of queueing."""
        from ..whatif import mutations_from_dicts

        svc = self._whatif_service()
        plan = svc.plan(
            mutations_from_dicts(req.get("mutations", [])),
            pool=req.get("pool") or None,
            solver=req.get("solver") or None,
            rounds=int(req["rounds"]) if req.get("rounds") else None,
        )
        return {"plan": plan.to_dict(), "rendered": plan.render()}

    def _plan_drain(self, req):
        """Dry-run a drain: predicted voluntary completions, deadline
        preemptions (gang-aware), requeue landings, rounds-to-drain —
        produced by the SAME DrainController execution runs."""
        svc = self._whatif_service()
        plan = svc.plan_drain(
            req["executor"],
            pool=req.get("pool") or None,
            solver=req.get("solver") or None,
            rounds=int(req["rounds"]) if req.get("rounds") else None,
            deadline_s=self._opt_float(req, "deadline_s"),
        )
        return {"plan": plan.to_dict(), "rendered": plan.render()}

    def _execute_drain(self, req):
        """Start (idempotent) or poll a REAL staged drain through the
        control-plane event path."""
        svc = self._whatif_service()
        if req.get("status_only"):
            status = svc.drain_status(req.get("executor") or None)
            if status is None:
                raise KeyError(
                    f"no drain recorded for executor {req.get('executor')!r}"
                )
            return {"status": status}
        status = svc.execute_drain(
            req["executor"], deadline_s=self._opt_float(req, "deadline_s")
        )
        return {"status": status}

    def _set_priority_override(self, req):
        self.scheduler.set_priority_override(
            req["queue"], req.get("priority_factor")
        )
        return {}

    def _list_priority_overrides(self, req):
        return {"overrides": dict(self.scheduler.priority_overrides)}

    # ---- fairness policy control plane (solver/policy.py) ----

    def _policy_show(self, req):
        """Active fairness policy per pool: the file-config layer, the
        runtime overrides, and the effective policy each pool solves
        under. Optional req["pool"] narrows to one pool."""
        cfg = self.scheduler.config
        pools = {p.name for p in cfg.pools} | set(
            cfg.fairness_policy_pools
        ) | set(self.scheduler.fairness_policy_overrides)
        want = req.get("pool") or None
        if want is not None:
            if want not in pools:
                pools = pools | {want}
            pools = {want}
        return {
            "default": str(cfg.fairness_policy_default),
            "overrides": dict(self.scheduler.fairness_policy_overrides),
            "pools": {
                pool: self.scheduler.fairness_policy(pool)
                for pool in sorted(pools)
            },
        }

    def _policy_set(self, req):
        """Flip (or clear, policy="") a pool's fairness policy. The
        divergence gate applies unless force=True: a non-DRF flip needs
        a registered shadow scorecard (see `armadactl policy ab`)."""
        pool = req["pool"]
        policy = req.get("policy") or None
        scorecard = req.get("scorecard")
        if scorecard and policy:
            self.scheduler.note_policy_shadow(pool, policy, scorecard)
        self.scheduler.set_fairness_policy(
            pool, policy, force=bool(req.get("force"))
        )
        return {"pool": pool, "policy": self.scheduler.fairness_policy(pool)}

    def _cordon_executor(self, req):
        self.scheduler.set_executor_cordon(
            req["executor"], not req.get("uncordon", False)
        )
        return {}

    # ---- executor API (the LeaseJobRuns protocol,
    # pkg/executorapi/executorapi.proto:106-115) ----

    def _executor_lease(self, req):
        """One heartbeat exchange behind the per-executor circuit breaker:
        open circuits fast-fail the RPC (UNAVAILABLE — wire-agnostic: a
        reply-payload flag would be dropped by the proto LeaseResponse
        schema) and the agent's backoff loop absorbs it; failures count
        toward opening; a success closes the circuit."""
        from .chaos import CircuitOpenError

        name = req.get("executor", "")
        if not self.lease_breaker.allow(name):
            raise CircuitOpenError(
                f"lease circuit open for executor {name!r}; retry after "
                f"{self.lease_breaker.cooldown_s:.0f}s cooldown"
            )
        # Fence gate BEFORE the exchange touches scheduler state: a
        # stale-fenced executor heartbeating would otherwise re-enter the
        # heartbeat map and receive leases the anti-entropy sync hasn't
        # validated. A fence rejection is protocol, not a server fault —
        # it must not open the circuit.
        self._check_fence("ExecutorLease", name, req.get("fence_token"))
        try:
            reply = self._executor_lease_inner(req)
        except Exception:
            self.lease_breaker.record_failure(name)
            raise
        self.lease_breaker.record_success(name)
        return reply

    def _check_fence(self, method: str, name: str, token) -> None:
        """Reject tokens older than the executor's current fence. Tokens
        are optional (None/absent skips the check) so pre-fencing clients
        and in-process callers keep working; an executor that was fenced
        while holding no token (agent restart) sends 0 and is routed
        through ExecutorSync like any stale holder."""
        fence_of = getattr(self.scheduler, "executor_fence", None)
        if not name or token is None or fence_of is None:
            return
        current = fence_of(name)
        if int(token) < current:
            metrics = getattr(self.scheduler, "metrics", None)
            if metrics is not None and metrics.registry is not None:
                metrics.fence_rejections.labels(
                    executor=name, method=method
                ).inc()
            raise FencedError(
                f"executor {name!r} holds fence token {int(token)} but the "
                f"scheduler is at {current} (runs were reassigned after a "
                "partition); complete an ExecutorSync before leasing or "
                "reporting"
            )

    def _executor_lease_inner(self, req):
        """One heartbeat exchange: the executor reports its nodes and acked
        run ids; the reply carries new leases and runs to cancel/preempt."""
        from ..core.types import NodeSpec, Taint
        from ..jobdb import JobState
        from .scheduler import ExecutorHeartbeat

        name = req["executor"]
        pool = req.get("pool", "default")
        nodes = [
            NodeSpec(
                id=n["id"],
                name=n.get("name", n["id"]),
                executor=name,
                # Per-node pool override (node_group.go GetPool: pool label
                # + reserved suffix): one cluster can span pools.
                pool=n.get("pool", pool),
                labels=dict(n.get("labels", {})),
                taints=tuple(
                    Taint(t["key"], t.get("value", ""), t.get("effect", "NoSchedule"))
                    for t in n.get("taints", ())
                ),
                total_resources=dict(n.get("total_resources", {})),
                unschedulable=bool(n.get("unschedulable", False)),
                # Utilisation reporting: the non-framework slice arrives as
                # unallocatable-at-every-priority (executor/utilisation/).
                unallocatable_by_priority={
                    int(k): dict(v)
                    for k, v in n.get("unallocatable_by_priority", {}).items()
                },
            )
            for n in req.get("nodes", [])
        ]
        import time as _t

        self.scheduler.report_executor(
            ExecutorHeartbeat(name=name, pool=pool, nodes=nodes, last_seen=_t.time())
        )

        acked = set(req.get("acked_run_ids", []))
        leases, cancels, active = [], [], []
        # Store backpressure (services/backpressure.py — the reference's
        # executor pauses pod creation on etcd pressure,
        # executor/application.go:63-101): checked up front so an
        # unhealthy reply skips building (and compressing) lease payloads
        # the agent would discard anyway. Cancels and reconciliation still
        # flow — they relieve pressure.
        store_healthy = True
        if self.store_health is not None:
            store_healthy, _ = self.store_health.check()
        txn = self.scheduler.jobdb.read_txn()
        # Live runs on this executor come from the by-executor index; the
        # cancel sweep below resolves acked run ids directly (no full-store
        # walk on the lease hot path).
        for job in txn.jobs_for_executor(name):
            run = job.latest_run
            if run is None or run.executor != name:
                continue
            if (
                store_healthy
                and job.state == JobState.LEASED
                and run.id not in acked
            ):
                from ..utils.compress import compress_obj

                leases.append(
                    {
                        "run_id": run.id,
                        "job_id": job.id,
                        "queue": job.queue,
                        "jobset": job.jobset,
                        "node_id": run.node_id,
                        "scheduled_at_priority": run.scheduled_at_priority,
                        # Jobspecs dominate lease payloads; compressed like
                        # the reference's zlib-compressed lease replies
                        # (common/compress, scheduler/api.go).
                        "spec": compress_obj(
                            {
                                "id": job.spec.id,
                                "requests": job.spec.requests,
                                "annotations": job.spec.annotations,
                                "command": list(job.spec.command),
                                "services": [
                                    dataclasses.asdict(s)
                                    for s in job.spec.services
                                ],
                                "ingresses": [
                                    dataclasses.asdict(i)
                                    for i in job.spec.ingresses
                                ],
                            }
                        ),
                    }
                )
            elif job.state in (JobState.PENDING, JobState.RUNNING):
                # Runs the server believes are live here: the agent
                # reconciles pods it doesn't actually have (restart/loss).
                active.append(
                    {
                        "run_id": run.id,
                        "job_id": job.id,
                        "queue": job.queue,
                        "jobset": job.jobset,
                    }
                )
        # Jobs killed underneath the executor: tear the pod down
        # (SUCCEEDED pods exit on their own; no cancel for them). The acked
        # gate is both necessary and sufficient: the agent's acked set IS
        # its live-pod set (executor_agent.py prunes acks to live pods
        # every tick), so a pod started from a prior exchange whose job was
        # cancelled mid-flight appears in acked on the NEXT exchange and
        # gets its cancel then; and runs that never produced a pod never
        # trigger resends. Resolved per acked run id via the run index.
        for rid in acked:
            job = txn.job_for_any_run(rid)
            if job is None:
                continue
            owned = next((r for r in job.runs if r.id == rid), None)
            if owned is None or owned.executor != name:
                continue
            from ..jobdb.jobdb import RunState as _RS

            if job.state in (
                JobState.CANCELLED,
                JobState.PREEMPTED,
                JobState.FAILED,
            ) or owned.state == _RS.PREEMPTED:
                # Job killed underneath the executor — or the RUN alone
                # was preempt-requeued (a drain's deadline preemption:
                # the job lives on elsewhere, THIS pod must die).
                cancels.append({"run_id": rid, "job_id": job.id})
        # The jobs' submit trace contexts, batched (one ledger lock for
        # the whole reply): the agent echoes each lease's traceparent on
        # that run's lifecycle reports so run events join the job's
        # trace (JSON wire only; the proto LeaseResponse drops it).
        timeline = getattr(self.scheduler, "timeline", None)
        if timeline is not None and leases:
            tps = timeline.traceparents([lease["job_id"] for lease in leases])
            for lease in leases:
                lease["traceparent"] = tps[lease["job_id"]]
        fence_of = getattr(self.scheduler, "executor_fence", None)
        config = getattr(self.scheduler, "config", None)
        return {
            "leases": leases,
            "cancel_runs": cancels,
            "active_runs": active,
            # Agents defer creating pods for NEW leases while false;
            # unacked leases are simply re-sent after recovery.
            "store_healthy": store_healthy,
            # Fencing token to echo on the next exchange, and the
            # server-advertised lease TTL the agent arms its partition
            # detector with (see executor_agent.ExecutorAgent).
            "fence_token": fence_of(name) if fence_of is not None else 0,
            "lease_ttl_s": (
                float(config.executor_lease_ttl_s)
                if config is not None
                else 0.0
            ),
        }

    def _report_events(self, req):
        """Executor-side state transitions republished to the log
        (ExecutorApi.ReportEvents, api.go:347). Fenced like the lease
        path: a partitioned executor whose runs were reassigned must not
        land stale terminal reports — the requeued job's NEW run is the
        only one allowed a terminal outcome."""
        self._check_fence(
            "ReportEvents", req.get("executor", ""), req.get("fence_token")
        )
        from ..events import (
            EventSequence,
            JobRunErrors,
            JobRunPending,
            JobRunRunning,
            JobRunSucceeded,
            JobSucceeded,
        )

        type_map = {
            "pending": lambda e: [
                JobRunPending(created=e["created"], job_id=e["job_id"],
                              run_id=e["run_id"])
            ],
            "running": lambda e: [
                JobRunRunning(created=e["created"], job_id=e["job_id"],
                              run_id=e["run_id"])
            ],
            "succeeded": lambda e: [
                JobRunSucceeded(created=e["created"], job_id=e["job_id"],
                                run_id=e["run_id"]),
                JobSucceeded(created=e["created"], job_id=e["job_id"]),
            ],
            "failed": lambda e: [
                JobRunErrors(created=e["created"], job_id=e["job_id"],
                             run_id=e["run_id"], error=e.get("error", ""),
                             retryable=bool(e.get("retryable", True)),
                             debug=e.get("debug", "")),
            ],
        }
        items = req.get("events", [])
        # Validate the whole batch before publishing anything: a malformed
        # item must not leave a half-published batch that a client retry
        # would duplicate into the durable log.
        for item in items:
            if item.get("type") not in type_map:
                raise ValueError(f"unknown event type {item.get('type')!r}")
            for key in ("job_id", "run_id", "queue", "jobset", "created"):
                if key not in item:
                    raise ValueError(f"event missing field {key!r}: {item}")
        for item in items:
            events = type_map[item["type"]](item)
            self.log.publish(
                EventSequence.of(
                    item["queue"], item["jobset"], *events,
                    # Run reports re-join the job's trace: the agent
                    # echoes the traceparent its lease carried.
                    traceparent=item.get("traceparent", ""),
                )
            )
        return {}

    def _executor_sync(self, req):
        """Anti-entropy full-state sync (post-partition reconciliation).

        The executor reports EVERY pod it actually holds; the server
        diffs that set against the jobdb and classifies each side's
        surplus deterministically:

          zombie     the pod's run is unknown, its job already terminal,
                     or its job was requeued after lease expiry — tear
                     the pod down; its outcome must never land
          duplicate  the run was superseded by a newer run of the same
                     job (requeue + re-lease won the race) — tear the
                     old pod down so exactly one attempt survives
          kept       still this executor's latest live run — re-adopted
          orphaned   the jobdb holds a live run here that the executor
                     no longer has — failed retryable (requeue path),
                     the missing-pod reconciliation made explicit

        The reply carries the executor's CURRENT fence token: completing
        a sync is the one way a fenced executor rejoins the lease flow.
        """
        from ..events import EventSequence, JobRunErrors

        name = req["executor"]
        runs = req.get("runs", [])
        txn = self.scheduler.jobdb.read_txn()
        agent_runs = {r["run_id"] for r in runs}
        kill, kept, orphaned = [], [], []
        resolutions = {"zombie": 0, "duplicate": 0, "kept": 0, "orphaned": 0}

        def _kill(rid, job_id, reason, kind):
            kill.append({"run_id": rid, "job_id": job_id, "reason": reason})
            resolutions[kind] += 1

        for r in runs:
            rid = r["run_id"]
            job = txn.job_for_any_run(rid)
            if job is None:
                _kill(rid, r.get("job_id", ""), "unknown run", "zombie")
            elif job.state == JobState.QUEUED:
                # Requeued after expiry, new run not yet leased: the old
                # pod is fenced out — the re-lease must start clean.
                _kill(rid, job.id, "job requeued after lease expiry",
                      "zombie")
            elif job.state.terminal:
                _kill(rid, job.id, f"job already {job.state.value}",
                      "zombie")
            elif (
                job.latest_run is None
                or job.latest_run.id != rid
                or job.latest_run.executor != name
            ):
                _kill(rid, job.id, "superseded by a newer run", "duplicate")
            else:
                kept.append(rid)
                resolutions["kept"] += 1
        import time as _t

        now = _t.time()
        for job in txn.jobs_for_executor(name):
            run = job.latest_run
            if run is None or run.id in agent_runs:
                continue
            if job.state not in (JobState.PENDING, JobState.RUNNING):
                # LEASED runs re-send through the normal lease path.
                continue
            orphaned.append(run.id)
            resolutions["orphaned"] += 1
            self.log.publish(
                EventSequence.of(
                    job.queue,
                    job.jobset,
                    JobRunErrors(
                        created=now,
                        job_id=job.id,
                        run_id=run.id,
                        error=(
                            "pod missing on executor after partition "
                            "(anti-entropy sync)"
                        ),
                        retryable=True,
                    ),
                )
            )
        fence_of = getattr(self.scheduler, "executor_fence", None)
        fence = fence_of(name) if fence_of is not None else 0
        synced = getattr(self.scheduler, "note_executor_synced", None)
        if synced is not None:
            synced(name)
        metrics = getattr(self.scheduler, "metrics", None)
        if metrics is not None and metrics.registry is not None:
            for kind, count in resolutions.items():
                if count:
                    metrics.anti_entropy_resolutions.labels(
                        resolution=kind
                    ).inc(count)
        return {
            "fence_token": fence,
            "kill_runs": kill,
            "kept_run_ids": kept,
            "orphaned_run_ids": orphaned,
        }

    def _get_logs(self, req):
        if self.binoculars is None:
            raise KeyError("binoculars not enabled")
        return {
            "lines": self.binoculars.get_logs(
                req["job_id"], int(req.get("tail_lines", 100))
            )
        }

    def _cordon_node(self, req):
        if self.binoculars is None:
            raise KeyError("binoculars not enabled")
        if req.get("uncordon"):
            self.binoculars.uncordon_node(req["node_id"])
        else:
            self.binoculars.cordon_node(req["node_id"])
        return {}

    # ---- streaming ----

    def _watch_entries(self, queue, jobset, cursor, watch, context):
        """Shared watch core: (offset, EventSequence) pairs for one jobset,
        following the log when `watch`. Both wire encodings stream through
        this, so cursor/index semantics cannot diverge."""
        cond = self.log.watcher() if watch else None
        try:
            while context.is_active():
                batch = None
                if self.event_index is not None:
                    # Per-jobset stream read (eventstore.go:24-46): the
                    # index has already partitioned the log, so this
                    # watcher touches only its jobset's entries. Sync here
                    # keeps the view current even between scheduler cycles.
                    self.event_index.sync()
                    batch = self.event_index.read_from(
                        queue, jobset, cursor, 1000
                    )
                if batch is not None:
                    # Index path: the cursor advances only over this
                    # jobset's own offsets.
                    if batch:
                        cursor = batch[-1][0] + 1
                else:
                    # No index, or the jobset aged out of it (retention):
                    # the log is the source of truth, scan it directly.
                    # The cursor advances past every scanned entry,
                    # matching or not — never rewound to the last match.
                    batch = []
                    cursor = max(cursor, self.log.start_offset)
                    from ..events.file_log import CompactedLogError

                    try:
                        entries = self.log.read(cursor, 1000)
                    except CompactedLogError:
                        # A concurrent compact() advanced start_offset
                        # between the clamp and the read — skip the
                        # compacted history and retry rather than aborting
                        # the watch stream.
                        continue
                    for entry in entries:
                        cursor = entry.offset + 1
                        seq = entry.sequence
                        if seq.queue == queue and seq.jobset == jobset:
                            batch.append((entry.offset, seq))
                yield from batch
                if not watch:
                    return
                with cond:
                    cond.wait(timeout=0.5)
        finally:
            if cond is not None:
                self.log.remove_watcher(cond)

    def _watch_jobset(self, req, context):
        """Server-streaming jobset events (event.proto:279 GetJobSetEvents)."""
        for offset, seq in self._watch_entries(
            req["queue"],
            req["jobset"],
            int(req.get("from_offset", 0)),
            bool(req.get("watch", True)),
            context,
        ):
            for event in seq.events:
                payload = {
                    "type": type(event).__name__,
                    "offset": offset,
                    **{
                        k: v
                        for k, v in dataclasses.asdict(event).items()
                        if k != "job" and not isinstance(v, dict)
                    },
                }
                if hasattr(event, "job") and event.job is not None:
                    payload["job_id"] = event.job.id
                yield _encode(payload)

    # ---- wiring ----

    def _proto_handler(self, method: str, table, gate, watchers):
        """RPC handler for the binary-protobuf service: proto request ->
        json_format dict -> the SAME method handler -> proto response.
        Field names in proto/armada.proto match the JSON wire, so the two
        encodings cannot drift. WatchJobSet streams full EventSequenceEntry
        messages (the armadaevents EventSequence shape) straight from the
        log entries."""
        import grpc
        from google.protobuf import json_format

        from ..proto import armada_pb2 as pb

        unary_types = {
            "SubmitJobs": (pb.JobSubmitRequest, pb.JobSubmitResponse),
            "CancelJobs": (pb.JobCancelRequest, pb.JobCancelResponse),
            "ReprioritizeJobs": (
                pb.JobReprioritizeRequest,
                pb.JobReprioritizeResponse,
            ),
            # Executor wire (executorapi.proto role): transforms adapt the
            # nested proto map/bytes shapes to the JSON handler's layout.
            "ExecutorLease": (pb.LeaseRequest, pb.LeaseResponse),
            "ReportEvents": (pb.ReportEventsRequest, pb.ReportEventsResponse),
            "ExecutorSync": (
                pb.ExecutorSyncRequest,
                pb.ExecutorSyncResponse,
            ),
            # What-if planner (armada_tpu_torch/whatif): structured plans and
            # drain statuses travel as JSON strings on this wire.
            "WhatIf": (pb.WhatIfRequest, pb.WhatIfResponse),
            "PlanDrain": (pb.PlanDrainRequest, pb.PlanDrainResponse),
            "ExecuteDrain": (
                pb.ExecuteDrainRequest,
                pb.ExecuteDrainResponse,
            ),
        }
        req_transforms = {
            "ExecutorLease": _lease_req_from_proto_dict,
            # proto3 cannot distinguish unset from zero: a zero-valued
            # deadline/rounds/solver from MessageToDict means "default"
            # on this wire (the JSON wire keeps explicit 0 semantics).
            "WhatIf": _whatif_req_from_proto_dict,
            "PlanDrain": _whatif_req_from_proto_dict,
            "ExecuteDrain": _whatif_req_from_proto_dict,
        }
        resp_transforms = {
            "ExecutorLease": _lease_resp_to_proto_dict,
            "WhatIf": _plan_resp_to_proto_dict,
            "PlanDrain": _plan_resp_to_proto_dict,
            "ExecuteDrain": _status_resp_to_proto_dict,
        }
        if method == "WatchJobSet":
            def stream(request, context):
                msg = pb.WatchRequest.FromString(request)
                req = {
                    "queue": msg.queue,
                    "jobset": msg.jobset,
                    "from_offset": int(msg.from_offset),
                    "watch": bool(msg.follow),
                }
                gate(method, req, context)
                # Same watcher bound as the JSON stream: parked watch
                # threads must not starve unary RPCs of the pool.
                if not watchers.acquire(blocking=False):
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED,
                        "too many concurrent watchers",
                    )
                try:
                    yield from self._watch_jobset_proto(msg, context)
                finally:
                    watchers.release()

            return grpc.unary_stream_rpc_method_handler(
                stream,
                request_deserializer=bytes,
                response_serializer=lambda m: m.SerializeToString(),
            )
        if method not in unary_types:
            return None
        req_type, resp_type = unary_types[method]
        fn = table.get(method)

        def unary(request, context):
            msg = req_type.FromString(request)
            # Defaults included: proto3 omits zero-valued fields from
            # MessageToDict otherwise, and e.g. ReprioritizeJobs to
            # priority 0 must look identical to the JSON encoding.
            req = json_format.MessageToDict(
                msg,
                preserving_proto_field_name=True,
                always_print_fields_with_no_presence=True,
            )
            req_tf = req_transforms.get(method)
            if req_tf is not None:
                req = req_tf(req)
            gate(method, req, context)
            from ..whatif.planner import WhatIfBusyError
            from .chaos import CircuitOpenError

            token = _call_deadline(context)
            with _rpc_span(method, context):
                try:
                    out = fn(req) or {}
                except KeyError as e:
                    context.abort(grpc.StatusCode.NOT_FOUND, str(e))
                except ValueError as e:
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                except CircuitOpenError as e:
                    context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
                except AdmissionError as e:
                    # Shed with a machine-readable retry hint: clients
                    # back off deliberately instead of timing out.
                    context.set_trailing_metadata(
                        ((RETRY_AFTER_KEY, f"{e.retry_after_s:.3f}"),)
                    )
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED, str(e)
                    )
                except DeadlineExpired as e:
                    context.abort(
                        grpc.StatusCode.DEADLINE_EXCEEDED, str(e)
                    )
                except WhatIfBusyError as e:
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED, str(e)
                    )
                except FencedError as e:
                    context.abort(
                        grpc.StatusCode.FAILED_PRECONDITION, str(e)
                    )
                finally:
                    if token is not None:
                        _CALL_DEADLINE.reset(token)
            resp_tf = resp_transforms.get(method)
            if resp_tf is not None:
                out = resp_tf(out)
            resp = resp_type()
            json_format.ParseDict(out, resp, ignore_unknown_fields=True)
            return resp

        return grpc.unary_unary_rpc_method_handler(
            unary,
            request_deserializer=bytes,
            response_serializer=lambda m: m.SerializeToString(),
        )

    def _watch_jobset_proto(self, msg, context):
        """Proto watch: one EventSequenceEntry per matching log entry
        (the armadaevents EventSequence shape), over the shared core."""
        from ..proto import sequence_to_proto

        for offset, seq in self._watch_entries(
            msg.queue, msg.jobset, int(msg.from_offset), bool(msg.follow),
            context,
        ):
            yield sequence_to_proto(offset, seq)

    def method_table(self):
        return {
            "SubmitJobs": self._submit_jobs,
            "CancelJobs": self._cancel_jobs,
            "ReprioritizeJobs": self._reprioritize,
            "CreateQueue": self._create_queue,
            "UpdateQueue": self._update_queue,
            "DeleteQueue": self._delete_queue,
            "GetQueue": self._get_queue,
            "ListQueues": self._list_queues,
            "GetJobs": self._get_jobs,
            "GroupJobs": self._group_jobs,
            "SchedulingReport": self._scheduling_report,
            "QueueReport": self._queue_report,
            "JobReport": self._job_report,
            "JobTrace": self._job_trace,
            "SLOStatus": self._slo_status,
            "Doctor": self._doctor,
            "FairnessReport": self._fairness_report,
            "GetJobLogs": self._get_logs,
            "CordonNode": self._cordon_node,
            "SetPriorityOverride": self._set_priority_override,
            "ListPriorityOverrides": self._list_priority_overrides,
            "PolicyShow": self._policy_show,
            "PolicySet": self._policy_set,
            "ExecutorLease": self._executor_lease,
            "ReportEvents": self._report_events,
            "ExecutorSync": self._executor_sync,
            "CordonExecutor": self._cordon_executor,
            "WhatIf": self._what_if,
            "PlanDrain": self._plan_drain,
            "ExecuteDrain": self._execute_drain,
        }

    def serve(self, port: int = 0, max_workers: int = 16, max_watchers: int | None = None,
              tls: tuple | None = None):
        """Serve on 127.0.0.1:port; `tls=(cert_file, key_file)` serves TLS
        (grpc ssl_server_credentials — the reference's
        internal/common/grpc TLS listener config).

        Watch streams park a worker thread each in a wait loop; unbounded
        watchers would starve unary RPCs (executor lease exchanges) of the
        shared pool. `max_watchers` (default: max_workers - 4) bounds them
        so unary handlers always have threads; excess watchers are rejected
        with RESOURCE_EXHAUSTED and may retry."""
        import threading
        from concurrent import futures

        import grpc

        if max_watchers is None:
            max_watchers = max(1, max_workers - 4)
        table = self.method_table()
        outer = self
        watchers = threading.Semaphore(max_watchers)

        from .auth import AuthError, PermissionDenied

        def gate(method, request, context):
            """Authenticate + authorize one call; aborts on failure."""
            if outer.auth is None:
                return None
            md = {
                k.lower(): v for k, v in (context.invocation_metadata() or ())
            }
            try:
                principal = outer.auth.authenticate(md)
                outer._authorize(method, principal, request)
                return principal
            except AuthError as e:
                context.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
            except PermissionDenied as e:
                context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                name = handler_call_details.method  # /Service/Method
                parts = name.strip("/").split("/")
                if len(parts) != 2:
                    return None
                if parts[0] == PROTO_SERVICE:
                    # Binary protobuf encoding of the same methods
                    # (proto/armada.proto; the reference's pkg/api protos).
                    return outer._proto_handler(parts[1], table, gate, watchers)
                if parts[0] != SERVICE:
                    return None
                method = parts[1]
                if method == "WatchJobSet":
                    def stream(request, context):
                        req = _decode(request)
                        gate(method, req, context)
                        if not watchers.acquire(blocking=False):
                            context.abort(
                                grpc.StatusCode.RESOURCE_EXHAUSTED,
                                f"too many concurrent watchers (max {max_watchers})",
                            )
                        try:
                            yield from outer._watch_jobset(req, context)
                        finally:
                            watchers.release()

                    return grpc.unary_stream_rpc_method_handler(
                        stream,
                        request_deserializer=bytes,
                        response_serializer=bytes,
                    )
                fn = table.get(method)
                if fn is None:
                    return None

                def unary(request, context):
                    from ..whatif.planner import WhatIfBusyError
                    from .chaos import CircuitOpenError

                    req = _decode(request)
                    gate(method, req, context)
                    token = _call_deadline(context)
                    with _rpc_span(method, context):
                        try:
                            return _encode(fn(req))
                        except KeyError as e:
                            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
                        except ValueError as e:
                            context.abort(
                                grpc.StatusCode.INVALID_ARGUMENT, str(e)
                            )
                        except CircuitOpenError as e:
                            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
                        except AdmissionError as e:
                            context.set_trailing_metadata(
                                ((RETRY_AFTER_KEY,
                                  f"{e.retry_after_s:.3f}"),)
                            )
                            context.abort(
                                grpc.StatusCode.RESOURCE_EXHAUSTED, str(e)
                            )
                        except DeadlineExpired as e:
                            context.abort(
                                grpc.StatusCode.DEADLINE_EXCEEDED, str(e)
                            )
                        except WhatIfBusyError as e:
                            context.abort(
                                grpc.StatusCode.RESOURCE_EXHAUSTED, str(e)
                            )
                        except FencedError as e:
                            context.abort(
                                grpc.StatusCode.FAILED_PRECONDITION, str(e)
                            )
                        finally:
                            if token is not None:
                                _CALL_DEADLINE.reset(token)

                return grpc.unary_unary_rpc_method_handler(
                    unary, request_deserializer=bytes, response_serializer=bytes
                )

        server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        server.add_generic_rpc_handlers((Handler(),))
        if tls is not None:
            cert_file, key_file = tls
            with open(cert_file, "rb") as f:
                cert = f.read()
            with open(key_file, "rb") as f:
                key = f.read()
            creds = grpc.ssl_server_credentials(((key, cert),))
            bound_port = server.add_secure_port(f"127.0.0.1:{port}", creds)
        else:
            bound_port = server.add_insecure_port(f"127.0.0.1:{port}")
        server.start()
        return server, bound_port


# Channel options for clients that must notice a healed partition
# promptly. gRPC's default reconnect backoff grows to 120s: a few severed
# connection attempts during a short partition push the next connect out
# by minutes, during which every RPC fails fast on the cached error while
# the wire is actually fine (found by the netchaos drive). An executor
# agent's whole partition protocol (lease TTL, fence recovery) assumes
# reconnection is attempted within seconds of the heal.
CHANNEL_OPTIONS = (
    ("grpc.min_reconnect_backoff_ms", 200),
    ("grpc.max_reconnect_backoff_ms", 5000),
    ("grpc.keepalive_time_ms", 30000),
    ("grpc.keepalive_timeout_ms", 10000),
)


def _retrying_call(invoke, retry_budget_s: float, seed: int = 0):
    """Shared client retry loop: a RESOURCE_EXHAUSTED reply carrying the
    server's `retry-after` trailing metadata (front-door shedding) is
    retried after max(server hint, jittered exponential delay), with the
    CUMULATIVE sleep capped by `retry_budget_s` — the executor-agent
    lease path's bounded-backoff discipline applied to submit clients.
    Every other failure (other codes, or exhaustion without a hint, e.g.
    a full what-if backlog) raises immediately, as before."""
    import grpc

    from .chaos import ExponentialBackoff

    backoff = None
    while True:
        try:
            return invoke()
        except grpc.RpcError as e:
            retry_after = _retry_after_of(e)
            if retry_after is None or retry_budget_s <= 0:
                raise
            if backoff is None:
                backoff = ExponentialBackoff(
                    base_s=0.05, cap_s=5.0, seed=seed,
                    budget_s=retry_budget_s,
                )
            if backoff.exhausted:
                raise
            jitter = backoff.next_delay()
            # Clamp the server hint to the REMAINING budget (not the
            # whole budget) so cumulative sleep stays <= retry_budget_s.
            remaining = max(0.0, retry_budget_s - backoff.spent_s)
            delay = max(jitter, min(retry_after, remaining))
            # The server hint may exceed the jittered delay; charge the
            # surplus against the budget so the streak stays bounded.
            backoff.spent_s += max(0.0, delay - jitter)
            if delay > 0:
                _time.sleep(delay)


class ApiClient:
    """Python client for the gRPC API (pkg/client + client/python analogue).

    Credentials: pass `token=` (Bearer JWT) or `basic=(user, password)` —
    the client attaches the authorization metadata the server's auth chain
    expects (client/rust/src/auth.rs plays the same role).

    Shed responses (RESOURCE_EXHAUSTED with the server's `retry-after`
    hint) are retried with a bounded, jittered backoff; `retry_budget_s`
    caps the cumulative sleep per call (0 disables retries)."""

    def __init__(self, target: str, token: str | None = None, basic=None,
                 ca_cert: str | None = None, retry_budget_s: float = 30.0,
                 retry_seed: int = 0):
        import grpc

        options = list(CHANNEL_OPTIONS)
        if ca_cert:
            with open(ca_cert, "rb") as f:
                creds = grpc.ssl_channel_credentials(root_certificates=f.read())
            self.channel = grpc.secure_channel(target, creds, options=options)
        else:
            self.channel = grpc.insecure_channel(target, options=options)
        self.retry_budget_s = retry_budget_s
        self._retry_seed = retry_seed
        self._metadata: list = []
        if token:
            self._metadata = [("authorization", f"Bearer {token}")]
        elif basic:
            import base64

            user, password = basic
            cred = base64.b64encode(f"{user}:{password}".encode()).decode()
            self._metadata = [("authorization", f"Basic {cred}")]

    def _call(self, method: str, request: dict, timeout: float | None = None):
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=bytes,
            response_deserializer=bytes,
        )

        def invoke():
            return _decode(
                fn(
                    _encode(request),
                    metadata=_inject_traceparent(self._metadata) or None,
                    timeout=timeout,
                )
            )

        return _retrying_call(
            invoke, self.retry_budget_s, seed=self._retry_seed
        )

    def submit_jobs(self, queue, jobset, jobs: list[dict],
                    deadline_s: float | None = None):
        """`deadline_s` sets a gRPC deadline on the call; the server
        propagates it through the admission gate and the ingest enqueue
        (expired work is dropped early, never half-applied)."""
        return self._call(
            "SubmitJobs", {"queue": queue, "jobset": jobset, "jobs": jobs},
            timeout=deadline_s,
        )["job_ids"]

    def cancel_jobs(self, queue, jobset, job_ids=(), cancel_jobset=False, reason=""):
        self._call(
            "CancelJobs",
            {
                "queue": queue,
                "jobset": jobset,
                "job_ids": list(job_ids),
                "cancel_jobset": cancel_jobset,
                "reason": reason,
            },
        )

    def reprioritize_jobs(self, queue, jobset, job_ids, priority):
        self._call(
            "ReprioritizeJobs",
            {
                "queue": queue,
                "jobset": jobset,
                "job_ids": list(job_ids),
                "priority": priority,
            },
        )

    def create_queue(self, name, priority_factor=1.0, cordoned=False):
        self._call(
            "CreateQueue",
            {"name": name, "priority_factor": priority_factor, "cordoned": cordoned},
        )

    def update_queue(self, name, priority_factor=None, cordoned=None):
        self._call(
            "UpdateQueue",
            {"name": name, "priority_factor": priority_factor, "cordoned": cordoned},
        )

    def delete_queue(self, name):
        self._call("DeleteQueue", {"name": name})

    def get_queue(self, name):
        return self._call("GetQueue", {"name": name})

    def list_queues(self):
        return self._call("ListQueues", {})["queues"]

    def get_jobs(self, filters=(), order_field="submitted", order_direction="asc",
                 skip=0, take=100):
        return self._call(
            "GetJobs",
            {
                "filters": list(filters),
                "order_field": order_field,
                "order_direction": order_direction,
                "skip": skip,
                "take": take,
            },
        )

    def group_jobs(self, group_by, filters=(), aggregates=()):
        return self._call(
            "GroupJobs",
            {"group_by": group_by, "filters": list(filters),
             "aggregates": list(aggregates)},
        )["groups"]

    def scheduling_report(self):
        return self._call("SchedulingReport", {})["report"]

    def queue_report(self, queue):
        return self._call("QueueReport", {"queue": queue})["report"]

    def job_report(self, job_id):
        return self._call("JobReport", {"job_id": job_id})["report"]

    def slo_status(self):
        """Declared SLOs + compliance + burn rates (services/slo.py)."""
        return self._call("SLOStatus", {})

    def doctor(self):
        """Self-healing-solve state: failover ladder breaker states,
        recent round rejections (+ quarantine bundle paths), recent
        failovers (scheduler.doctor_report; GET /api/doctor serves the
        same)."""
        return self._call("Doctor", {})

    def fairness_report(self, pool=None):
        """Fairness observatory document: {"pools": {pool: {ledger,
        preemptions, alerts...}}, "alerts": [...]}
        (observe/fairness.py; GET /api/fairness serves the same)."""
        return self._call("FairnessReport", {"pool": pool or ""})

    def job_trace(self, job_id):
        """The job's end-to-end journey: {"journey": <dict>, "rendered":
        <text timeline>} (services/job_timeline.py)."""
        return self._call("JobTrace", {"job_id": job_id})

    def set_priority_override(self, queue, priority_factor):
        self._call(
            "SetPriorityOverride",
            {"queue": queue, "priority_factor": priority_factor},
        )

    def list_priority_overrides(self):
        return self._call("ListPriorityOverrides", {})["overrides"]

    def policy_show(self, pool=None):
        """Active fairness policy per pool: {"default", "overrides",
        "pools": {pool: policy}} (solver/policy.py)."""
        return self._call("PolicyShow", {"pool": pool or ""})

    def policy_set(self, pool, policy, force=False, scorecard=None):
        """Flip (policy string) or clear (policy None/"") a pool's
        fairness policy. Non-DRF flips need a registered shadow
        scorecard unless force=True (the divergence gate)."""
        return self._call(
            "PolicySet",
            {
                "pool": pool,
                "policy": policy or "",
                "force": bool(force),
                "scorecard": scorecard,
            },
        )

    def get_job_logs(self, job_id, tail_lines=100):
        return self._call("GetJobLogs", {"job_id": job_id, "tail_lines": tail_lines})[
            "lines"
        ]

    def what_if(self, mutations, pool=None, solver=None, rounds=None):
        """Shadow-solve hypothetical edits against the live round fork:
        {"plan": <structured plan>, "rendered": <text>}. `mutations` is
        a list of {"kind": ..., ...} dicts (whatif/mutations.py)."""
        return self._call(
            "WhatIf",
            {
                "mutations": list(mutations),
                "pool": pool or "",
                "solver": solver or "",
                "rounds": rounds or 0,
            },
        )

    def plan_drain(self, executor, pool=None, solver=None, rounds=None,
                   deadline_s=None):
        return self._call(
            "PlanDrain",
            {
                "executor": executor,
                "pool": pool or "",
                "solver": solver or "",
                "rounds": rounds or 0,
                "deadline_s": deadline_s,
            },
        )

    def execute_drain(self, executor, deadline_s=None, status_only=False):
        return self._call(
            "ExecuteDrain",
            {
                "executor": executor,
                "deadline_s": deadline_s,
                "status_only": bool(status_only),
            },
        )["status"]

    def cordon_node(self, node_id, uncordon=False):
        self._call("CordonNode", {"node_id": node_id, "uncordon": uncordon})

    def cordon_executor(self, executor, uncordon=False):
        self._call(
            "CordonExecutor", {"executor": executor, "uncordon": uncordon}
        )

    def watch_jobset(self, queue, jobset, from_offset=0, watch=True):
        fn = self.channel.unary_stream(
            f"/{SERVICE}/WatchJobSet",
            request_serializer=bytes,
            response_deserializer=bytes,
        )
        stream = fn(
            _encode(
                {"queue": queue, "jobset": jobset, "from_offset": from_offset,
                 "watch": watch}
            ),
            metadata=_inject_traceparent(self._metadata) or None,
        )
        for msg in stream:
            yield _decode(msg)


def connect(target: str, ca_cert: str | None = None,
            token: str | None = None) -> ApiClient:
    """Env-aware client factory (pkg/client ApiConnectionDetails
    analogue): TLS when a CA bundle is given (flag or ARMADA_CA_CERT),
    Bearer token from ARMADA_TOKEN when present — the client-side half
    of the server's TLS + auth chain (client/rust/src/auth.rs role)."""
    import os

    ca_cert = ca_cert or os.environ.get("ARMADA_CA_CERT") or None
    token = token or os.environ.get("ARMADA_TOKEN") or None
    return ApiClient(target, ca_cert=ca_cert, token=token)


class ProtoApiClient:
    """Binary-protobuf client over proto/armada.proto — what a codegen
    client in any protobuf language looks like against this server (the
    reference's generated pkg/api clients). Python builds it from the
    same generated armada_pb2 the server uses."""

    def __init__(self, target: str, token: str | None = None, basic=None,
                 ca_cert: str | None = None, retry_budget_s: float = 30.0,
                 retry_seed: int = 0):
        import grpc

        options = list(CHANNEL_OPTIONS)
        if ca_cert:
            with open(ca_cert, "rb") as f:
                creds = grpc.ssl_channel_credentials(root_certificates=f.read())
            self.channel = grpc.secure_channel(target, creds, options=options)
        else:
            self.channel = grpc.insecure_channel(target, options=options)
        # Shed responses retry like ApiClient: bounded jittered backoff
        # honoring the server's retry-after hint.
        self.retry_budget_s = retry_budget_s
        self._retry_seed = retry_seed
        # Same credential surface as ApiClient: Bearer or Basic metadata
        # for the server's auth chain.
        self._metadata: list = []
        if token:
            self._metadata = [("authorization", f"Bearer {token}")]
        elif basic:
            import base64

            user, password = basic
            cred = base64.b64encode(f"{user}:{password}".encode()).decode()
            self._metadata = [("authorization", f"Basic {cred}")]

    def _unary(self, method: str, request, resp_type,
               timeout: float | None = None):
        fn = self.channel.unary_unary(
            f"/{PROTO_SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_type.FromString,
        )

        def invoke():
            return fn(
                request,
                metadata=_inject_traceparent(self._metadata) or None,
                timeout=timeout,
            )

        return _retrying_call(
            invoke, self.retry_budget_s, seed=self._retry_seed
        )

    def submit_jobs(self, queue: str, jobset: str, items) -> list[str]:
        from ..proto import armada_pb2 as pb

        req = pb.JobSubmitRequest(queue=queue, jobset=jobset)
        for item in items:
            req.jobs.append(item)
        return list(
            self._unary("SubmitJobs", req, pb.JobSubmitResponse).job_ids
        )

    def cancel_jobs(self, queue, jobset, job_ids=(), cancel_jobset=False,
                    reason=""):
        from ..proto import armada_pb2 as pb

        self._unary(
            "CancelJobs",
            pb.JobCancelRequest(
                queue=queue, jobset=jobset, job_ids=list(job_ids),
                cancel_jobset=cancel_jobset, reason=reason,
            ),
            pb.JobCancelResponse,
        )

    def reprioritize_jobs(self, queue, jobset, job_ids, priority):
        from ..proto import armada_pb2 as pb

        self._unary(
            "ReprioritizeJobs",
            pb.JobReprioritizeRequest(
                queue=queue, jobset=jobset, job_ids=list(job_ids),
                priority=priority,
            ),
            pb.JobReprioritizeResponse,
        )

    @staticmethod
    def _whatif_mutation_fields(m: dict) -> dict:
        """JSON-vocabulary mutation dict -> WhatIfMutation field kwargs.
        The proto message carries cpu/memory/gpu scalars instead of the
        JSON wire's `requests` map; translate the common keys and refuse
        anything the binary wire cannot express."""
        m = dict(m)
        requests = m.pop("requests", None) or {}
        scalar_of = {"cpu": "cpu", "memory": "memory", "nvidia.com/gpu": "gpu"}
        for key, value in requests.items():
            field = scalar_of.get(key)
            if field is None:
                raise ValueError(
                    f"the proto wire cannot express request {key!r}; use "
                    "the JSON wire (ApiClient.what_if) for arbitrary "
                    "resource maps"
                )
            m.setdefault(field, str(value))
        for key in ("node_selector", "labels"):
            if m.pop(key, None):
                raise ValueError(
                    f"the proto wire cannot express {key!r}; use the JSON "
                    "wire (ApiClient.what_if)"
                )
        return m

    def what_if(self, mutations, pool="", solver="", rounds=0) -> dict:
        """WhatIf over the binary wire; returns the decoded plan dict
        (the JSON wire's {"plan", "rendered"} shape)."""
        from ..proto import armada_pb2 as pb

        req = pb.WhatIfRequest(pool=pool, solver=solver, rounds=rounds)
        for m in mutations:
            req.mutations.add(**self._whatif_mutation_fields(m))
        resp = self._unary("WhatIf", req, pb.WhatIfResponse)
        return {
            "plan": json.loads(resp.plan_json) if resp.plan_json else {},
            "rendered": resp.rendered,
        }

    def plan_drain(self, executor, pool="", solver="", rounds=0,
                   deadline_s=0.0) -> dict:
        from ..proto import armada_pb2 as pb

        resp = self._unary(
            "PlanDrain",
            pb.PlanDrainRequest(
                executor=executor, pool=pool, solver=solver, rounds=rounds,
                deadline_s=deadline_s,
            ),
            pb.PlanDrainResponse,
        )
        return {
            "plan": json.loads(resp.plan_json) if resp.plan_json else {},
            "rendered": resp.rendered,
        }

    def execute_drain(self, executor, deadline_s=0.0,
                      status_only=False) -> dict:
        from ..proto import armada_pb2 as pb

        resp = self._unary(
            "ExecuteDrain",
            pb.ExecuteDrainRequest(
                executor=executor, deadline_s=deadline_s,
                status_only=status_only,
            ),
            pb.ExecuteDrainResponse,
        )
        return json.loads(resp.status_json) if resp.status_json else {}

    def watch_jobset(self, queue, jobset, from_offset=0, follow=True):
        """Yields (offset, events.model.EventSequence)."""
        from ..proto import armada_pb2 as pb, sequence_from_proto

        fn = self.channel.unary_stream(
            f"/{PROTO_SERVICE}/WatchJobSet",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.EventSequenceEntry.FromString,
        )
        stream = fn(
            pb.WatchRequest(
                queue=queue, jobset=jobset, from_offset=from_offset,
                follow=follow,
            ),
            metadata=self._metadata or None,
        )
        for entry in stream:
            yield sequence_from_proto(entry)
