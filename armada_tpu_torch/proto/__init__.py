"""Protobuf wire format (proto/armada.proto).

The JSON-over-gRPC API remains the default; this package adds the binary
encoding the reference exposes (pkg/api/submit.proto:356-401,
pkg/armadaevents/events.proto:66-97) so codegen clients in any protobuf
language build against proto/armada.proto and interoperate with the same
server method table (services/grpc_api.py hosts both encodings).

`armada_pb2.py` is generated — regenerate after editing the schema:

    protoc --python_out=armada_tpu_torch/proto --proto_path=proto proto/armada.proto

(or `python -m armada_tpu_torch.tools.gen_proto --write`, which needs no
protoc). It is byte for byte the JAX package's bindings of the same
schema, so both packages' messages share one descriptor in a process.

The converters below bridge the event model (events/model.py dataclasses)
and the proto messages; request/response messages bridge via
google.protobuf.json_format (field names match the JSON wire exactly).
"""

from __future__ import annotations

import re

from . import armada_pb2 as pb

_SNAKE = re.compile(r"(?<!^)(?=[A-Z])")

# Event dataclass name -> oneof field name (SubmitJob -> submit_job).
_EVENT_FIELDS = {
    name: _SNAKE.sub("_", name).lower()
    for name in (
        "SubmitJob",
        "CancelJob",
        "CancelJobSet",
        "ReprioritiseJob",
        "JobRunLeased",
        "JobRunPending",
        "JobRunRunning",
        "JobRunSucceeded",
        "JobRunErrors",
        "JobRunPreempted",
        "JobSucceeded",
        "JobErrors",
        "JobRequeued",
    )
}
_FIELD_EVENTS = {v: k for k, v in _EVENT_FIELDS.items()}


def job_spec_to_proto(spec) -> pb.JobSpecMsg:
    msg = pb.JobSpecMsg(
        id=spec.id,
        queue=spec.queue,
        jobset=spec.jobset,
        priority=int(spec.priority),
        priority_class=spec.priority_class,
        submitted_ts=float(spec.submitted_ts),
    )
    msg.requests.update({k: str(v) for k, v in spec.requests.items()})
    msg.node_selector.update(spec.node_selector)
    msg.annotations.update(spec.annotations)
    msg.command.extend(spec.command)
    for t in spec.tolerations:
        msg.tolerations.add(
            key=t.key, operator=t.operator, value=t.value, effect=t.effect
        )
    if spec.affinity is not None:
        for term in spec.affinity.terms:
            pterm = msg.affinity.terms.add()
            for e in term.expressions:
                pterm.expressions.add(
                    key=e.key, operator=e.operator, values=list(e.values)
                )
    if spec.gang is not None:
        msg.gang.id = spec.gang.id
        msg.gang.cardinality = int(spec.gang.cardinality)
        msg.gang.node_uniformity_label = spec.gang.node_uniformity_label
    for pool, v in spec.bid_prices.items():
        if isinstance(v, (tuple, list)) and len(v) == 2:
            q, r = float(v[0]), float(v[1])
        else:
            try:
                q = r = float(v)
            except (TypeError, ValueError):
                q = r = 0.0
        msg.bid_prices[pool].queued = q
        msg.bid_prices[pool].running = r
    msg.pools.extend(spec.pools)
    for svc in spec.services:
        msg.services.add(type=svc.type, ports=[int(p) for p in svc.ports])
    for ing in spec.ingresses:
        ping = msg.ingresses.add(
            ports=[int(p) for p in ing.ports], tls_enabled=ing.tls_enabled
        )
        ping.annotations.update(dict(ing.annotations))
    return msg


def job_spec_from_proto(msg: pb.JobSpecMsg):
    from ..core.types import (
        Affinity,
        Gang,
        IngressConfig,
        JobSpec,
        MatchExpression,
        NodeSelectorTerm,
        ServiceConfig,
        Toleration,
    )

    affinity = None
    if msg.HasField("affinity") and msg.affinity.terms:
        affinity = Affinity(
            terms=tuple(
                NodeSelectorTerm(
                    expressions=tuple(
                        MatchExpression(
                            key=e.key,
                            operator=e.operator,
                            values=tuple(e.values),
                        )
                        for e in term.expressions
                    )
                )
                for term in msg.affinity.terms
            )
        )
    gang = None
    if msg.HasField("gang") and msg.gang.id:
        gang = Gang(
            id=msg.gang.id,
            cardinality=int(msg.gang.cardinality),
            node_uniformity_label=msg.gang.node_uniformity_label,
        )
    return JobSpec(
        id=msg.id,
        queue=msg.queue,
        jobset=msg.jobset,
        priority=int(msg.priority),
        priority_class=msg.priority_class,
        requests=dict(msg.requests),
        node_selector=dict(msg.node_selector),
        pools=tuple(msg.pools),
        bid_prices={
            k: (v.queued, v.running) for k, v in msg.bid_prices.items()
        },
        tolerations=tuple(
            Toleration(
                key=t.key, operator=t.operator, value=t.value, effect=t.effect
            )
            for t in msg.tolerations
        ),
        affinity=affinity,
        gang=gang,
        submitted_ts=float(msg.submitted_ts),
        annotations=dict(msg.annotations),
        command=tuple(msg.command),
        services=tuple(
            ServiceConfig(type=s.type, ports=tuple(s.ports))
            for s in msg.services
        ),
        ingresses=tuple(
            IngressConfig(
                ports=tuple(i.ports),
                annotations=tuple(sorted(i.annotations.items())),
                tls_enabled=i.tls_enabled,
            )
            for i in msg.ingresses
        ),
    )


def sequence_to_proto(offset: int, seq) -> pb.EventSequenceEntry:
    """events.model.EventSequence -> EventSequenceEntry message."""
    entry = pb.EventSequenceEntry(offset=int(offset))
    out = entry.sequence
    out.queue, out.jobset, out.user = seq.queue, seq.jobset, seq.user
    for event in seq.events:
        name = type(event).__name__
        field = _EVENT_FIELDS.get(name)
        if field is None:
            continue  # control-plane-only events stay on the JSON wire
        pev = getattr(out.events.add(), field)
        pev.created = float(event.created)
        for fname in type(pev).DESCRIPTOR.fields_by_name:
            if fname in ("created", "job"):
                continue
            value = getattr(event, fname, None)
            if value is not None:
                setattr(pev, fname, value)
        if hasattr(event, "job") and event.job is not None:
            pev.job.CopyFrom(job_spec_to_proto(event.job))
    return entry


def sequence_from_proto(entry: pb.EventSequenceEntry):
    """EventSequenceEntry message -> (offset, events.model.EventSequence)."""
    from .. import events as ev

    events = []
    for pevent in entry.sequence.events:
        field = pevent.WhichOneof("event")
        if field is None:
            continue
        pev = getattr(pevent, field)
        cls = getattr(ev, _FIELD_EVENTS[field])
        kwargs = {"created": float(pev.created)}
        for fname in type(pev).DESCRIPTOR.fields_by_name:
            if fname in ("created", "job"):
                continue
            kwargs[fname] = getattr(pev, fname)
        if field == "submit_job":
            kwargs["job"] = job_spec_from_proto(pev.job)
        events.append(cls(**kwargs))
    return int(entry.offset), ev.EventSequence(
        queue=entry.sequence.queue,
        jobset=entry.sequence.jobset,
        user=entry.sequence.user,
        events=tuple(events),
    )
