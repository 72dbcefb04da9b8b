"""The port's wire (armada_tpu_torch/services/grpc_api.py: the ApiServer
and its JSON and binary-protobuf encodings, ApiClient, ProtoApiClient,
ProtoExecutorClient; proto/, the converters and bindings;
tools/gen_proto.py) and its control plane (services/server.py,
ControlPlane) against the JAX package's, on the CPU.

Port copies, side by side (`torch_control_plane.run_side_by_side`), each
case's own assertions holding on both packages:
- tests/test_api.py, 15 of its 16 cases (`test_cli_against_server`
  drives clients/cli.py, which the port has not written);
- tests/test_proto.py, its cases but `test_codegen_bindings_current`
  (the JAX package's Java and C# bindings; the port needs the Python
  ones, held below);
- tests/test_executor_proto_wire.py.
The leases after every cycle are compared where both packages' cycles
see the same jobs at the same instants: not where a started
ControlPlane cycles on the wall clock in a thread of its own, nor where
the submit service draws the jobs' ids at random (a job dict or proto
item without an id), so that the job databases hold different keys.

Direct twins, exact:
- the port's bindings are the reference's, byte for byte, and its
  gen_proto's --check passes on them; the proto converters give the
  same bytes for the same specs and event sequences;
- across the wire: the JAX package's ApiClient and ProtoApiClient against
  the port's ApiServer, and the port's against the JAX package's, make
  the same session of calls (queues, JSON and proto submits, executor
  lease and report exchanges, queries, reports, the JSON and proto
  watch streams, cancel and reprioritise, the anti-entropy sync, the
  proto lease) as a package's clients against its own server; the
  replies are equal after `_decode`, and the proto replies and stream
  messages equal as serialized bytes. Ids drawn at random (run ids,
  proto-submitted job ids, trace and span ids) are replaced by
  placeholders of the same length, in the order each package drew them;
  the wall clock is held fixed (the submit service stamps it).
"""

import importlib
import re
import time

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import plain, port_copy, run_ids_of, run_side_by_side

REF_PKG, PORT_PKG = "armada_tpu", "armada_tpu_torch"
NOW = 1_000_000.0

# Cases compared without their cycle histories (see the module docstring).
UNCOMPARED = {
    "test_api": {"test_queue_crud", "test_submit_and_lifecycle_over_grpc", "test_watch_stream",
                 "test_cancel_over_grpc", "test_scheduling_report",
                 "test_binoculars_logs_and_cordon", "test_priority_override",
                 "test_lookout_http", "test_remote_executor_agent",
                 "test_executor_agent_restart_reconciliation",
                 "test_cordon_executor_over_grpc", "test_whatif_rpcs_both_wires"},
    "test_proto": {"test_proto_service_shares_the_method_table", "test_proto_watch_stream",
                   "test_proto_submit_affinity_and_zero_priority"},
    "test_executor_proto_wire": {"test_proto_executor_lifecycle"},
}
WAITING = {("test_api", "test_cli_against_server"), ("test_proto", "test_codegen_bindings_current")}


def _cases():
    out = []
    for name in ("test_api", "test_proto", "test_executor_proto_wire"):
        ref = importlib.import_module(name)
        out += [(name, t) for t in sorted(vars(ref))
                if t.startswith("test_") and (name, t) not in WAITING]
    return out


CASES = _cases()


def test_case_list_is_whole():
    assert len([c for c in CASES if c[0] == "test_api"]) == 15
    assert len([c for c in CASES if c[0] == "test_proto"]) == 5
    for name, tests in UNCOMPARED.items():
        assert tests <= {t for n, t in CASES if n == name}


@pytest.mark.parametrize("name,test", CASES, ids=[f"{n}::{t}" for n, t in CASES])
def test_wire_case_matches_reference(name, test, monkeypatch, tmp_path):
    run_side_by_side(name, test, monkeypatch, tmp_path,
                     cycles=test not in UNCOMPARED.get(name, ()))


# ---- proto bindings and converters ----


def test_gen_proto_check_passes_on_port_bindings(capsys):
    from armada_tpu_torch.tools import gen_proto

    assert gen_proto.PB2_PATH.endswith("armada_tpu_torch/proto/armada_pb2.py")
    assert gen_proto.updated_descriptor()[1] == []
    assert gen_proto.main(["--check"]) == 0
    assert "up to date" in capsys.readouterr().out


def test_bindings_are_the_reference_bindings():
    import armada_tpu.proto.armada_pb2 as ref_pb
    import armada_tpu_torch.proto.armada_pb2 as port_pb

    with open(ref_pb.__file__, "rb") as f, open(port_pb.__file__, "rb") as g:
        assert f.read() == g.read()
    assert port_pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    # One schema, one descriptor in the process: the messages are shared.
    assert port_pb.JobSubmitRequest is ref_pb.JobSubmitRequest


def test_proto_converters_match_reference():
    from torch_control_plane import to_reference

    from armada_tpu import proto as ref_proto
    from armada_tpu_torch import events as ev
    from armada_tpu_torch import proto as port_proto
    from armada_tpu_torch.core.types import (
        Affinity, Gang, IngressConfig, JobSpec, MatchExpression, NodeSelectorTerm,
        ServiceConfig, Toleration)

    spec = JobSpec(
        id="j0", queue="q", jobset="s", priority=4, priority_class="d",
        requests={"cpu": "2", "memory": "4Gi"}, node_selector={"zone": "a"},
        tolerations=(Toleration(key="gpu", operator="Equal", value="true",
                                effect="NoSchedule"),),
        affinity=Affinity(terms=(NodeSelectorTerm(expressions=(
            MatchExpression(key="rack", operator="In", values=("r1", "r2")),)),)),
        gang=Gang(id="g0", cardinality=2, node_uniformity_label="rack"),
        submitted_ts=12.5, annotations={"owner": "x"}, command=("/bin/true",),
        services=(ServiceConfig(type="Headless", ports=(8080,)),),
        ingresses=(IngressConfig(ports=(8080,), annotations=(("n", "t"),), tls_enabled=True),),
        bid_prices={"default": (1.5, 2.5)}, pools=("default",))
    got = port_proto.job_spec_to_proto(spec).SerializeToString()
    assert got == ref_proto.job_spec_to_proto(to_reference(spec)).SerializeToString()
    assert port_proto.job_spec_from_proto(port_proto.job_spec_to_proto(spec)) == spec
    seq = ev.EventSequence.of(
        "q", "s",
        ev.SubmitJob(created=1.0, job=spec, deduplication_id="dd"),
        ev.JobRunLeased(created=2.0, job_id="j0", run_id="r0", executor="e", node_id="n",
                        pool="default", scheduled_at_priority=1000),
        ev.JobRunPending(created=3.0, job_id="j0", run_id="r0"),
        ev.JobRunErrors(created=4.0, job_id="j0", run_id="r0", error="boom",
                        retryable=False, debug='{"rc": 1}'),
        ev.CancelJob(created=5.0, job_id="j0", reason="r"),
        ev.ReprioritiseJob(created=6.0, job_id="j0", priority=3),
        traceparent="00-" + "a" * 32 + "-" + "b" * 16 + "-01")
    got = port_proto.sequence_to_proto(7, seq).SerializeToString()
    assert got == ref_proto.sequence_to_proto(7, to_reference(seq)).SerializeToString()
    offset, back = port_proto.sequence_from_proto(port_proto.sequence_to_proto(7, seq))
    ref_back = ref_proto.sequence_from_proto(ref_proto.sequence_to_proto(7, to_reference(seq)))
    # The proto message carries no trace context, in either package.
    assert (offset, plain(back)) == (ref_back[0], plain(ref_back[1]))
    assert plain(back.events) == plain(seq.events)


# ---- across the wire ----


class Served:
    """One package's ApiServer on a gRPC port: an in-memory log, a
    scheduler service on the host oracle, a submit service, the query
    API, binoculars and the event-stream index."""

    def __init__(self, pkg, backend="oracle"):
        def m(path):
            return importlib.import_module(f"{pkg}.{path}")

        config = m("core.config")
        cfg = config.SchedulingConfig(
            priority_classes={"d": config.PriorityClass("d", 1000, preemptible=True)},
            default_priority_class="d")
        self.log = m("events").InMemoryEventLog()
        kw = {"device": "cpu"} if pkg == PORT_PKG else {}
        self.sched = m("services.scheduler").SchedulerService(cfg, self.log, backend=backend, **kw)
        self.submit = m("services.submit").SubmitService(cfg, self.log, scheduler=self.sched)
        query = m("services.queryapi").QueryApi(self.sched.jobdb, timeline=self.sched.timeline)
        self.api = m("services.grpc_api").ApiServer(
            self.submit, self.sched, query, self.log,
            binoculars=m("services.binoculars").BinocularsService(self.sched, []),
            event_index=m("services.event_index").EventStreamIndex(self.log))
        self.server, port = self.api.serve(0)
        self.address = f"127.0.0.1:{port}"

    def close(self):
        self.server.stop(grace=0)


_TRACE = re.compile(r"[0-9a-f]{32}|(?<![0-9a-f])[0-9a-f]{16}(?![0-9a-f])")
_TRACE_B = re.compile(rb"[0-9a-f]{32}|(?<![0-9a-f])[0-9a-f]{16}(?![0-9a-f])")


def _scrubbed(value, names):
    """`value` in the plain form with each random id of `names` (id ->
    placeholder of its length) and every trace or span id replaced."""
    if isinstance(value, str):
        for rid, name in names.items():
            value = value.replace(rid, name)
        return _TRACE.sub(lambda x: "t" * len(x.group()), value)
    if isinstance(value, bytes):
        for rid, name in names.items():
            value = value.replace(rid.encode(), name.encode())
        return _TRACE_B.sub(lambda x: b"t" * len(x.group()), value)
    if isinstance(value, dict):
        return {_scrubbed(k, names): _scrubbed(v, names) for k, v in value.items()}
    if isinstance(value, (tuple, frozenset)):
        return type(value)(_scrubbed(v, names) for v in value)
    return value


def _placeholder(prefix, k, length):
    return f"{prefix}{k}".ljust(length, "_")[:length]


def _session(client_pkg, served):
    """The session of calls a `client_pkg` client makes against `served`;
    returns (name, reply) pairs, replies in the plain form with the
    package's random ids replaced."""
    g = importlib.import_module(f"{client_pkg}.services.grpc_api")
    pb = importlib.import_module(f"{client_pkg}.proto.armada_pb2")
    c, p = g.ApiClient(served.address), g.ProtoApiClient(served.address)
    out = []
    c.create_queue("q1", 1.0)
    c.create_queue("q2", priority_factor=2.0)
    out.append(("get_queue", c.get_queue("q1")))
    out.append(("list_queues", c.list_queues()))
    out.append(("submit", c.submit_jobs("q1", "s1", [
        {"id": f"j{i}", "priority": i % 2, "requests": {"cpu": str(1 + i % 3), "memory": "1Gi"},
         "annotations": {"k": str(i)}, "node_selector": {"zone": "a"} if i == 3 else {}}
        for i in range(5)])))
    item = pb.JobSubmitRequestItem(priority=1)
    item.requests["cpu"] = "1"
    item.requests["memory"] = "1Gi"
    item.annotations["via"] = "proto"
    second = pb.JobSubmitRequestItem()
    second.CopyFrom(item)
    second.priority = 2  # distinct, so no order among them rests on their random ids
    proto_ids = p.submit_jobs("q2", "s2", [item, second])
    node = {"id": "n0", "total_resources": {"cpu": "8", "memory": "32Gi"},
            "labels": {"zone": "a"}, "taints": []}

    def lease(acked=()):
        return c._call("ExecutorLease", {"executor": "e0", "pool": "default", "nodes": [node],
                                         "acked_run_ids": list(acked), "fence_token": 0})

    out.append(("lease0", lease()))
    served.sched.cycle(now=NOW + 1)
    reply = lease()
    out.append(("lease1", reply))
    runs = [(x["run_id"], x["job_id"], x["queue"], x["jobset"]) for x in reply["leases"]]
    c._call("ReportEvents", {"executor": "e0", "fence_token": reply["fence_token"], "events": [
        {"type": "pending", "job_id": j, "run_id": r, "queue": q, "jobset": s,
         "created": NOW + 2} for r, j, q, s in runs]})
    served.sched.cycle(now=NOW + 3)
    out.append(("lease2", lease([r for r, _, _, _ in runs])))
    out.append(("get_jobs", c.get_jobs(filters=[{"field": "queue", "value": "q1"}])))
    out.append(("group_jobs", c.group_jobs("state")))
    out.append(("group_queue", c.group_jobs("queue", aggregates=["state_counts"])))
    out.append(("scheduling_report", c.scheduling_report()))
    out.append(("queue_report", c.queue_report("q1")))
    out.append(("job_report", c.job_report("j0")))
    out.append(("doctor", c.doctor()))
    out.append(("fairness", c.fairness_report()))
    out.append(("policy_show", c.policy_show()))
    out.append(("watch", list(c.watch_jobset("q1", "s1", watch=False))))
    stream = p.channel.unary_stream(
        f"/{g.PROTO_SERVICE}/WatchJobSet", request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=bytes)
    out.append(("proto_watch", list(stream(pb.WatchRequest(queue="q2", jobset="s2",
                                                           from_offset=0, follow=False)))))
    out.append(("proto_watch_decoded", [(o, plain(s)) for o, s in
                                        p.watch_jobset("q1", "s1", follow=False)]))
    c.reprioritize_jobs("q1", "s1", ["j4"], 5)
    c.cancel_jobs("q1", "s1", ["j3"], reason="twin")
    p.reprioritize_jobs("q2", "s2", proto_ids[:1], 0)
    p.cancel_jobs("q2", "s2", proto_ids[1:], reason="twin")
    served.sched.cycle(now=NOW + 4)
    out.append(("get_jobs_q1", c.get_jobs(filters=[{"field": "queue", "value": "q1"}],
                                          order_field="submitted", order_direction="desc")))
    # The proto jobs' ids are drawn at random: order them by what differs.
    out.append(("get_jobs_q2", c.get_jobs(filters=[{"field": "queue", "value": "q2"}],
                                          order_field="priority")))
    out.append(("sync", c._call("ExecutorSync", {"executor": "e0", "runs": [
        {"run_id": r, "job_id": j, "phase": "pending"} for r, j, _, _ in runs]})))
    msg = pb.LeaseRequest(executor="e0", pool="default",
                          acked_run_ids=[r for r, _, _, _ in runs])
    n = msg.nodes.add(id="n0", name="n0")
    n.total_resources.update({"cpu": "8", "memory": "32Gi"})
    n.labels.update({"zone": "a"})
    out.append(("proto_lease", p._unary("ExecutorLease", msg, pb.LeaseResponse)
                .SerializeToString()))
    out.append(("proto_executor_lease", g.ProtoExecutorClient(served.address)._call(
        "ExecutorLease", {"executor": "e0", "pool": "default", "nodes": [node],
                          "acked_run_ids": []})))
    out.append(("queues_after", c.list_queues()))
    c.channel.close()
    p.channel.close()
    names = {jid: _placeholder("J", k, len(jid)) for k, jid in enumerate(proto_ids)}
    job_of = {r.id: j.id for j in served.sched.jobdb.read_txn().all_jobs() for r in j.runs}
    rids = sorted(run_ids_of(served.sched.jobdb), key=lambda r: names.get(job_of[r], job_of[r]))
    names.update({rid: _placeholder("R", k, len(rid)) for k, rid in enumerate(rids)})
    return [(name, _scrubbed(plain(reply), names)) for name, reply in out]


_BASE = {}


@pytest.fixture()
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def _run_session(client_pkg, server_pkg):
    served = Served(server_pkg)
    try:
        return _session(client_pkg, served)
    finally:
        served.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [
    (REF_PKG, PORT_PKG), (PORT_PKG, REF_PKG), (PORT_PKG, PORT_PKG)],
    ids=["reference-client-port-server", "port-client-reference-server",
         "port-client-port-server"])
def test_clients_across_packages(client_pkg, server_pkg, fixed_clock):
    """A session's replies are those of the JAX package's clients against
    its own server, call by call."""
    if "base" not in _BASE:
        _BASE["base"] = _run_session(REF_PKG, REF_PKG)
    want = _BASE["base"]
    got = _run_session(client_pkg, server_pkg)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a == b, name
    assert dict(want)["lease1"]["leases"] and dict(want)["sync"]["kept_run_ids"]


def test_port_copy_of_the_proto_module_imports_the_port():
    """The side-by-side copies above run the port: its module binds the
    port's client and control plane."""
    m = port_copy("test_proto")
    assert m.ProtoApiClient.__module__ == "armada_tpu_torch.services.grpc_api"
    assert m.ControlPlane.__module__ == "armada_tpu_torch.services.server"
