"""Executor agents across the wire (armada_tpu_torch/services/
executor_agent.py against the port's ApiServer, grpc_api.py, and the JAX
package's), on the CPU.

- Cross-package agents: the JAX package's ExecutorAgent leases from the
  port's ApiServer over a real gRPC channel, on the host oracle and on
  the kernel backend (the port's on the CPU, the reference's in JAX),
  on the JSON wire (ApiClient) and the binary one (ProtoExecutorClient).
  Cycle by cycle, its leases, the job database (run ids dropped) and its
  pods equal those of the JAX package's agent leasing from the JAX
  package's server; the port's agent leasing from the port's server
  gives them too.
- Loopback against gRPC: the port's agent through chip_smoke.py's
  `Loopback` (the JSON wire minus its socket: the codec and the method
  table) and through a real gRPC ApiClient gives equal leases, pods and
  job databases cycle by cycle.
- chip_smoke.py's phase 17 (`phase_wire`) at a CPU size: the two stacks,
  the REST submit behind the proxy with its partition window, the
  agents, the reads and the mutations, every check of the phase but the
  kernel launch counts (on the CPU the wrappers take their plain
  versions and count none).

Each run holds the wall clock fixed (the submit service and the lease
handler stamp it) and cycles at virtual instants; every job has an id.
"""

import importlib
import importlib.util
import os
import time

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import jobdb_view, leases_view, plain, to_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG, PORT_PKG = "armada_tpu", "armada_tpu_torch"
NOW = 1_000_000.0
CYCLES = 8


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture()
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


class Stack:
    """One package's scheduler, submit service and ApiServer, served on a
    gRPC port when `serve`."""

    def __init__(self, pkg, backend, serve=True):
        def m(path):
            return importlib.import_module(f"{pkg}.{path}")

        config = m("core.config")
        cfg = config.SchedulingConfig(
            priority_classes={"d": config.PriorityClass("d", 1000, preemptible=True)},
            default_priority_class="d")
        log = m("events").InMemoryEventLog()
        kw = {"device": "cpu"} if pkg == PORT_PKG else {}
        self.sched = m("services.scheduler").SchedulerService(cfg, log, backend=backend, **kw)
        self.submit = m("services.submit").SubmitService(cfg, log, scheduler=self.sched)
        self.api = m("services.grpc_api").ApiServer(
            self.submit, self.sched, m("services.queryapi").QueryApi(self.sched.jobdb), log)
        self.server, self.address = None, None
        if serve:
            self.server, port = self.api.serve(0)
            self.address = f"127.0.0.1:{port}"

    def close(self):
        if self.server is not None:
            self.server.stop(grace=0)


def _jobs():
    """Two queues' job dicts: 1 to 4 cpu, two priorities, zone pins."""
    out = {"qa": [], "qb": []}
    for i in range(24):
        q = "qa" if i % 3 else "qb"
        out[q].append({"id": f"job-{i:02d}", "priority": i % 2,
                       "requests": {"cpu": str(1 + i % 4), "memory": f"{1 + i % 3}Gi"},
                       "node_selector": {"zone": "a"} if i % 7 == 0 else {}})
    return out


def _nodes(name):
    return [{"id": f"{name}-n{k}", "total_resources": {"cpu": "8", "memory": "32Gi"},
             "labels": {"zone": "a" if k % 2 == 0 else "b"}} for k in range(3)]


def _drive(agent_pkg, stack, client_for):
    """Two agents of `agent_pkg` (clients from `client_for(pkg)`) ticking
    against `stack` for CYCLES cycles 10 virtual seconds apart, with a
    cancel and a reprioritise after the third; the history of leases,
    job database and pods after each cycle."""
    ea = importlib.import_module(f"{agent_pkg}.services.executor_agent")
    g = importlib.import_module(f"{agent_pkg}.services.grpc_api")
    submitter = client_for(g)
    submitter.create_queue("qa", 1.0)
    submitter.create_queue("qb", priority_factor=2.0)
    for q, jobs in _jobs().items():
        submitter.submit_jobs(q, f"set-{q}", jobs)
    agents = [ea.ExecutorAgent(client_for(g), name, _nodes(name),
                               runtime=ea._PodRuntime(runtime_s=25.0))
              for name in ("e0", "e1")]
    history = []
    for c in range(CYCLES):
        now = NOW + 10.0 * c
        for agent in agents:
            agent.tick(now)
        stack.sched.cycle(now=now)
        if c == 2:
            submitter.cancel_jobs("qa", "set-qa", ["job-01"], reason="twin")
            submitter.reprioritize_jobs("qb", "set-qb", ["job-21"], 0)
        history.append((
            leases_view(stack.sched.jobdb),
            jobdb_view(stack.sched.jobdb, run_ids=False),
            {a.name: sorted((p["job_id"], p["node"], p["phase"])
                            for p in a.runtime.pods.values()) for a in agents},
            # The heartbeat and node records the lease handler built.
            plain(stack.sched.executors),
        ))
    return history


def _grpc_client(wire, address):
    def client_for(g):
        if wire == "proto":
            return _ProtoAgentClient(g, address)
        return g.ApiClient(address)
    return client_for


class _ProtoAgentClient:
    """The binary wire for the agent's exchanges (ProtoExecutorClient)
    and the JSON one for the rest of the session's calls, which the
    proto schema has no messages for (queues)."""

    def __init__(self, g, address):
        self._proto = g.ProtoExecutorClient(address)
        self._json = g.ApiClient(address)

    def _call(self, method, req):
        if method in ("ExecutorLease", "ReportEvents", "ExecutorSync"):
            return self._proto._call(method, req)
        return self._json._call(method, req)

    def __getattr__(self, name):
        return getattr(self._json, name)


def _history(agent_pkg, server_pkg, backend, wire):
    stack = Stack(server_pkg, backend)
    try:
        return _drive(agent_pkg, stack, _grpc_client(wire, stack.address))
    finally:
        stack.close()


_REF = {}


@pytest.mark.parametrize("backend", ["oracle", "kernel"])
@pytest.mark.parametrize("wire", ["json", "proto"])
def test_reference_agent_leases_from_port_server(backend, wire, fixed_clock):
    key = (backend, wire)
    if key not in _REF:
        _REF[key] = _history(REF_PKG, REF_PKG, backend, wire)
    want = _REF[key]
    assert any(h[0] for h in want) and any(h[2]["e0"] for h in want)
    for agent_pkg in (REF_PKG, PORT_PKG):
        got = _history(agent_pkg, PORT_PKG, backend, wire)
        assert len(got) == len(want)
        for c, (a, b) in enumerate(zip(got, want)):
            assert a == b, f"{agent_pkg} agent, cycle {c}"


def test_lease_records_carry_across(fixed_clock):
    """The records an exchange leaves in the scheduler (ExecutorHeartbeat
    and its NodeSpecs, built by the lease handler from the agent's node
    dicts) carry across with `utils.carry.to_port` and `to_reference`."""
    from armada_tpu_torch.utils.carry import to_port

    stacks = {pkg: Stack(pkg, "oracle", serve=False) for pkg in (REF_PKG, PORT_PKG)}
    for pkg, stack in stacks.items():
        ea = importlib.import_module(f"{pkg}.services.executor_agent")
        nodes = _nodes("e0") + [{"id": "e0-t", "total_resources": {"cpu": "4"},
                                 "taints": [{"key": "k", "value": "v", "effect": "NoSchedule"}],
                                 "labels": {"armadaproject.io/pool": "gpu"},
                                 "unallocatable_by_priority": {0: {"cpu": "1"}}}]
        ea.ExecutorAgent(_smoke().Loopback(stack.api), "e0", nodes).tick(NOW)
    ref, port = stacks[REF_PKG].sched.executors, stacks[PORT_PKG].sched.executors
    assert to_port(ref) == port and to_reference(port) == ref
    assert {n.pool for n in port["e0"].nodes} == {"default", "gpu"}


def test_loopback_equals_grpc(fixed_clock):
    """The port's agents through the loopback (the codec and the method
    table, no socket) lease as through a real gRPC channel."""
    smoke = _smoke()
    served = Stack(PORT_PKG, "kernel")
    try:
        over_grpc = _drive(PORT_PKG, served, _grpc_client("json", served.address))
    finally:
        served.close()
    local = Stack(PORT_PKG, "kernel", serve=False)
    wire = smoke.Loopback(local.api)

    class Submitter:
        """ApiClient's calls used by `_drive`, through the loopback."""

        def __init__(self, g):
            self.g = g

        def create_queue(self, name, priority_factor=1.0):
            wire._call("CreateQueue", {"name": name, "priority_factor": priority_factor})

        def submit_jobs(self, queue, jobset, jobs):
            return wire._call("SubmitJobs", {"queue": queue, "jobset": jobset,
                                             "jobs": jobs})["job_ids"]

        def cancel_jobs(self, queue, jobset, job_ids, reason=""):
            wire._call("CancelJobs", {"queue": queue, "jobset": jobset,
                                      "job_ids": list(job_ids), "reason": reason})

        def reprioritize_jobs(self, queue, jobset, job_ids, priority):
            wire._call("ReprioritizeJobs", {"queue": queue, "jobset": jobset,
                                            "job_ids": list(job_ids), "priority": priority})

        def _call(self, method, req):
            return wire._call(method, req)

    looped = _drive(PORT_PKG, local, Submitter)
    assert looped == over_grpc
    assert set(wire.seconds) >= {"ExecutorLease", "ReportEvents", "SubmitJobs"}
    assert all(n > 0 for xs in wire.reply_bytes.values() for n in xs)


def test_loopback_raises_what_the_handler_raises():
    """A handler's exception reaches the caller as it is: a stale fence
    token is a FencedError, which the agent's fence path recognises."""
    smoke = _smoke()
    from armada_tpu_torch.services.grpc_api import FencedError, is_fenced_error

    stack = Stack(PORT_PKG, "oracle", serve=False)
    stack.sched.executor_fences["e0"] = 2
    wire = smoke.Loopback(stack.api)
    with pytest.raises(FencedError) as info:
        wire._call("ExecutorLease", {"executor": "e0", "nodes": [], "fence_token": 1})
    assert is_fenced_error(info.value)
    with pytest.raises(KeyError):
        wire._call("GetQueue", {"name": "missing"})


def test_job_dicts_invert_job_spec_from_dict():
    """chip_smoke.py's job dicts give the JobSpecs back through the
    server's parser (all but submitted_ts, which the submit service
    stamps)."""
    smoke = _smoke()
    from armada_tpu_torch.core.types import (
        Affinity, Gang, IngressConfig, JobSpec, MatchExpression, NodeSelectorTerm,
        ServiceConfig, Toleration)
    from armada_tpu_torch.services.grpc_api import job_spec_from_dict
    from armada_tpu_torch.workload import build_inputs

    full = JobSpec(
        id="j0", queue="q", jobset="s", priority=4, priority_class="d", pools=("p",),
        requests={"cpu": "2"}, node_selector={"zone": "a"},
        tolerations=(Toleration(key="gpu", operator="Equal", value="t", effect="NoSchedule"),),
        affinity=Affinity(terms=(NodeSelectorTerm(expressions=(
            MatchExpression(key="rack", operator="In", values=("r1",)),)),)),
        gang=Gang(id="g", cardinality=2, node_uniformity_label="rack"),
        annotations={"a": "b"}, bid_prices={"p": (1.0, 2.0)}, command=("x",),
        services=(ServiceConfig(type="Headless", ports=(80,)),),
        ingresses=(IngressConfig(ports=(80,), annotations=(("k", "v"),), tls_enabled=True),))
    specs = [full] + build_inputs(200, 1, n_running=0, gang_every=8)[5]
    for spec in specs:
        assert job_spec_from_dict(smoke.job_spec_to_dict(spec)) == spec.with_(submitted_ts=0.0)


def test_phase_wire_on_cpu(monkeypatch):
    """Phase 17 at 4,000 jobs on 1,500 nodes, in requests of 250, three
    cycles (the mutations after the second), on the CPU: every check of
    the phase holds but the launch counts."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "take_launches", lambda totals, label, extra=(): {
        k: 0 for k in totals})
    rec = smoke.phase_wire(n_jobs=4000, n_nodes=1500, device="cpu", cycles=3, batch=250,
                           partition_at=3)
    assert len(rec["cycles"]) == 3
    assert all(c[kp]["leased"] for c in rec["cycles"] for kp in ("cuda", "lax"))
    assert rec["submit"]["partition"]["failed"].keys() == {"cuda", "lax"}
    assert rec["final"]["cuda"]["jobs"] == 4000
    assert rec["mutation"]["next_cycle_leased"] > 0
