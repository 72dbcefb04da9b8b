"""The port stands alone: no module of armada_tpu_torch (the home/away
scenario module, the hot window, the transfer ledger, the control plane
and the round observatory included), and not chip_smoke.py, imports
jax, armada_tpu or yaml, also when the main path, the fast-fill path, a
budgeted, compacted solve, a market round, a deadline-policy round, a
warm cycle (incremental snapshot, resident round, fairness ledger) and a
few scheduler-service cycles (event log, ingester, job database, submit
service, fake executor, failover ladder, resident rounds, drift sweep)
run, a simulation with a fault injected on `local:cuda` fails over to
LOCAL on the CPU's ladder, a market-pool service runs its post-round
seams, a simulation records a flight-recorder bundle (with metrics
and the SLO tracker attached) that the port replays, tunes over and
keeps in a checkpointed tuning store, and a simulation with the online
controller and the what-if planner attached plans against its state
(its rollouts in a spawned rollout process), a budgeted service takes a
planner, a service over the file-backed log restarts from its directory,
a simulation runs over a crash-recovering log behind a front door, both
soak tools run a plan, the file lease and the HS256 authenticators
decide, the Lookout views and the event index follow a service's log on
background tasks behind the Lookout HTTP server, and the fairness report
and the Perfetto converter read a recorded bundle, and jobs go in by REST
through a ChaosProxy to a kernel stack whose executor agent leases
through chip_smoke.py's loopback (the method table over the JSON codec),
and the load tester, armadactl and the testsuite runner drive a kernel
stack through its LoopbackClient (ApiClient's methods over that
loopback), the simulator runs from the dict halves of its CLI's loaders
and broadside's in-process backend ingests a batch. A package's
`__main__` is found, not run.
prometheus_client is blocked too: the metrics stay optional (no
registry, an empty rendering); so are grpc, google.protobuf and
cryptography, which the card's machine lacks (auth.py imports
cryptography only where an RS256 token is made or checked; grpc_api.py
imports grpc only where a socket is opened or a status code read, and
protobuf only on the binary wire). Every module imports without them
but the proto bindings (`armada_tpu_torch.proto`, its `armada_pb2`) and
`tools/gen_proto.py`, which fail with an ImportError naming
google.protobuf. The default device is the CUDA card, which raises
where there is none."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch_cpu  # noqa: F401
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = textwrap.dedent(
    """
    import importlib, importlib.util, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "armada_tpu", "yaml", "prometheus_client", "grpc",
               "cryptography")
    PROTOBUF = ("armada_tpu_torch.proto", "armada_tpu_torch.proto.armada_pb2",
                "armada_tpu_torch.tools.gen_proto")

    def blocked(name):
        return name.split(".")[0] in BLOCKED or name.split(".")[:2] == ["google", "protobuf"]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT)
    import armada_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        armada_tpu_torch.__path__, "armada_tpu_torch.")]
    names = sorted(set(names) | set(PROTOBUF))
    for name in names:
        if name.endswith(".__main__"):
            # A package's command line (`python -m`): found, not run.
            assert importlib.util.find_spec(name) is not None, name
            continue
        if name in PROTOBUF:
            try:
                importlib.import_module(name)
            except ImportError as e:
                assert "google.protobuf" in str(e), (name, e)
            else:
                raise AssertionError(f"{name} imported without google.protobuf")
            continue
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT + "/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    # Run the main path once on the CPU so lazy imports load too.
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.solver.validate import validate_round

    from armada_tpu_torch.workload import build_inputs

    inputs = build_inputs(60, 6, n_running=8)
    dev = pad_device_round(prep_device_round(build_round_snapshot(*inputs)))
    out = solve_round(dev, device="cpu")
    assert validate_round(out, dev=dev) is None
    assert int(out["scheduled_mask"].sum()) > 0
    # The fast-fill path on the port's own home/away round.
    assert "armada_tpu_torch.parallel.scenarios" in names
    from armada_tpu_torch.parallel.scenarios import home_away_round

    dev = pad_device_round(prep_device_round(home_away_round(16, 48)))
    stats = {}
    out = solve_round(dev, device="cpu", stats=stats)
    assert dev.fast_fill and stats["merged_fill_loops"] > 0
    assert int(out["scheduled_mask"].sum()) > 0
    # The host-driven driver: a budgeted, compacted solve (hot window and
    # transfer ledger), as the scheduler asks for it.
    assert "armada_tpu_torch.solver.hotwindow" in names
    assert "armada_tpu_torch.observe.ledger" in names
    inputs = build_inputs(60, 6, n_running=8, fill_window=2)
    dev = pad_device_round(prep_device_round(build_round_snapshot(*inputs)))
    out = solve_round(dev, device="cpu", budget_s=60.0, window=2, window_min_slots=0)
    assert out["profile"]["compacted"] and out["truncated"] is False
    assert out["profile"]["transfer"]["bytes_up"] > 0
    # A market round (the port's market_round) and a policy round.
    from armada_tpu_torch.parallel.scenarios import market_round
    from armada_tpu_torch.workload import policy_inputs

    dev = pad_device_round(prep_device_round(market_round(16, 256)))
    out = solve_round(dev, device="cpu")
    assert dev.market_driven and out["spot_price"] == out["spot_price"]
    assert validate_round(out, dev=dev) is None
    inputs = policy_inputs(build_inputs(60, 6, n_running=8), "deadline")
    dev = pad_device_round(prep_device_round(build_round_snapshot(*inputs)))
    out = solve_round(dev, device="cpu")
    assert dev.fairness_policy[0] == "deadline" and validate_round(out, dev=dev) is None
    assert int(out["scheduled_mask"].sum()) > 0
    # The warm cycle: the incremental snapshot, the resident round (its
    # sync booked, its solve booking no upload) and the fairness ledger.
    for name in ("snapshot.incremental", "snapshot.residency", "observe.fairness"):
        assert "armada_tpu_torch." + name in names
    from armada_tpu_torch.workload import WarmCycle

    warm = WarmCycle(build_inputs(400, 6, n_running=8, fast_fill=True, fill_window=4),
                     device="cpu")
    assert warm.cold()["sync"]["mode"] == "reset"
    rec = warm.cycle()
    assert rec["sync"]["mode"] == "delta" and rec["transfer"]["bytes_up"] == 0
    assert rec["violation"] is None and warm.resident.check_drift() == []
    assert 0.0 < warm.fairness()["jain"] <= 1.0
    # Scheduler-service cycles: submit, ingest, lease, run, finish, on
    # the kernel backend with residency engaged and the drift sweep on.
    for name in ("events.log", "jobdb.ingest", "services.scheduler", "services.submit",
                 "services.fake_executor", "solver.failover", "solver.reference",
                 "whatif.drain", "sim.simulator", "utils.carry"):
        assert "armada_tpu_torch." + name in names
    from armada_tpu_torch.core.config import PriorityClass, SchedulingConfig
    from armada_tpu_torch.core.types import JobSpec, QueueSpec
    from armada_tpu_torch.events import InMemoryEventLog
    from armada_tpu_torch.services.fake_executor import FakeExecutor, make_nodes
    from armada_tpu_torch.services.scheduler import SchedulerService
    from armada_tpu_torch.services.submit import SubmitService

    cfg = SchedulingConfig(priority_classes={"d": PriorityClass("d", 1000, preemptible=True)},
                           default_priority_class="d", resident_drift_check_every=1)
    log = InMemoryEventLog()
    sched = SchedulerService(cfg, log, backend="kernel", device="cpu")
    submit = SubmitService(cfg, log, scheduler=sched)
    ex = FakeExecutor("c", log, sched, nodes=make_nodes("c", count=2, cpu="8"),
                      runtime_for=lambda job_id: 1.5)
    submit.create_queue(QueueSpec("q"))
    submit.submit("q", "s", [JobSpec(id=f"j{i}", queue="", requests={"cpu": "2", "memory": "1Gi"})
                             for i in range(10)], now=0.0)
    for t in (0.0, 1.0, 2.0, 3.0, 4.0):
        ex.tick(t)
        sched.cycle(now=t)
    assert sched.last_cycle_stats["snapshot_mode"] == "resident"
    assert not sched.recent_failovers and not sched.recent_rejections
    assert sum(j.state.value == "succeeded" for j in sched.jobdb.read_txn().all_jobs()) >= 8
    # The simulator, with a fault on local:cuda: the ladder's next rung.
    from armada_tpu_torch.services.chaos import FaultPlan, FaultSpec
    from armada_tpu_torch.sim import ClusterSpec, JobTemplate, QueueSpecSim, Simulator, WorkloadSpec
    from armada_tpu_torch.sim.simulator import NodeTemplate

    sim = Simulator([ClusterSpec("c1", node_templates=(NodeTemplate(count=2, cpu="8"),))],
                    WorkloadSpec(queues=(QueueSpecSim("q", job_templates=(
                        JobTemplate(id="t", number=6, cpu="2", memory="1Gi"),)),)),
                    backend="kernel", device="cpu", max_time=600.0,
                    fault_plan=FaultPlan([FaultSpec("solver_raise", "local:cuda", count=1)]))
    res = sim.run()
    assert res.finished_jobs == 6
    assert [(f["from"], f["to"]) for f in sim.scheduler.recent_failovers] == [
        ("local:cuda", "LOCAL")]
    # The market pool's post-round seams and the round observatory.
    for name in ("solver.optimiser", "solver.pricer", "solver.idealised", "services.pricing",
                 "services.metrics", "services.slo", "services.health", "observe.compiles",
                 "trace.codec", "trace.recorder", "trace.replayer", "trace.policy_ab",
                 "utils.compress", "tools.replay_gate", "tools.slo_gate"):
        assert "armada_tpu_torch." + name in names
    from armada_tpu_torch.services.metrics import HAVE_PROMETHEUS, SchedulerMetrics

    metrics = SchedulerMetrics()
    assert not HAVE_PROMETHEUS and metrics.registry is None and metrics.render() == b""
    from armada_tpu_torch.workload import MarketServiceRun

    run = MarketServiceRun(8, 96, device="cpu")
    recs = [run.cycle() for _ in range(3)]
    assert recs[0]["leases"] and recs[2]["market"]["repriced"] > 0
    assert all(r["market"]["indicative"] and r["market"]["values"] for r in recs)
    import os, tempfile
    from armada_tpu_torch.services.health import SolverLadderChecker
    from armada_tpu_torch.trace import load_trace, replay_trace

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sim.atrace")
        sim = Simulator([ClusterSpec("c1", node_templates=(NodeTemplate(count=2, cpu="8"),))],
                        WorkloadSpec(queues=(QueueSpecSim("q", job_templates=(
                            JobTemplate(id="t", number=6, cpu="2", memory="1Gi"),)),)),
                        device="cpu", max_time=600.0, trace_path=path,
                        span_path=os.path.join(tmp, "spans.jsonl"), slo=True)
        sim.scheduler.attach_metrics(metrics)
        assert sim.run().finished_jobs == 6
        assert sim.slo.evaluate()["ok"]
        assert SolverLadderChecker(sim.scheduler).check()[0]
        report = replay_trace(load_trace(path), solvers=("LOCAL", "lax"), device="cpu")
        assert report["ok"] and report["rounds"] > 0, report
        # Autotune and the what-if planner: the offline tuner over the
        # bundle into a tuning store through a checkpoint, a simulation
        # with the online controller and the planner attached, a plan,
        # a drain plan and a parity check.
        for name in ("autotune.store", "autotune.controller", "autotune.offline",
                     "services.checkpoint", "services.submit_check", "tools.autotune",
                     "whatif.fork", "whatif.mutations", "whatif.planner"):
            assert "armada_tpu_torch." + name in names
        from armada_tpu_torch.autotune import TunedParams, TuningStore, tune_corpus
        from armada_tpu_torch.services.checkpoint import CheckpointStore
        from armada_tpu_torch.whatif import mutations_from_dicts

        tuned = tune_corpus([load_trace(path)], [TunedParams(2, 0, 1)], repeats=1,
                            device="cpu")
        assert tuned["ok"], tuned
        store = TuningStore()
        store.put(tuned["selected"])
        CheckpointStore(os.path.join(tmp, "ckpt")).save("autotune", 0, store.dump())
        store.load(CheckpointStore(os.path.join(tmp, "ckpt")).load("autotune")[1])
        sim = Simulator([ClusterSpec("c1", node_templates=(NodeTemplate(count=2, cpu="8"),)),
                         ClusterSpec("c2", node_templates=(NodeTemplate(count=2, cpu="8"),))],
                        WorkloadSpec(queues=(QueueSpecSim("q", job_templates=(
                            JobTemplate(id="t", number=6, cpu="2", memory="1Gi"),)),)),
                        device="cpu", max_time=40.0, autotune=True, whatif=True)
        sim.run()
        plan = sim.whatif.plan(mutations_from_dicts(
            [{"kind": "inject_gang", "queue": "q", "gang_cardinality": 2, "cpu": "2"}]), rounds=2)
        assert plan.injected and sim.whatif.plan_drain("c1", rounds=2).drain is not None
        assert sim.whatif.parity(trace_path=path, allow_foreign=True)["ok"]
        assert sim.whatif.rollouts.pids() and [x["kind"] for x in sim.whatif.plan_stats] == [
            "whatif", "drain"]
        sim.whatif.close()
        # Persistence and the front door: a budgeted service with a
        # planner, a service over the file-backed log and its restart,
        # a simulation over a crash-recovering log behind two ingest
        # shards with torn writes, both soak tools, the lease and auth.
        for name in ("events.file_log", "services.leader", "services.auth", "frontdoor.admission",
                     "frontdoor.partition", "tools.chaos_soak", "tools.frontdoor_soak",
                     "whatif.worker"):
            assert "armada_tpu_torch." + name in names
        import dataclasses
        from armada_tpu_torch.events import FileEventLog
        from armada_tpu_torch.whatif import WhatIfService

        budgeted = dataclasses.replace(cfg, max_scheduling_duration_s=5.0)
        wi = WhatIfService(SchedulerService(budgeted, InMemoryEventLog(), device="cpu"))
        wi.close()
        log = FileEventLog(os.path.join(tmp, "log"))
        sched = SchedulerService(cfg, log, device="cpu")
        submit = SubmitService(cfg, log, scheduler=sched)
        ex = FakeExecutor("c", log, sched, nodes=make_nodes("c", count=2, cpu="8"),
                          runtime_for=lambda job_id: 100.0)
        submit.create_queue(QueueSpec("q"))
        submit.submit("q", "s", [JobSpec(id=f"f{i}", queue="", requests={"cpu": "2"})
                                 for i in range(6)], now=0.0)
        ex.tick(0.0)
        sched.cycle(now=0.0)
        log.close()
        restarted = SchedulerService(cfg, FileEventLog(os.path.join(tmp, "log")), device="cpu")
        restarted.ingester.sync()
        assert sum(j.latest_run is not None
                   for j in restarted.jobdb.read_txn().all_jobs()) == 6
        sim = Simulator([ClusterSpec("c1", node_templates=(NodeTemplate(count=2, cpu="8"),))],
                        WorkloadSpec(queues=(QueueSpecSim("q", job_templates=(
                            JobTemplate(id="t", number=6, cpu="2", memory="1Gi"),)),)),
                        device="cpu", max_time=600.0, data_dir=os.path.join(tmp, "sim"),
                        frontdoor=2, fault_plan=FaultPlan([FaultSpec(
                            "torn_log_write", "*", start=0.0, count=2, param=0.5)]))
        assert sim.run().finished_jobs == 6 and sim.log.crashes > 0
        from armada_tpu_torch.tools.chaos_soak import run_plan
        from armada_tpu_torch.tools.frontdoor_soak import DEFAULTS, run_soak

        soak = run_plan(1, "kernel", 8, device="cpu")
        assert soak["finished"] == soak["total"]
        doc = run_soak(0, dict(DEFAULTS, jobs=200, tenants=8, shards=2), device="cpu")
        assert doc["lost"] == 0 and doc["duplicates"] == 0, doc
        from armada_tpu_torch.services import auth
        from armada_tpu_torch.services.leader import FileLeaseLeader

        leader = FileLeaseLeader(os.path.join(tmp, "lease"))
        assert leader() and leader.validate(leader.get_token())
        principal = auth.TokenAuth("s").authenticate(
            {"authorization": "Bearer " + auth.make_token("s", "bob", groups=["ops"])})
        auth.Authorizer(permission_groups={auth.SUBMIT_ANY_JOBS: ["ops"]}).authorize_global(
            principal, auth.SUBMIT_ANY_JOBS)
        # Lookout and the query side: the in-memory and SQLite views and
        # the event-stream index follow a service's log on a background
        # task manager's loops; the HTTP server answers; the fairness
        # report and the Perfetto converter read the simulation's bundle.
        for name in ("services.queryapi", "services.lookout_ingester",
                     "services.lookout_sqlite", "services.binoculars", "services.event_index",
                     "services.lookout_ui", "services.lookout_http", "utils.tasks",
                     "tools.fairness_report", "tools.trace2perfetto"):
            assert "armada_tpu_torch." + name in names
        import json, time, urllib.request
        from armada_tpu_torch.services.binoculars import BinocularsService
        from armada_tpu_torch.services.event_index import EventStreamIndex
        from armada_tpu_torch.services.lookout_http import LookoutHttpServer
        from armada_tpu_torch.services.lookout_ingester import LookoutStore
        from armada_tpu_torch.services.lookout_sqlite import SqliteLookoutStore
        from armada_tpu_torch.services.queryapi import QueryApi
        from armada_tpu_torch.tools import fairness_report, trace2perfetto
        from armada_tpu_torch.utils.tasks import BackgroundTaskManager

        log = InMemoryEventLog()
        sched = SchedulerService(cfg, log, device="cpu")
        submit = SubmitService(cfg, log, scheduler=sched)
        ex = FakeExecutor("c", log, sched, nodes=make_nodes("c", count=2, cpu="8"),
                          runtime_for=lambda job_id: 100.0)
        stores = [LookoutStore(log), SqliteLookoutStore(log, os.path.join(tmp, "lookout.db")),
                  EventStreamIndex(log)]
        tasks = BackgroundTaskManager()
        for k, store in enumerate(stores):
            tasks.register(store.sync, 0.01, f"sync-{k}")
        server = LookoutHttpServer(QueryApi(lookout=stores[0], timeline=sched.timeline), sched,
                                   submit, binoculars=BinocularsService(sched, [ex]))
        submit.create_queue(QueueSpec("q"))
        submit.submit("q", "s", [JobSpec(id=f"l{i}", queue="", requests={"cpu": "2"})
                                 for i in range(6)], now=0.0)
        ex.tick(0.0)
        sched.cycle(now=0.0)
        deadline = time.time() + 60
        while any(s.lag_events for s in stores) and time.time() < deadline:
            time.sleep(0.01)
        # A SQLite store moves its cursor before its batch commits: stop
        # the loops (each ends its sync) before reading the views.
        assert tasks.stop_all() == [] and all(
            t["failures"] == 0 and t["runs"] > 0 for t in tasks.stats().values())
        assert not any(s.lag_events for s in stores)
        assert stores[0].all_rows() == stores[1].all_rows() and len(stores[1].all_rows()) == 6
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/api/jobs?queue=q") as r:
            assert json.loads(r.read())["total"] == 6
        server.stop()
        assert fairness_report.main([path]) == 0
        doc = trace2perfetto.convert([path, os.path.join(tmp, "spans.jsonl")])
        assert trace2perfetto.validate(doc) == []
    # The wire and the executor side, as chip_smoke.py's phase 17 drives
    # them on the card: a queue and a REST submit through the ChaosProxy,
    # the agent's first exchange (its nodes), a cycle, then the exchange
    # that carries the leases, through the loopback.
    for name in ("services.node_info", "services.netchaos", "services.grpc_api",
                 "services.executor_agent", "services.rest_gateway", "services.server"):
        assert "armada_tpu_torch." + name in names
    from armada_tpu_torch.services.chaos import VirtualClock

    stack = smoke.WireStack(cfg, "cuda", VirtualClock(), FaultPlan([]), 1, 2, device="cpu")
    try:
        smoke._rest(stack.base, "/api/v1/queue", {"name": "w"})
        ids = smoke._rest(stack.base, "/api/v1/job/submit", {"queue": "w", "jobset": "s", "jobs": [
            {"id": f"w{i}", "requests": {"cpu": "1", "memory": "1Gi"}} for i in range(3)]})["job_ids"]
        stack.agents[0].tick(0.0)
        stack.sched.cycle(now=0.0)
        reply = stack.agents[0].tick(10.0)
        assert len(reply["leases"]) == 3 and stack.wire.seconds["ExecutorLease"]
        assert {p["job_id"] for p in stack.agents[0].runtime.pods.values()} == set(ids)
        assert stack.proxy.bytes_forwarded > 0
    finally:
        stack.close()
    # The clients, the CLIs and the testsuite, as chip_smoke.py's phase 18
    # drives them on the card: the load tester and armadactl over its
    # LoopbackClient, a testsuite spec from its dict on the stack's own
    # loop, the simulator from dicts, broadside's in-process backend.
    for name in ("clients.aio", "clients.cli", "clients.broadside", "clients.load_tester",
                 "sim.cli", "testsuite.runner", "testsuite.__main__", "tools.policy_ab",
                 "tools.gen_metrics_doc", "tools.gen_known_gaps"):
        assert "armada_tpu_torch." + name in names
    from armada_tpu_torch.clients import cli, load_tester
    from armada_tpu_torch.clients.broadside import BroadsideConfig, InprocBackend
    from armada_tpu_torch.sim.cli import cluster_from_dict, workload_from_dict
    from armada_tpu_torch.testsuite import TestSpec, TestSuiteRunner

    cstack = smoke.ClientStack(SchedulingConfig(), "cuda", [{
        "name": "ex", "nodes": 2, "cpu": "8", "memory": "32Gi", "runtime": 0.5}], device="cpu")
    try:
        with smoke._Commands((cli, load_tester)) as commands:
            assert commands.run(cstack.client, load_tester.main, [
                "--jobs", "4", "--batch", "2", "--queues", "1"])[0] == 0
            cstack.cycle(0.0)
            out = commands.run(cstack.client, cli.main, ["jobs", "--queue", "load-000"])[1]
            # A handler's error reaches armadactl's error handler, which
            # raises it as it is where grpc was never imported.
            try:
                commands.run(cstack.client, cli.main, ["queue", "get", "no-such-queue"])
            except KeyError:
                pass
            else:
                raise AssertionError("armadactl printed an unknown queue")
        assert json.loads(out)["total"] == 4
        cstack.start(0.02)
        res = TestSuiteRunner(cstack.client).run(TestSpec.from_dict({
            "name": "one", "timeout": 30, "queue": "g", "jobs": [
                {"count": 1, "requests": {"cpu": "1", "memory": "1Gi"}}],
            "expectedEvents": ["JobRunLeased", "JobSucceeded"]}))
        assert res.passed, res.reason
    finally:
        cstack.close()
    assert not cstack.errors, cstack.errors
    result = Simulator(
        [cluster_from_dict({"name": "c", "nodeTemplates": [{"count": 2, "cpu": "8"}]})],
        workload_from_dict({"queues": [{"name": "q", "jobTemplates": [
            {"number": 4, "cpu": "1", "runtimeMinimum": 10}]}]}),
        device="cpu").run()
    assert result.finished_jobs == 4
    backend = InprocBackend()
    try:
        backend.submit_batch("q", "s", 20, BroadsideConfig())
        while backend.lag_events() > 0:
            pass
        assert sum(g["count"] for g in backend.group_jobs("q")) == 20
    finally:
        backend.teardown()
    loaded = sorted(m for m in sys.modules if blocked(m))
    assert not loaded, loaded
    print("GUARD_OK", len(names))
    """
)


def test_port_imports_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _GUARD],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "GUARD_OK" in r.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    from armada_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert device.COST_DTYPE == torch.float64 and device.KEY_DTYPE == torch.int64


def test_solve_round_defaults_to_the_card(monkeypatch):
    """With no device argument the solve asks for CUDA and raises here."""
    from armada_tpu_torch.solver import kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.solve_round(_tiny_round())


def _tiny_round():
    from armada_tpu_torch.core.config import SchedulingConfig
    from armada_tpu_torch.core.types import JobSpec, NodeSpec, QueueSpec
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round

    snap = build_round_snapshot(
        SchedulingConfig(), "default",
        [NodeSpec(id="n0", pool="default", total_resources={"cpu": "4", "memory": "4Gi"})],
        [QueueSpec("q")], [],
        [JobSpec(id="j0", queue="q", requests={"cpu": "1", "memory": "1Gi"})],
    )
    return pad_device_round(prep_device_round(snap))
