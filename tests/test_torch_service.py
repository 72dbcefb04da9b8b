"""The port's scheduler service and control plane (submit service, fake
executor, event log, job database) against the JAX package's, on the CPU.

Every case of tests/test_control_plane.py runs twice, once on each
package's stack, with the same backend on both: "oracle" (the host
solver) and "kernel" (the port on `device="cpu"`, the reference on its
JAX kernel). The case's own assertions hold on both stacks, and after
every cycle the two job databases hold the same leases: per job its
state, attempts and latest run's executor, node, pool and priority (run
ids are random). Also here:

- the residency engagement of `snapshot_mode="auto"`: kernel rounds from
  the second cycle on are "resident" and sync by delta;
- a corrupted resident buffer, found by the drift sweep and reset, the
  leases still the reference's;
- a reference service carried into the port (`from_reference_events`,
  `from_reference_checkpoint`), after which both go on with equal leases;
- the seams this slice wires (metrics, the flight recorder, the SLO
  tracker, SubmitService(slo=), market pools, the optimiser, autotune and
  the what-if planner) work, and those that wait for a later slice refuse
  with NotImplementedError naming their ROADMAP item.
"""

import pytest
import torch
import torch_cpu  # noqa: F401

from armada_tpu_torch.events.log import from_reference_events
from armada_tpu_torch.services.scheduler import from_reference_checkpoint
from torch_control_plane import PORT, REF, leases_view

BACKENDS = ("oracle", "kernel")


class History:
    """The leases after every cycle of every service a case builds."""

    def __init__(self):
        self.cycles = []

    def watch(self, sched):
        cycle = sched.cycle

        def recorded(now=None):
            out = cycle(now=now)
            self.cycles.append(leases_view(sched.jobdb))
            return out

        sched.cycle = recorded
        return sched


def twin(case, backend):
    """Run `case(pkg, backend, history)` on both stacks; the histories
    must be equal cycle by cycle. Returns the port's."""
    got = {}
    for pkg in (REF, PORT):
        h = History()
        case(pkg, backend, h)
        got[pkg.name] = h.cycles
    assert len(got["armada_tpu_torch"]) == len(got["armada_tpu"])
    for i, (p, r) in enumerate(zip(got["armada_tpu_torch"], got["armada_tpu"])):
        assert p == r, f"cycle {i}"
    return got["armada_tpu_torch"]


def config(pkg, **kw):
    return pkg.SchedulingConfig(
        priority_classes={"default": pkg.PriorityClass("default", 1000, preemptible=True)},
        default_priority_class="default",
        **kw,
    )


def mk_stack(pkg, backend, h, n_nodes=4, **cfg_kw):
    cfg = config(pkg, **cfg_kw)
    log = pkg.InMemoryEventLog()
    sched = h.watch(pkg.SchedulerService(cfg, log, backend=backend))
    submit = pkg.SubmitService(cfg, log, scheduler=sched)
    executor = pkg.FakeExecutor(
        "cluster-a", log, sched,
        nodes=pkg.make_nodes("cluster-a", count=n_nodes, cpu="16", memory="64Gi"),
        runtime_for=lambda job_id: 10.0,
    )
    return cfg, log, sched, submit, executor


def job(pkg, i, cpu="2", mem="4Gi", **kw):
    return pkg.JobSpec(id=f"job-{i:04d}", queue="", requests={"cpu": cpu, "memory": mem}, **kw)


def case_submit_validation(pkg, backend, h):
    _, _, sched, submit, _ = mk_stack(pkg, backend, h)
    submit.create_queue(pkg.QueueSpec("team"))
    with pytest.raises(pkg.SubmissionError):
        submit.submit("ghost-queue", "set1", [job(pkg, 0)])
    with pytest.raises(pkg.SubmissionError):
        submit.submit("team", "set1", [job(pkg, 1).with_(requests={})])
    with pytest.raises(pkg.SubmissionError):
        submit.submit("team", "set1", [job(pkg, 2).with_(requests={"fancy/widget": "1"})])
    with pytest.raises(pkg.SubmissionError):
        submit.submit("team", "set1", [job(pkg, 3).with_(priority_class="nope")])
    assert submit.submit("team", "set1", [job(pkg, 4)]) == ["job-0004"]
    sched.ingester.sync()
    h.cycles.append(leases_view(sched.jobdb))


def case_deduplication(pkg, backend, h):
    _, _, sched, submit, _ = mk_stack(pkg, backend, h)
    submit.create_queue(pkg.QueueSpec("team"))
    once = {"armadaproject.io/deduplication-id": "once"}
    ids1 = submit.submit("team", "set1", [job(pkg, 0, annotations=once)])
    ids2 = submit.submit("team", "set1", [job(pkg, 1, annotations=once)])
    assert ids1 == ids2
    sched.ingester.sync()
    assert len(sched.jobdb) == 1
    h.cycles.append(leases_view(sched.jobdb))


def case_full_lifecycle(pkg, backend, h):
    _, _, sched, submit, executor = mk_stack(pkg, backend, h)
    submit.create_queue(pkg.QueueSpec("team"))
    submit.submit("team", "set1", [job(pkg, i) for i in range(8)], now=0.0)
    executor.tick(0.0)
    sched.cycle(now=1.0)
    leased = [j for j in sched.jobdb.read_txn().all_jobs() if j.state == pkg.JobState.LEASED]
    assert len(leased) == 8
    assert all(j.latest_run.executor == "cluster-a" for j in leased)
    executor.tick(2.0)
    sched.ingester.sync()
    assert all(j.state == pkg.JobState.RUNNING for j in sched.jobdb.read_txn().all_jobs())
    executor.tick(13.0)
    sched.ingester.sync()
    assert all(j.state == pkg.JobState.SUCCEEDED for j in sched.jobdb.read_txn().all_jobs())
    h.cycles.append(leases_view(sched.jobdb))


def case_capacity_backlog_drains(pkg, backend, h):
    _, _, sched, submit, executor = mk_stack(pkg, backend, h, n_nodes=1)
    submit.create_queue(pkg.QueueSpec("team"))
    # 1 node x 16 cpu; 16 jobs x 4 cpu -> 4 at a time
    submit.submit("team", "set1", [job(pkg, i, cpu="4") for i in range(16)], now=0.0)
    t, done = 0.0, 0
    for _ in range(40):
        t += 5.0
        executor.tick(t)
        sched.cycle(now=t)
        done = sum(1 for j in sched.jobdb.read_txn().all_jobs()
                   if j.state == pkg.JobState.SUCCEEDED)
        if done == 16:
            break
    assert done == 16, f"only {done} finished"


def case_cancel_job(pkg, backend, h):
    _, _, sched, submit, executor = mk_stack(pkg, backend, h)
    submit.create_queue(pkg.QueueSpec("team"))
    (jid,) = submit.submit("team", "set1", [job(pkg, 0)], now=0.0)
    submit.cancel_job("team", "set1", jid)
    sched.ingester.sync()
    assert sched.jobdb.get(jid).state == pkg.JobState.CANCELLED
    executor.tick(1.0)
    sched.cycle(now=1.0)
    assert sched.jobdb.get(jid).state == pkg.JobState.CANCELLED


def case_reprioritise_changes_order(pkg, backend, h):
    _, _, sched, submit, executor = mk_stack(pkg, backend, h, n_nodes=1)
    submit.create_queue(pkg.QueueSpec("team"))
    ids = submit.submit("team", "set1", [job(pkg, i, cpu="16") for i in range(3)], now=0.0)
    submit.reprioritise_job("team", "set1", ids[2], -10)
    executor.tick(1.0)
    sched.cycle(now=1.0)
    txn = sched.jobdb.read_txn()
    # only one fits; the reprioritised job wins
    assert txn.get(ids[2]).state == pkg.JobState.LEASED
    assert txn.get(ids[0]).state == pkg.JobState.QUEUED


def case_executor_timeout_requeues(pkg, backend, h):
    _, _, sched, submit, executor = mk_stack(pkg, backend, h)
    submit.create_queue(pkg.QueueSpec("team"))
    (jid,) = submit.submit("team", "set1", [job(pkg, 0)], now=0.0)
    executor.tick(0.0)
    sched.cycle(now=1.0)
    assert sched.jobdb.get(jid).state == pkg.JobState.LEASED
    # executor goes silent; timeout default 600s
    sched.cycle(now=700.0)
    j = sched.jobdb.get(jid)
    assert j.state == pkg.JobState.QUEUED
    assert j.num_attempts == 1
    assert sched.executor_fence("cluster-a") == 1


def case_gang_schedules_atomically(pkg, backend, h):
    _, _, sched, submit, executor = mk_stack(pkg, backend, h, n_nodes=4)
    submit.create_queue(pkg.QueueSpec("team"))
    gang = pkg.Gang(id="g1", cardinality=4)
    submit.submit("team", "set1", [job(pkg, i, cpu="16", gang=gang) for i in range(4)], now=0.0)
    executor.tick(0.0)
    sched.cycle(now=1.0)
    txn = sched.jobdb.read_txn()
    assert all(j.state == pkg.JobState.LEASED for j in txn.all_jobs())
    # each on its own node (16 cpu each, nodes are 16 cpu)
    assert len({j.latest_run.node_id for j in txn.all_jobs()}) == 4


def case_multi_pool_scheduling(pkg, backend, h):
    """Two executor pools; jobs schedule only onto their selector-matched
    pool, and each pool runs its own round."""
    cfg = pkg.SchedulingConfig(
        priority_classes={"d": pkg.PriorityClass("d", 1000, preemptible=True)},
        default_priority_class="d",
    )
    log = pkg.InMemoryEventLog()
    sched = h.watch(pkg.SchedulerService(cfg, log, backend=backend))
    submit = pkg.SubmitService(cfg, log, scheduler=sched)
    cpu_exec = pkg.FakeExecutor(
        "cpu-cluster", log, sched,
        nodes=pkg.make_nodes("cpu-cluster", count=2, cpu="16", memory="64Gi",
                             labels={"kind": "cpu"}, pool="cpu-pool"),
        pool="cpu-pool",
    )
    gpu_exec = pkg.FakeExecutor(
        "gpu-cluster", log, sched,
        nodes=pkg.make_nodes("gpu-cluster", count=2, cpu="16", memory="64Gi",
                             labels={"kind": "gpu"}, pool="gpu-pool"),
        pool="gpu-pool",
    )
    submit.create_queue(pkg.QueueSpec("team"))
    submit.submit("team", "s", [job(pkg, 0, node_selector={"kind": "gpu"}),
                                job(pkg, 1, node_selector={"kind": "cpu"})], now=0.0)
    cpu_exec.tick(0.0)
    gpu_exec.tick(0.0)
    sched.cycle(now=1.0)
    txn = sched.jobdb.read_txn()
    j0, j1 = txn.get("job-0000"), txn.get("job-0001")
    assert (j0.latest_run.executor, j0.latest_run.pool) == ("gpu-cluster", "gpu-pool")
    assert (j1.latest_run.executor, j1.latest_run.pool) == ("cpu-cluster", "cpu-pool")


def case_cancel_jobset(pkg, backend, h):
    _, _, sched, submit, _ = mk_stack(pkg, backend, h)
    submit.create_queue(pkg.QueueSpec("team"))
    submit.submit("team", "set1", [job(pkg, i) for i in range(3)], now=0.0)
    submit.submit("team", "set2", [job(pkg, 10)], now=0.0)
    submit.cancel_jobset("team", "set1")
    sched.ingester.sync()
    txn = sched.jobdb.read_txn()
    assert sum(1 for j in txn.all_jobs() if j.state == pkg.JobState.CANCELLED) == 3
    assert txn.get("job-0010").state == pkg.JobState.QUEUED
    h.cycles.append(leases_view(sched.jobdb))


def case_executor_cordon_diverts_placement(pkg, backend, h):
    _, log, sched, submit, ex_a = mk_stack(pkg, backend, h, n_nodes=2)
    ex_b = pkg.FakeExecutor(
        "cluster-b", log, sched,
        nodes=pkg.make_nodes("cluster-b", count=2, cpu="16", memory="64Gi"),
        runtime_for=lambda job_id: 10.0,
    )
    submit.create_queue(pkg.QueueSpec("q"))
    sched.set_executor_cordon("cluster-a", True)
    t = 0.0
    submit.submit("q", "s", [job(pkg, i) for i in range(4)], now=t)
    for _ in range(3):
        t += 1.0
        ex_a.tick(t)
        ex_b.tick(t)
        sched.cycle(now=t)
    txn = sched.jobdb.read_txn()
    placed = [j.latest_run.executor for j in txn.all_jobs() if j.latest_run]
    assert placed and all(e == "cluster-b" for e in placed)
    # uncordon: new work can land on cluster-a again
    sched.set_executor_cordon("cluster-a", False)
    submit.submit("q", "s2", [job(pkg, 100 + i, cpu="14") for i in range(4)], now=t)
    for _ in range(3):
        t += 1.0
        ex_a.tick(t)
        ex_b.tick(t)
        sched.cycle(now=t)
    txn = sched.jobdb.read_txn()
    assert "cluster-a" in {j.latest_run.executor for j in txn.all_jobs() if j.latest_run}


def case_lagging_executor_skipped(pkg, backend, h):
    _, _, sched, submit, ex_a = mk_stack(pkg, backend, h, n_nodes=2,
                                         max_unacknowledged_jobs_per_executor=2)
    submit.create_queue(pkg.QueueSpec("q"))
    t = 1.0
    ex_a.tick(t)  # heartbeat so nodes register
    submit.submit("q", "s", [job(pkg, i, cpu="1", mem="1Gi") for i in range(6)], now=t)
    # cycle WITHOUT executor ticks: leases pile up unacknowledged
    sched.cycle(now=t)
    assert sum(1 for j in sched.jobdb.read_txn().all_jobs()
               if j.state == pkg.JobState.LEASED) == 6
    # more work arrives; the lagging executor must be skipped entirely
    submit.submit("q", "s2", [job(pkg, 10 + i, cpu="1", mem="1Gi") for i in range(2)], now=t + 1)
    sched.cycle(now=t + 1)
    assert sum(1 for j in sched.jobdb.read_txn().all_jobs()
               if j.state == pkg.JobState.QUEUED) == 2
    # the executor acks (ticks): leases progress, next round can place again
    t += 2.0
    ex_a.tick(t)
    sched.cycle(now=t)
    assert all(j.state != pkg.JobState.QUEUED for j in sched.jobdb.read_txn().all_jobs())


def case_gang_contexts_in_reports(pkg, backend, h):
    cfg = pkg.SchedulingConfig(
        priority_classes={"d": pkg.PriorityClass("d", 1000, preemptible=True)},
        default_priority_class="d",
    )
    log = pkg.InMemoryEventLog()
    sched = h.watch(pkg.SchedulerService(cfg, log, backend=backend))
    submit = pkg.SubmitService(cfg, log, scheduler=sched)
    pkg.FakeExecutor("c", log, sched, nodes=pkg.make_nodes("c", count=2, cpu="8", memory="32Gi"),
                     runtime_for=lambda j: 100.0).tick(0.0)
    submit.create_queue(pkg.QueueSpec("gq"))
    fits = pkg.Gang(id="fits", cardinality=2)
    too_big = pkg.Gang(id="too-big", cardinality=2)
    submit.submit(
        "gq", "s1",
        [pkg.JobSpec(id=f"a{i}", queue="", gang=fits, requests={"cpu": "2", "memory": "2Gi"})
         for i in range(2)]
        + [pkg.JobSpec(id=f"b{i}", queue="", gang=too_big, requests={"cpu": "7", "memory": "2Gi"})
           for i in range(2)],
        now=0.0,
    )
    sched.cycle(now=1.0)
    rep = sched.reports.latest_reports()["default"]
    assert rep.gang_contexts[("gq", "fits")].startswith("scheduled 2/2")
    assert rep.gang_contexts[("gq", "too-big")].startswith("not scheduled")
    assert "gang fits" in sched.reports.queue_report("gq")
    assert "gang too-big" in sched.reports.scheduling_report()


def case_incremental_cycle_respects_pool_restriction(pkg, backend, h):
    cfg = pkg.SchedulingConfig(
        priority_classes={"d": pkg.PriorityClass("d", 1000, preemptible=True)},
        default_priority_class="d",
    )
    log = pkg.InMemoryEventLog()
    sched = h.watch(pkg.SchedulerService(cfg, log, backend=backend, snapshot_mode="incremental"))
    submit = pkg.SubmitService(cfg, log, scheduler=sched)
    executor = pkg.FakeExecutor("c1", log, sched,
                                nodes=pkg.make_nodes("c1", count=2, cpu="8", memory="32Gi"),
                                runtime_for=lambda job_id: 100.0)
    submit.create_queue(pkg.QueueSpec("q"))
    submit.submit("q", "s", [job(pkg, 0)], now=0.0)
    executor.tick(0.0)
    sched.cycle(now=1.0)  # builds the incremental state
    assert sched.jobdb.read_txn().get("job-0000").latest_run is not None
    submit.submit("q", "s", [job(pkg, 1, pools=("gpu-pool",)), job(pkg, 2)], now=2.0)
    executor.tick(2.0)
    sched.cycle(now=3.0)
    txn = sched.jobdb.read_txn()
    assert txn.get("job-0002").latest_run is not None  # eligible: leased
    assert txn.get("job-0001").latest_run is None  # restricted: untouched
    assert txn.get("job-0001").state == pkg.JobState.QUEUED


def case_metrics_rendered(pkg, backend, h):
    """Headline prometheus metrics are populated by a cycle, including the
    skipped-executors gauge (metrics.go / cycle_metrics.go families)."""
    import importlib

    metrics = importlib.import_module(f"{pkg.name}.services.metrics").SchedulerMetrics()
    if metrics.registry is None:
        pytest.skip("prometheus_client unavailable")
    _, _, sched, submit, ex = mk_stack(pkg, backend, h, n_nodes=2)
    sched.attach_metrics(metrics)
    submit.create_queue(pkg.QueueSpec("q"))
    # a cordon on an unregistered executor must NOT count as skipped
    sched.set_executor_cordon("ghost-exec", True)
    sched.set_executor_cordon("cluster-a", True)
    t = 1.0
    ex.tick(t)
    submit.submit("q", "s", [job(pkg, i) for i in range(3)], now=t)
    sched.cycle(now=t)
    text = metrics.render().decode()
    assert "scheduler_skipped_executors 1.0" in text
    sched.set_executor_cordon("cluster-a", False)
    t += 1.0
    ex.tick(t)
    sched.cycle(now=t)
    text = metrics.render().decode()
    assert "scheduler_skipped_executors 0.0" in text
    assert 'scheduler_queue_fair_share{pool="default",queue="q"}' in text
    assert 'scheduler_jobs_scheduled_total{pool="default",queue="q"} 3.0' in text
    assert 'scheduler_solve_seconds_count{pool="default"}' in text


CASES = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_control_plane_case_matches_reference(name, backend):
    twin(CASES[name], backend)


def _residency_stack(pkg, h, **cfg_kw):
    cfg = config(pkg, **cfg_kw)
    log = pkg.InMemoryEventLog()
    sched = h.watch(pkg.SchedulerService(cfg, log, backend="kernel"))
    submit = pkg.SubmitService(cfg, log, scheduler=sched)
    submit.create_queue(pkg.QueueSpec("team"))
    ex = pkg.FakeExecutor("ex-a", log, sched, nodes=pkg.make_nodes("ex-a", count=2, cpu="8"),
                          runtime_for=lambda job_id: 1000.0)
    return sched, submit, ex


def _jobs(pkg, lo, hi):
    return [pkg.JobSpec(id=f"j{i}", queue="team", jobset="s",
                        requests={"cpu": "2", "memory": "1Gi"}, submitted_ts=float(i))
            for i in range(lo, hi)]


def test_auto_mode_engages_residency_and_syncs_by_delta():
    """snapshot_mode="auto" keeps each kernel pool's round on the device:
    from the second cycle on the round is "resident", synced by delta,
    with no drift, and the leases are the reference's."""
    modes = []

    def case(pkg, backend, h):
        sched, submit, ex = _residency_stack(pkg, h)
        submit.submit("team", "s", _jobs(pkg, 0, 10), now=0.0)
        for t in (0.0, 1.0, 2.0, 3.0, 4.0):
            if t == 2.0:
                submit.submit("team", "s", _jobs(pkg, 10, 12), now=t)
            ex.tick(t)
            sched.cycle(now=t)
            if pkg is PORT:
                st = sched.last_cycle_stats
                modes.append((st["snapshot_mode"], (st["sync"] or {}).get("mode"), st["rung"]))
        assert "default" in sched._resident
        assert sched._resident["default"].check_drift() == []

    twin(case, "kernel")
    assert modes[0] == ("resident", "reset", "local:cuda")
    assert all(m == ("resident", "delta", "local:cuda") for m in modes[1:]), modes


def test_drift_sweep_resets_a_corrupted_resident_buffer():
    """A resident buffer corrupted between cycles is caught by the
    service's drift sweep (`resident_drift_check_every`) and the round
    state resets; the round itself was admitted against the host mirror,
    and the next cycle re-uploads — the leases stay the reference's."""
    seen = {}

    def case(pkg, backend, h):
        sched, submit, ex = _residency_stack(pkg, h, resident_drift_check_every=1)
        submit.submit("team", "s", _jobs(pkg, 0, 6), now=0.0)
        for t in (0.0, 1.0):
            ex.tick(t)
            sched.cycle(now=t)
        if pkg is PORT:
            resident = sched._resident["default"]
            poisoned = resident._dev.job_prio.clone()
            poisoned[0] += 1
            resident._dev.job_prio = poisoned
            assert resident.check_drift() == ["job_prio"]
            sched._maybe_check_resident_drift("default")
            seen["after_sweep"] = resident._dev
        submit.submit("team", "s", _jobs(pkg, 6, 9), now=2.0)
        for t in (2.0, 3.0):
            ex.tick(t)
            sched.cycle(now=t)
            if pkg is PORT and t == 2.0:
                seen["next_sync"] = sched.last_cycle_stats["sync"]["mode"]
        if pkg is PORT:
            assert sched._resident["default"].check_drift() == []

    twin(case, "kernel")
    assert seen["after_sweep"] is None
    assert seen["next_sync"] == "reset"


def test_reference_service_carried_into_the_port():
    """A reference service runs a few cycles; its log and checkpoint are
    carried into a port service (from_reference_events,
    from_reference_checkpoint), and both go on with equal leases."""
    ref_h, port_h = History(), History()
    cfg = config(REF)
    ref_log = REF.InMemoryEventLog()
    ref = ref_h.watch(REF.SchedulerService(cfg, ref_log, backend="kernel"))
    ref_submit = REF.SubmitService(cfg, ref_log, scheduler=ref)
    ref_ex = REF.FakeExecutor("cluster-a", ref_log, ref,
                              nodes=REF.make_nodes("cluster-a", count=3, cpu="16", memory="64Gi"),
                              runtime_for=lambda job_id: 6.0)
    ref_submit.create_queue(REF.QueueSpec("team"))
    ref_submit.submit("team", "s1", [job(REF, i, cpu="6") for i in range(10)], now=0.0)
    for t in (1.0, 4.0):
        ref_ex.tick(t)
        ref.cycle(now=t)
    ref.set_executor_cordon("ghost", True)
    ref.set_priority_override("team", 2.0)
    ref.ingester.sync()

    port_log = PORT.InMemoryEventLog()
    port_log.publish_many(e.sequence for e in from_reference_events(ref_log.read(0, 10**6)))
    checkpoint = from_reference_checkpoint(*ref.checkpoint_state())
    port = port_h.watch(PORT.SchedulerService(config(PORT), port_log, backend="kernel",
                                              checkpoint=checkpoint))
    assert port.ingester.cursor == ref.ingester.cursor == ref_log.end_offset
    assert leases_view(port.jobdb) == leases_view(ref.jobdb)
    assert port.cordoned_executors == {"ghost"} and port.priority_overrides == {"team": 2.0}
    port_submit = PORT.SubmitService(config(PORT), port_log, scheduler=port)
    assert set(port_submit.queues) == {"team"}
    port_ex = PORT.FakeExecutor("cluster-a", port_log, port,
                                nodes=PORT.make_nodes("cluster-a", count=3, cpu="16", memory="64Gi"),
                                runtime_for=lambda job_id: 6.0)
    # A fresh executor serves the port's service while the reference's
    # keeps its pods; the leases stay equal all the same.
    for sub, more in ((ref_submit, REF), (port_submit, PORT)):
        sub.submit("team", "s2", [job(more, 20 + i, cpu="4") for i in range(5)], now=5.0)
    for t in (5.0, 8.0, 11.0, 20.0):
        for ex, sched in ((ref_ex, ref), (port_ex, port)):
            ex.tick(t)
            sched.cycle(now=t)
        assert leases_view(port.jobdb) == leases_view(ref.jobdb), t
    final = leases_view(port.jobdb)
    assert all(attempts == 1 for _, attempts, _ in final.values())
    assert sum(state == "succeeded" for state, _, _ in final.values()) == 9


def test_service_run_cuda_path_equals_lax_path():
    """chip_smoke.py's service phase at a small size on the CPU
    (workload.ServiceRun: the bench's queued jobs through the submit
    service, two fake executors): the "cuda" and "lax" services lease
    alike cycle by cycle, every round on its ladder's first rung, resident
    with a delta sync from the second cycle on, no drift."""
    from armada_tpu_torch.workload import ServiceRun, submit_events

    cfg, entries, _ = submit_events(2500)
    assert len({type(e.sequence.events[0]).__name__ for e in entries}) == 2  # queues, jobs
    hist = {}
    for path, first in (("cuda", "local:cuda"), ("lax", "LOCAL")):
        run = ServiceRun(cfg, entries, 400, kernel_path=path, device="cpu")
        assert len(run.sched.jobdb) == 2500
        recs = [run.cycle() for _ in range(3)]
        hist[path] = [(r["leases"], r["preempted"]) for r in recs]
        for i, r in enumerate(recs):
            st = r["stats"]
            assert st["rung"] == first and st["failover"] is None
            assert len(r["leases"]) == (1000 if i < 2 else 500)
            assert {e for _, e, _ in r["leases"]} <= {"executor-0", "executor-1"}
            if i:
                assert (st["snapshot_mode"], st["sync"]["mode"]) == ("resident", "delta")
        assert run.sched._resident["default"].check_drift() == []
    assert hist["cuda"] == hist["lax"]


def _sim(**kw):
    from armada_tpu_torch.sim import ClusterSpec, Simulator, WorkloadSpec

    return Simulator([ClusterSpec(name="c")], WorkloadSpec(queues=()),
                     backend="oracle", **kw)


def _submit_through_front_door(tmp_path):
    """SubmitService(frontdoor=): the jobs are acked into the shards'
    WALs, reach the main log when the front door is pumped, and lease."""
    from armada_tpu_torch.frontdoor import FrontDoor

    log = PORT.InMemoryEventLog()
    sched = PORT.SchedulerService(config(PORT), log, backend="oracle")
    fd = FrontDoor(log, num_shards=2)
    submit = PORT.SubmitService(sched.config, log, scheduler=sched, frontdoor=fd)
    submit.create_queue(PORT.QueueSpec("q"))
    for k, jobset in enumerate(("a", "b", "c")):
        submit.submit("q", jobset, [job(PORT, 2 * k + i, jobset=jobset) for i in range(2)],
                      now=0.0)
    before = sum(1 for e in log.read(0, log.end_offset) if e.sequence.jobset in "abc")
    acked = fd.max_lag()
    fd.drain(now=0.0)
    ex = PORT.FakeExecutor("e", log, sched, nodes=PORT.make_nodes("e", count=2, cpu="8"),
                           runtime_for=lambda job_id: 100.0)
    ex.tick(0.0)
    sched.cycle(now=0.0)
    leased = [j for j in sched.jobdb.read_txn().all_jobs() if j.latest_run is not None]
    return before == 0 and acked > 0 and fd.max_lag() == 0 and len(leased) == 6


def _sim_data_dir(tmp_path):
    """Simulator(data_dir=): the event log is a CrashRecoveringLog over
    the directory, with the quarantine directory under it."""
    from armada_tpu_torch.services.chaos import CrashRecoveringLog

    sim = _sim(data_dir=str(tmp_path))
    return (isinstance(sim.log, CrashRecoveringLog) and sim.log.dir == str(tmp_path)
            and sim.scheduler.quarantine_dir == str(tmp_path / "quarantine"))


def _sim_front_door(tmp_path):
    """Simulator(frontdoor=2): two ingest shards on the sim's virtual
    clock, in front of the submit service."""
    sim = _sim(frontdoor=2)
    return (sim.frontdoor.num_shards == 2 and sim.submit.frontdoor is sim.frontdoor
            and sim.frontdoor.clock is sim.chaos_clock)


@pytest.mark.parametrize("build", [_submit_through_front_door, _sim_data_dir, _sim_front_door])
def test_persistence_and_front_door_seams(build, tmp_path):
    """The seams that refused before the file-backed log and the front
    door were ported (ROADMAP A1, and the front door of A2) now build
    them."""
    assert build(tmp_path)


def test_autotune_and_whatif_seams_attach():
    """attach_autotune, attach_fork_capture and attach_whatif take the
    port's controller, capture and planner, and Simulator(autotune=,
    whatif=) builds and attaches them."""
    from armada_tpu_torch.autotune import AutotuneController
    from armada_tpu_torch.whatif import ForkCapture, WhatIfService

    sched = PORT.SchedulerService(config(PORT), PORT.InMemoryEventLog(), device="cpu")
    ctl, capture = AutotuneController(sched.config, enabled=True), ForkCapture()
    sched.attach_autotune(ctl)
    sched.attach_fork_capture(capture)
    assert sched.autotune is ctl and sched.fork_capture is capture
    wi = WhatIfService(sched)
    sched.attach_whatif(wi)
    assert sched.whatif is wi and sched.fork_capture is wi.capture
    sim = _sim(autotune=True, whatif=True)
    assert sim.scheduler.autotune is sim.autotune and sim.autotune.enabled
    assert sim.scheduler.whatif is sim.whatif


def _attach_metrics(sched, tmp_path):
    from armada_tpu_torch.services.metrics import SchedulerMetrics

    sched.attach_metrics(SchedulerMetrics())
    return lambda: sched.metrics.render()


def _attach_recorder(sched, tmp_path):
    from armada_tpu_torch.trace import TraceRecorder, load_trace

    path = str(tmp_path / "service.atrace")
    sched.attach_trace_recorder(TraceRecorder(path, source="scheduler"))
    return lambda: (sched.trace_recorder.close(), len(load_trace(path).rounds))[1]


def _attach_slo(sched, tmp_path):
    from armada_tpu_torch.services.slo import SLOTracker

    sched.attach_slo(SLOTracker())
    return lambda: {s["name"]: s["observed"] for s in sched.slo.snapshot()["slos"]}


@pytest.mark.parametrize("attach, check", [
    (_attach_metrics, lambda got: b"scheduler_cycle_seconds_count 2.0" in got),
    (_attach_recorder, lambda got: got == 2),
    (_attach_slo, lambda got: got["round-latency"] == 2 and got["queue-wait"] == 3),
])
def test_attached_seams_observe_the_cycles(attach, check, tmp_path):
    """The seams that refused before this slice now observe the port's
    kernel cycles: the metrics registry, the flight recorder (a round
    per cycle), the SLO tracker (cycle latency and first-lease waits)."""
    from armada_tpu_torch.services.metrics import HAVE_PROMETHEUS

    if attach is _attach_metrics and not HAVE_PROMETHEUS:
        pytest.skip("prometheus_client unavailable")
    h = History()
    _, _, sched, submit, ex = mk_stack(PORT, "kernel", h, n_nodes=2)
    read = attach(sched, tmp_path)
    submit.create_queue(PORT.QueueSpec("q"))
    submit.submit("q", "s", [job(PORT, i) for i in range(3)], now=0.0)
    for t in (1.0, 2.0):
        ex.tick(t)
        sched.cycle(now=t)
    assert check(read())


def test_market_optimiser_and_slo_config_accepted():
    """A market pool with a bid provider, the optimiser and an SLO
    tracker on the submit service start and cycle on the port, and a
    submit through a front door is observed by the same tracker (the
    front door refused until it was ported)."""
    import dataclasses

    from armada_tpu_torch.core.config import OptimiserConfig
    from armada_tpu_torch.services.pricing import LocalBidPriceService
    from armada_tpu_torch.services.slo import SLOTracker

    log = PORT.InMemoryEventLog()
    cfg = dataclasses.replace(config(PORT, market_driven=True),
                              optimiser=OptimiserConfig(enabled=True))
    sched = PORT.SchedulerService(
        cfg, log, bid_price_provider=LocalBidPriceService(["default"], lambda: ["q"]))
    slo = SLOTracker()
    submit = PORT.SubmitService(cfg, log, scheduler=sched, slo=slo)
    submit.create_queue(PORT.QueueSpec("q"))
    submit.submit("q", "s", [job(PORT, 0)], now=0.0)
    ex = PORT.FakeExecutor("cluster-a", log, sched,
                           nodes=PORT.make_nodes("cluster-a", count=1, cpu="16", memory="64Gi"))
    ex.tick(1.0)
    sched.cycle(now=1.0)
    assert sched.jobdb.get("job-0000").latest_run is not None
    assert sched.reports.latest_reports()["default"].queues["q"].realised_value > 0
    assert {s["name"]: s["observed"] for s in slo.snapshot()["slos"]}["frontdoor-p99"] == 1
    from armada_tpu_torch.frontdoor import FrontDoor

    fd = FrontDoor(log, num_shards=2)
    PORT.SubmitService(cfg, log, scheduler=sched, slo=slo, frontdoor=fd).submit(
        "q", "s2", [job(PORT, 1)], now=2.0)
    assert fd.max_lag() == 1 and sched.jobdb.get("job-0001") is None
    assert {s["name"]: s["observed"] for s in slo.snapshot()["slos"]}["frontdoor-p99"] == 2


def test_kernel_service_needs_its_device():
    """The kernel backend is the default. Without `device`, a kernel
    service solves on the CUDA card; where there is none it refuses to
    start, so no round falls back to the host for want of a card. The
    oracle backend needs no card."""
    from armada_tpu_torch.services.scheduler import SchedulerService
    from armada_tpu_torch.sim import Simulator

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is the card")
    log = PORT.InMemoryEventLog()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerService(config(PORT), log, backend="kernel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerService(config(PORT), log)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator([], PORT.sim.WorkloadSpec(queues=()))
    assert SchedulerService(config(PORT), log, backend="oracle").device is None
    assert SchedulerService(config(PORT), log, device="cpu").backend == "kernel"
