"""Port copy of tests/test_optimiser.py: the fairness-optimising
post-pass (armada_tpu_torch/solver/optimiser.py), run on the port.

Every case is the JAX package's, with the port's imports. Each round is
solved by the port's oracle and its kernel on the CPU (equal decisions,
as the JAX package's `assert_parity` holds its kernel to its oracle),
and each `optimise_round` call is twinned with the JAX package's on the
same snapshot and result carried across (`torch_control_plane.twinned`):
the decisions it returns and the result arrays it mutates are equal
exactly.

The first test ports the Go table case named 'optimiser' from
preempting_queue_scheduler_test.go:174-217; the rest pin the pass's
gates: improvement threshold, per-round job bound, non-preemptible and
gang victims excluded."""

import numpy as np
import pytest
import torch_cpu  # noqa: F401

import armada_tpu.solver.optimiser as ref_optimiser

from armada_tpu_torch.core.config import OptimiserConfig, PriorityClass, SchedulingConfig
from armada_tpu_torch.core.types import Gang, JobSpec, NodeSpec, QueueSpec, RunningJob, Taint
from armada_tpu_torch.snapshot.round import build_round_snapshot
from armada_tpu_torch.solver.kernel import solve_round
from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu_torch.solver.optimiser import optimise_round
from armada_tpu_torch.solver.reference import ReferenceSolver
from torch_control_plane import twinned

@pytest.fixture(autouse=True)
def _twin_with_reference(monkeypatch):
    """Hold every optimiser pass to the JAX package's, exactly."""
    monkeypatch.setitem(globals(), "optimise_round",
                        twinned(optimise_round, ref_optimiser.optimise_round))
    yield


def assert_parity(cfg, nodes, queues, running, queued, label=""):
    """The port's oracle and its kernel on the CPU decide the round alike
    (the port's counterpart of tests/test_kernel_parity.assert_parity)."""
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    oracle = ReferenceSolver(snap).solve()
    out = solve_round(pad_device_round(prep_device_round(snap)), device="cpu")
    J, Q = snap.num_jobs, snap.num_queues
    assert (oracle.assigned_node == out["assigned_node"][:J]).all(), label
    assert (oracle.scheduled_mask == out["scheduled_mask"][:J]).all(), label
    assert (oracle.preempted_mask == out["preempted_mask"][:J]).all(), label
    np.testing.assert_allclose(oracle.demand_capped_fair_share,
                               out["demand_capped_fair_share"][:Q], rtol=1e-12, err_msg=label)
    return snap, oracle, out


CFG = SchedulingConfig(
    priority_classes={
        "priority-2": PriorityClass("priority-2", 2, preemptible=True),
        "priority-3": PriorityClass("priority-3", 3, preemptible=False),
    },
    default_priority_class="priority-2",
    protected_fraction_of_fair_share=1.0,
)

OPT = OptimiserConfig(enabled=True, min_fairness_improvement_pct=10.0)


def _nodes():
    # One tainted 32-cpu node (largeJobsOnly) + one untainted, as in the Go
    # case (NTainted32CpuNodes + N32CpuNodes).
    return [
        NodeSpec(
            id="tainted-0",
            pool="default",
            taints=(Taint("largeJobsOnly", "true"),),
            total_resources={"cpu": "32", "memory": "256Gi"},
        ),
        NodeSpec(
            id="node-0",
            pool="default",
            total_resources={"cpu": "32", "memory": "256Gi"},
        ),
    ]


def _solve(cfg, nodes, queues, running, queued, opt=None):
    snap = build_round_snapshot(cfg, "default", nodes, queues, running, queued)
    snap, oracle, out = assert_parity(cfg, nodes, queues, running, queued, "opt")
    result = {
        "assigned_node": oracle.assigned_node.copy(),
        "scheduled_mask": oracle.scheduled_mask.copy(),
        "preempted_mask": oracle.preempted_mask.copy(),
        "scheduled_priority": oracle.scheduled_priority.copy(),
        "demand_capped_fair_share": oracle.demand_capped_fair_share.copy(),
    }
    decisions = optimise_round(snap, result, opt) if opt else []
    return snap, result, decisions


def test_optimiser_go_table_case():
    """Go: 'optimiser' (preempting_queue_scheduler_test.go:174)."""
    nodes = _nodes()
    queues = [QueueSpec("A", 1.0), QueueSpec("B", 1.0)]

    # Round 1: A's 1-cpu job schedules (on the untainted node).
    snap, r1, _ = _solve(CFG, nodes, queues, [], [
        JobSpec(id="a0", queue="A", priority_class="priority-2",
                requests={"cpu": "1", "memory": "4Gi"}, submitted_ts=1.0),
    ])
    assert r1["scheduled_mask"].sum() == 1
    a_node = snap.node_ids[int(r1["assigned_node"][0])]
    assert a_node == "node-0"
    running = [
        RunningJob(
            job=JobSpec(id="a0", queue="A", priority_class="priority-2",
                        requests={"cpu": "1", "memory": "4Gi"}, submitted_ts=1.0),
            node_id=a_node,
            scheduled_at_priority=2,
        )
    ]
    b_job = JobSpec(id="b0", queue="B", priority_class="priority-2",
                    requests={"cpu": "32", "memory": "256Gi"}, submitted_ts=2.0)

    # Round 2: optimiser OFF — B's whole-node job cannot schedule (A is
    # protected; B tolerates no taint).
    snap, r2, _ = _solve(CFG, nodes, queues, running, [b_job])
    assert r2["scheduled_mask"].sum() == 0
    assert r2["preempted_mask"].sum() == 0

    # Round 3: optimiser ON — A's 1-cpu job is preempted for a ~3100%
    # fairness improvement, B schedules.
    snap, r3, decisions = _solve(CFG, nodes, queues, running, [b_job], opt=OPT)
    assert len(decisions) == 1
    j_b = snap.job_ids.index("b0")
    j_a = snap.job_ids.index("a0")
    assert r3["scheduled_mask"][j_b]
    assert r3["preempted_mask"][j_a]
    assert snap.node_ids[int(r3["assigned_node"][j_b])] == "node-0"


def test_optimiser_improvement_threshold():
    """No action when the fairness gain is below the threshold."""
    nodes = _nodes()
    queues = [QueueSpec("A", 1.0), QueueSpec("B", 1.0)]
    running = [
        RunningJob(
            job=JobSpec(id="a0", queue="A", priority_class="priority-2",
                        requests={"cpu": "1", "memory": "4Gi"}, submitted_ts=1.0),
            node_id="node-0",
            scheduled_at_priority=2,
        )
    ]
    b_job = JobSpec(id="b0", queue="B", priority_class="priority-2",
                    requests={"cpu": "32", "memory": "256Gi"}, submitted_ts=2.0)
    opt = OptimiserConfig(enabled=True, min_fairness_improvement_pct=10_000.0)
    snap, out, decisions = _solve(CFG, nodes, queues, running, [b_job], opt=opt)
    assert decisions == []
    j_a = snap.job_ids.index("a0")
    assert not out["preempted_mask"][j_a]


def test_optimiser_respects_jobs_per_round():
    nodes = [
        NodeSpec(id="n0", pool="default",
                 total_resources={"cpu": "4", "memory": "16Gi"})
    ]
    queues = [QueueSpec("A", 1.0), QueueSpec("B", 1.0)]
    running = [
        RunningJob(
            job=JobSpec(id=f"a{i}", queue="A", priority_class="priority-2",
                        requests={"cpu": "1", "memory": "1Gi"},
                        submitted_ts=float(i)),
            node_id="n0",
            scheduled_at_priority=2,
        )
        for i in range(4)
    ]
    queued = [
        JobSpec(id=f"b{i}", queue="B", priority_class="priority-2",
                requests={"cpu": "2", "memory": "2Gi"}, submitted_ts=10.0 + i)
        for i in range(2)
    ]
    opt = OptimiserConfig(enabled=True, maximum_jobs_per_round=1)
    snap, out, decisions = _solve(CFG, nodes, queues, running, queued, opt=opt)
    assert sum(len(d.scheduled) for d in decisions) <= 1


def test_optimiser_never_evicts_non_preemptible_or_gangs():
    nodes = [
        NodeSpec(id="n0", pool="default",
                 total_resources={"cpu": "4", "memory": "16Gi"})
    ]
    queues = [QueueSpec("A", 1.0), QueueSpec("B", 1.0)]
    gang = Gang(id="g", cardinality=2)
    running = [
        RunningJob(
            job=JobSpec(id="np0", queue="A", priority_class="priority-3",
                        requests={"cpu": "2", "memory": "2Gi"}, submitted_ts=1.0),
            node_id="n0",
            scheduled_at_priority=3,
        ),
        RunningJob(
            job=JobSpec(id="g0", queue="A", priority_class="priority-2",
                        requests={"cpu": "1", "memory": "1Gi"},
                        submitted_ts=2.0, gang=gang),
            node_id="n0",
            scheduled_at_priority=2,
        ),
        RunningJob(
            job=JobSpec(id="g1", queue="A", priority_class="priority-2",
                        requests={"cpu": "1", "memory": "1Gi"},
                        submitted_ts=3.0, gang=gang),
            node_id="n0",
            scheduled_at_priority=2,
        ),
    ]
    queued = [
        JobSpec(id="b0", queue="B", priority_class="priority-2",
                requests={"cpu": "2", "memory": "2Gi"}, submitted_ts=10.0)
    ]
    opt = OptimiserConfig(enabled=True)
    snap, out, decisions = _solve(CFG, nodes, queues, running, queued, opt=opt)
    # Only non-evictable work on the node: the optimiser must do nothing.
    assert decisions == []
