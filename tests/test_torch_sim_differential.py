"""Differential simulation through the port: the workload of
tests/test_sim_differential.py at seed 0 through the port's Simulator
(on the CPU) must give the fleet history (states, placements,
preemptions, finished jobs) of the JAX package's kernel backend, and of
the port's own oracle backend; the port's "rebuild", "incremental" and
"auto" (device-resident) snapshot modes must agree with one another, as
the reference's do, and the service's 2x2 mesh rung gives the
single-device history. With one solver fault injected, the card's
ladder (`local:cuda` alone) rejects the round and requeues its work, as
an oracle service does after the same fault on its one rung. Each
history is computed once per module.
`workload.sim_workload`, the port's copy of the workload that
chip_smoke.py runs on the card, is this one.
"""

import functools

import pytest
import torch_cpu  # noqa: F401

from armada_tpu_torch.workload import sim_history, sim_workload
from torch_control_plane import PORT, REF, plain


def workload(pkg):
    sim = pkg.sim
    cfg = pkg.SchedulingConfig(
        priority_classes={
            "high": pkg.PriorityClass("high", 30000, preemptible=False),
            "low": pkg.PriorityClass("low", 1000, preemptible=True),
        },
        default_priority_class="low",
        protected_fraction_of_fair_share=0.5,
    )
    clusters = [
        sim.ClusterSpec(
            "c1",
            node_templates=(
                sim.NodeTemplate(count=6, cpu="16", memory="64Gi", labels={"zone": "a"}),
                sim.NodeTemplate(count=4, cpu="32", memory="128Gi", labels={"zone": "b"}),
            ),
        )
    ]
    Exp = sim.ShiftedExponential
    spec = sim.WorkloadSpec(
        queues=(
            sim.QueueSpecSim("steady", job_templates=(
                sim.JobTemplate(id="long", number=40, cpu="2", memory="4Gi",
                                runtime=Exp(minimum=300.0)),
            )),
            sim.QueueSpecSim("bursty", priority_factor=2.0, job_templates=(
                sim.JobTemplate(id="gangs", number=24, cpu="4", memory="4Gi",
                                gang_cardinality=8, submit_time=50.0,
                                runtime=Exp(minimum=120.0)),
                sim.JobTemplate(id="urgent", number=10, cpu="2", memory="2Gi",
                                priority_class="high", submit_time=100.0,
                                runtime=Exp(minimum=60.0)),
            )),
            sim.QueueSpecSim("zoned", job_templates=(
                sim.JobTemplate(id="pin", number=12, cpu="1", memory="1Gi",
                                node_selector={"zone": "b"}, submit_time=30.0,
                                runtime=Exp(minimum=90.0, tail_mean=30.0)),
            )),
        )
    )
    return clusters, spec, cfg


@functools.lru_cache(maxsize=None)
def history(package, backend, snapshot_mode="auto", mesh=None, fault_on=None):
    """The fleet history of one simulation; `fault_on` names the rung
    that takes one injected solver_raise, and the port's kernel service
    then runs on the card's ladder."""
    pkg = PORT if package == "port" else REF
    clusters, spec, cfg = workload(pkg)
    plan = None
    if fault_on is not None:
        plan = pkg.FaultPlan([pkg.FaultSpec("solver_raise", fault_on, count=1)])
    sim = pkg.Simulator(clusters, spec, config=cfg, backend=backend, mesh=mesh,
                        snapshot_mode=snapshot_mode, seed=0, max_time=5000.0,
                        fault_plan=plan)
    if package == "port" and backend == "kernel" and fault_on is not None:
        from armada_tpu_torch.solver.failover import FailoverLadder, build_ladder

        sched = sim.scheduler
        sched._rungs = build_ladder("kernel", mesh, cfg, device="cuda")
        sched.failover = FailoverLadder(sched._rungs)
    res = sim.run()
    failovers = [(f["from"], f["to"], f["cause"]) for f in sim.scheduler.recent_failovers]
    assert failovers == ([] if fault_on is None else [(fault_on, "rejected", "raise")])
    if package == "port":
        assert not sim.scheduler.recent_rejections
    return sim_history(res)


def test_port_kernel_history_is_the_reference_kernel_history():
    got = history("port", "kernel")
    want = history("ref", "kernel")
    assert got == want
    # The scenario exercises the interesting paths.
    assert got["finished"] >= 74


def test_port_kernel_history_is_the_port_oracle_history():
    assert history("port", "kernel") == history("port", "oracle")


@pytest.mark.parametrize("mode", ["rebuild", "incremental"])
def test_snapshot_modes_agree(mode):
    assert history("port", "kernel", mode) == history("port", "kernel", "auto")


def test_workload_copy_is_the_test_workload():
    assert plain(sim_workload()) == plain(workload(PORT))


def test_mesh_rung_history_is_the_single_device_history():
    """The service's mesh rung (`mesh="2x2"`: four shard threads on the
    CPU, parallel.multihost.resolve_solver) reproduces the single-device
    kernel history, as the reference's sharded service does."""
    assert history("port", "kernel", mesh="2x2") == history("port", "kernel")


def test_fault_on_the_card_ladder_is_an_oracle_fault():
    """One solver_raise on local:cuda, the card's one rung, rejects that
    round and requeues its work (no "lax" or host rung re-solves it):
    the history is that of an oracle service, the port's and the
    reference's, after the same fault on its one rung. chip_smoke.py
    holds the card to this."""
    got = history("port", "kernel", fault_on="local:cuda")
    assert got == history("port", "oracle", fault_on="oracle")
    assert got == history("ref", "oracle", fault_on="oracle")
