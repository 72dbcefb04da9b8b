"""The port stands alone: no module of armada_tpu_torch (the home/away
scenario module, the hot window, the transfer ledger and the control
plane included), and not chip_smoke.py, imports jax, armada_tpu or yaml,
also when the main path, the fast-fill path, a budgeted, compacted
solve, a market round, a deadline-policy round, a warm cycle
(incremental snapshot, resident round, fairness ledger) and a few
scheduler-service cycles (event log, ingester, job database, submit
service, fake executor, failover ladder, resident rounds, drift sweep)
run, and a simulation with a fault injected on `local:cuda` fails over
to LOCAL on the CPU's ladder; and the default device is the CUDA card, which raises where
there is none."""

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

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "armada_tpu", "yaml"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT)
    import armada_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        armada_tpu_torch.__path__, "armada_tpu_torch.")]
    for name in names:
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
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "armada_tpu", "yaml"))
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
