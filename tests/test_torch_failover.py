"""The port's failover ladder (solver/failover.py) and the service's
solve over it: port copies of tests/test_solver_selfheal.py's ladder
cases with the port's rungs, and a fault injected on `local:cuda`
through the port's SolverChaos that fails over to LOCAL with the
reference's attribution.

The port's kernel backend defaults to `solve_kernel_path="cuda"`, so on
the CPU its ladder is `local:cuda` -> LOCAL -> `hotwindow:64` -> oracle
(the JAX package's default "lax" path has no `local:` rung); with the
reference's own "lax" path the two ladders are equal label for label.
On the card the ladder is the configured path alone: a fault there
rejects the round and requeues its work, with no "lax" or host rung to
hide it.
"""

import os
import time as _time
import types

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu.core.config import SchedulingConfig as RefConfig
from armada_tpu.solver.failover import build_ladder as ref_build_ladder
from armada_tpu_torch.core.config import SchedulingConfig
from armada_tpu_torch.events import InMemoryEventLog
from armada_tpu_torch.services.chaos import FaultPlan, FaultSpec, SolverChaos
from armada_tpu_torch.services.scheduler import SchedulerService
from armada_tpu_torch.solver.failover import FailoverLadder, build_ladder
from torch_control_plane import PORT, REF, leases_view

LADDER = ["local:cuda", "LOCAL", "hotwindow:64", "oracle"]


def test_build_ladder_shapes():
    cfg = SchedulingConfig()
    assert cfg.solve_kernel_path == "cuda"
    kernel = build_ladder("kernel", None, cfg, device="cpu")
    assert [r.label for r in kernel] == LADDER
    assert [r.kind for r in kernel] == ["local", "local", "hotwindow", "oracle"]
    assert kernel[0].param == "cuda" and kernel[1].param is None
    meshed = build_ladder("kernel", "2x2", cfg, device="cpu")
    assert [r.label for r in meshed] == ["mesh:2x2"] + LADDER
    oracle = build_ladder("oracle", None, cfg, device="cpu")
    assert [r.label for r in oracle] == ["oracle"]
    # The degraded-retry rung is a FIXED small window, independent of the
    # configured hot window.
    big = SchedulingConfig(hot_window_slots=4096)
    assert build_ladder("kernel", None, big, device="cpu")[2].param == 64
    # On the reference's own path the two ladders agree rung for rung.
    for mesh in (None, "2x4"):
        ref = ref_build_ladder("kernel", mesh, RefConfig())
        port = build_ladder("kernel", mesh, SchedulingConfig(solve_kernel_path="lax"),
                            device="cpu")
        assert [(r.kind, r.label, r.param) for r in port] == [
            (r.kind, r.label, r.param) for r in ref]


@pytest.mark.parametrize("device", [None, "cuda", "cuda:1"])
def test_card_ladder_stays_on_the_card(device):
    """On the card (the default device) the kernel ladder is the
    configured path alone, `mesh:<spec>` first with a mesh: no "lax" rung
    and no host oracle below it. The oracle backend's ladder is the
    oracle, wherever the service runs."""
    cfg = SchedulingConfig()
    assert [r.label for r in build_ladder("kernel", None, cfg, device=device)] == ["local:cuda"]
    assert [r.label for r in build_ladder("kernel", "2x2", cfg, device=device)] == [
        "mesh:2x2", "local:cuda"]
    lax = SchedulingConfig(solve_kernel_path="lax")
    assert [r.label for r in build_ladder("kernel", None, lax, device=device)] == ["LOCAL"]
    assert [r.label for r in build_ladder("oracle", None, cfg, device=device)] == ["oracle"]


def test_ladder_breaker_lifecycle():
    ladder = FailoverLadder(
        build_ladder("kernel", None, SchedulingConfig(), device="cpu"),
        failure_threshold=2, cooldown_rounds=3,
    )
    live, probes = ladder.plan(0)
    assert [r.label for r in live] == LADDER
    assert probes == []
    # Two consecutive failures open local:cuda; it leaves the live list.
    ladder.record_failure("local:cuda", 0)
    ladder.record_failure("local:cuda", 1)
    assert ladder.state("local:cuda", 1) == "open"
    live, probes = ladder.plan(2)
    assert [r.label for r in live] == LADDER[1:]
    assert probes == []
    # After the cooldown the rung goes half-open: offered as a SHADOW
    # probe, still not live.
    live, probes = ladder.plan(5)
    assert [r.label for r in live] == LADDER[1:]
    assert [r.label for r in probes] == ["local:cuda"]
    # A clean probe restores it to the live ladder.
    ladder.record_success("local:cuda", 5)
    live, probes = ladder.plan(6)
    assert [r.label for r in live] == LADDER
    assert probes == []
    # A FAILED probe re-opens for another full cooldown.
    ladder.record_failure("local:cuda", 6)
    ladder.record_failure("local:cuda", 7)
    live, probes = ladder.plan(8)
    assert [r.label for r in live] == LADDER[1:]
    _, probes = ladder.plan(11)
    assert [r.label for r in probes] == ["local:cuda"]
    ladder.record_failure("local:cuda", 11)
    live, probes = ladder.plan(12)
    assert [r.label for r in live] == LADDER[1:]
    assert probes == []


def test_ladder_terminal_rung_always_offered():
    """Even with EVERY breaker open — terminal included — the plan still
    offers the oracle: the ladder can reject a round, never strand it."""
    ladder = FailoverLadder(
        build_ladder("kernel", None, SchedulingConfig(), device="cpu"),
        failure_threshold=1, cooldown_rounds=100,
    )
    for rung in LADDER:
        ladder.record_failure(rung, 0)
        assert ladder.state(rung, 0) == "open"
    live, probes = ladder.plan(1)
    assert [r.label for r in live] == ["oracle"]
    assert probes == []
    snap = ladder.snapshot(1)
    assert [row["terminal"] for row in snap] == [False, False, False, True]
    assert all(row["state"] == "open" for row in snap)


def test_solve_budget_bounds_failover_retries(monkeypatch):
    """With the round budget exhausted, a failed primary does NOT walk
    the rest of the ladder — the round rejects and work stays queued."""
    cfg = SchedulingConfig()
    sched = SchedulerService(cfg, InMemoryEventLog(), backend="kernel", device="cpu")
    assert sched.failover is not None
    calls = []

    def failing_attempt(snap, rung, **kw):
        calls.append(rung.label)
        raise RuntimeError("injected solve fault")

    monkeypatch.setattr(sched, "_attempt_round", failing_attempt)
    snap = types.SimpleNamespace(pool="default")

    # No deadline: every live rung is tried before the round rejects.
    sched._round_deadline = None
    assert sched._solve(snap) is None
    assert calls == LADDER

    # Deadline already blown: only the primary runs; retries are skipped.
    calls.clear()
    sched.failover = FailoverLadder(build_ladder("kernel", None, cfg, device="cpu"))  # fresh breakers
    sched._round_deadline = _time.monotonic() - 1.0
    assert sched._solve(snap) is None
    assert calls == ["local:cuda"]


def test_solve_failover_attribution(monkeypatch):
    """A round that fails over carries {from,to,cause} attribution, and
    the rejection/failover ledgers the doctor surfaces read are fed."""
    sched = SchedulerService(SchedulingConfig(), InMemoryEventLog(), backend="kernel",
                             device="cpu")
    sched._round_deadline = None

    def flaky_attempt(snap, rung, **kw):
        if rung.label == "local:cuda":
            raise RuntimeError("injected solve fault")
        return {"scheduled_mask": np.zeros(0, dtype=bool)}

    monkeypatch.setattr(sched, "_attempt_round", flaky_attempt)
    result = sched._solve(types.SimpleNamespace(pool="default"))
    assert result is not None
    assert result["failover"] == {"from": "local:cuda", "to": "LOCAL", "cause": "raise"}
    assert result["rung"] == "LOCAL"
    fo = list(sched.recent_failovers)
    assert fo and fo[-1]["from"] == "local:cuda"
    assert fo[-1]["to"] == "LOCAL" and fo[-1]["cause"] == "raise"
    doc = sched.doctor_report()
    assert doc["failover_enabled"] and doc["validation_enabled"]
    assert [row["rung"] for row in doc["ladder"]] == LADDER
    assert doc["ladder"][0]["consecutive_failures"] == 1


def _stack(pkg, chaos=None, snapshot_mode="rebuild", backend="kernel"):
    config = pkg.SchedulingConfig(
        priority_classes={"d": pkg.PriorityClass("d", 1000, preemptible=True)},
        default_priority_class="d",
    )
    log = pkg.InMemoryEventLog()
    sched = pkg.SchedulerService(config, log, backend=backend, snapshot_mode=snapshot_mode)
    if chaos is not None:
        sched.attach_solver_chaos(chaos)
    submit = pkg.SubmitService(config, log, scheduler=sched)
    ex = pkg.FakeExecutor("c1", log, sched,
                          nodes=pkg.make_nodes("c1", count=3, cpu="8", memory="32Gi"),
                          runtime_for=lambda job_id: 100.0)
    submit.create_queue(pkg.QueueSpec("q"))
    submit.submit("q", "s", [
        pkg.JobSpec(id=f"job-{i:04d}", queue="", requests={"cpu": "2", "memory": "2Gi"})
        for i in range(7)
    ], now=0.0)
    return sched, ex, submit


@pytest.mark.parametrize("kind, cause", [("solver_raise", "raise"), ("solver_hang", "hang"),
                                         ("solver_nan_poison", "validation")])
def test_injected_fault_on_local_cuda_fails_over_to_lax(kind, cause):
    """A fault on `local:cuda` at the round at t=1 (SolverChaos, the
    chaos plan's solver seam): the round reports the failover from
    local:cuda to LOCAL with the reference's attribution, the leases are
    the reference's (whose first rung is LOCAL, on its "lax" path), and
    the next round is back on local:cuda."""
    clock = [0.0]
    plan = FaultPlan([FaultSpec(kind, "local:cuda", start=1.0, duration=0.5)])
    chaos = SolverChaos(plan, clock=lambda: clock[0])
    ref, ref_ex, _ = _stack(REF)
    port, port_ex, _ = _stack(PORT, chaos)
    for t in (1.0, 2.0):
        clock[0] = t
        for sched, ex in ((ref, ref_ex), (port, port_ex)):
            ex.tick(t)
            sched.cycle(now=t)
        assert leases_view(port.jobdb) == leases_view(ref.jobdb), t
        stats = port.last_cycle_stats
        if t == 1.0:
            assert stats["failover"] == {"from": "local:cuda", "to": "LOCAL", "cause": cause}
            assert stats["rung"] == "LOCAL" and stats["scheduled"] == 7
            assert [(f["from"], f["to"], f["cause"]) for f in port.recent_failovers] == [
                ("local:cuda", "LOCAL", cause)]
            if cause == "validation":
                # The rejected round is quarantined as a postmortem bundle.
                assert port.recent_rejections[-1]["rung"] == "local:cuda"
                assert port.recent_rejections[-1]["bundle"].endswith(".atrace")
                assert os.path.exists(port.recent_rejections[-1]["bundle"])
        else:
            assert stats["failover"] is None and stats["rung"] == "local:cuda"
    assert chaos.injected.get(kind) == 1
    journey = port.timeline.get("job-0000")
    assert any("placed by fallback solver LOCAL after" in e["detail"]
               for e in journey["entries"])


def test_faults_down_to_the_hot_window_rung_on_a_resident_round():
    """Faults on both local rungs at t=1 send the port's round to
    `hotwindow:64` (the "lax" path over a compacted round), solved from
    the pool's resident round; the reference, faulted on its LOCAL rung,
    lands on the same rung, and the leases are equal."""
    clock = [0.0]

    def chaos(pkg, targets):
        plan = pkg.FaultPlan([pkg.FaultSpec("solver_raise", t, start=1.0, duration=0.5)
                              for t in targets])
        return pkg.SolverChaos(plan, clock=lambda: clock[0])

    from armada_tpu.services import chaos as ref_chaos
    from armada_tpu_torch.services import chaos as port_chaos

    ref, ref_ex, ref_submit = _stack(REF, chaos(ref_chaos, ["LOCAL"]), snapshot_mode="auto")
    port, port_ex, port_submit = _stack(PORT, chaos(port_chaos, ["local:cuda", "LOCAL"]),
                                        snapshot_mode="auto")
    for t in (0.0, 1.0, 2.0):
        clock[0] = t
        for pkg, sched, ex, submit in ((REF, ref, ref_ex, ref_submit),
                                       (PORT, port, port_ex, port_submit)):
            # Work arrives every cycle, so the faulted round places jobs.
            submit.submit("q", f"s{t}", [
                pkg.JobSpec(id=f"late-{t}-{i}", queue="", requests={"cpu": "1", "memory": "1Gi"})
                for i in range(3)
            ], now=t)
            ex.tick(t)
            sched.cycle(now=t)
        assert leases_view(port.jobdb) == leases_view(ref.jobdb), t
        stats = port.last_cycle_stats
        assert stats["snapshot_mode"] == "resident"
        assert stats["scheduled"] > 0, t
        if t == 1.0:
            assert stats["rung"] == "hotwindow:64"
            assert stats["failover"] == {"from": "local:cuda", "to": "hotwindow:64",
                                         "cause": "raise"}
    assert [(f["from"], f["to"]) for f in port.recent_failovers] == [
        ("local:cuda", "LOCAL"), ("LOCAL", "hotwindow:64")]
    assert [(f["from"], f["to"]) for f in ref.recent_failovers] == [("LOCAL", "hotwindow:64")]


def test_fault_on_the_card_ladder_rejects_and_requeues():
    """The card's ladder (`local:cuda` alone, put in place of the CPU's
    on a service that solves on the CPU): a fault on local:cuda at t=1
    rejects the round with its cause recorded, leases nothing and runs
    no other rung; the work stays queued and leases at t=2 on
    local:cuda, as the reference leases it at t=2 after the same fault
    on its one rung (the oracle's)."""
    clock = [0.0]

    def chaos(pkg, target):
        plan = pkg.FaultPlan([pkg.FaultSpec("solver_raise", target, start=1.0, duration=0.5)])
        return pkg.SolverChaos(plan, clock=lambda: clock[0])

    from armada_tpu.services import chaos as ref_chaos
    from armada_tpu_torch.services import chaos as port_chaos

    port, port_ex, _ = _stack(PORT, chaos(port_chaos, "local:cuda"))
    port._rungs = build_ladder("kernel", None, port.config, device="cuda")
    port.failover = FailoverLadder(port._rungs)
    ref, ref_ex, _ = _stack(REF, chaos(ref_chaos, "oracle"), backend="oracle")
    for t in (1.0, 2.0):
        clock[0] = t
        for sched, ex in ((ref, ref_ex), (port, port_ex)):
            ex.tick(t)
            sched.cycle(now=t)
        assert leases_view(port.jobdb) == leases_view(ref.jobdb), t
        if t == 1.0:
            assert {v[0] for v in leases_view(port.jobdb).values()} == {"queued"}
            assert [(f["from"], f["to"], f["cause"]) for f in port.recent_failovers] == [
                ("local:cuda", "rejected", "raise")]
        else:
            stats = port.last_cycle_stats
            assert stats["rung"] == "local:cuda" and stats["failover"] is None
            assert stats["scheduled"] == 7
    assert [(f["from"], f["to"]) for f in ref.recent_failovers] == [("oracle", "rejected")]


def test_card_ladder_rejection_leaves_a_postmortem_bundle(tmp_path):
    """A fault that ends the card's one-rung ladder quarantines the
    rejected round as a single-round bundle in the quarantine directory:
    the round's inputs (a raised solve has no decision stream), named
    after its cycle, pool, cause and rung. The bundle replays on the
    "cuda" path, its solve valid on the bundle's own round; the
    health surface's solver-ladder checker stays healthy and names the
    rejection's rung once its breaker opens."""
    import dataclasses

    from armada_tpu_torch.services.health import SolverLadderChecker
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.validate import validate_round
    from armada_tpu_torch.trace import load_trace, replay_trace

    clock = [0.0]
    plan = FaultPlan([FaultSpec("solver_raise", "local:cuda", start=1.0, duration=3.5)])
    port, ex, _ = _stack(PORT, SolverChaos(plan, clock=lambda: clock[0]))
    port.config = dataclasses.replace(port.config, quarantine_dir=str(tmp_path))
    port.quarantine_dir = str(tmp_path)
    port._rungs = build_ladder("kernel", None, port.config, device="cuda")
    port.failover = FailoverLadder(port._rungs, failure_threshold=3)
    for t in (1.0, 2.0, 3.0):
        clock[0] = t
        ex.tick(t)
        port.cycle(now=t)
    bundles = [f["bundle"] for f in port.recent_failovers]
    assert len(bundles) == 3 and all(os.path.dirname(b) == str(tmp_path) for b in bundles)
    assert os.path.basename(bundles[0]) == "round-c000000-default-raise-local-cuda.atrace"
    trace = load_trace(bundles[0])
    assert trace.header["source"] == "postmortem" and trace.header["meta"]["invariant"] == "raise"
    (rec,) = trace.rounds
    assert rec.raw["decisions"] == {} and rec.num_jobs == 7
    report = replay_trace(trace, solvers=("cuda",), device="cpu")
    assert report["ok"] and report["rounds"] == 1, report
    dev = rec.device_round()
    out = solve_round(dev, device="cpu")
    assert validate_round(out, dev=dev) is None and int(out["scheduled_mask"].sum()) == 7
    healthy, detail = SolverLadderChecker(port).check()
    assert healthy and "local:cuda=open" in detail, detail
