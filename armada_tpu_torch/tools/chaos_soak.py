"""Chaos soak: seeded FaultPlans through the simulator, invariants asserted.

Runs N seeded fault plans (executor crashes/hangs, lease faults, leader
flaps, torn event-log writes, and network partitions on the virtual
clock) through whole-fleet simulator runs on the REAL control-plane code
path, asserting after each:

  - zero jobdb invariant violations (enable_assertions runs
    txn.assert_valid() after every cycle — including the split-brain
    invariant that no job ever holds two active runs);
  - every job reached a terminal state (faults delay work, never lose it);
  - determinism: the same seed run twice produces the IDENTICAL final
    jobdb digest (state + final placement per job) — the property that
    makes chaos failures reproducible from a one-line seed.

Every seeded plan carries partition faults on top of the generated mix:
a short sever that heals MID-LEASE (window < executor timeout, so held
work resumes and reports late), a long partition that heals only AFTER
the scheduler reassigned the executor's runs (anti-entropy must resolve
the zombies/duplicates to exactly one terminal outcome per job), and the
workload includes gang waves so partitions land during gang placement.

Usage:
  python -m armada_tpu_torch.tools.chaos_soak [--plans 20] [--backend kernel]
      [--jobs 40] [--no-determinism-check] [--device cpu]
  python -m armada_tpu_torch.tools.chaos_soak --solver-faults --plans 3 --jobs 24

--solver-faults switches to the self-healing-solve-path soak (kernel
backend): seeded windows of solver_raise / solver_hang /
solver_nan_poison / solver_wrong_placement over live rounds, asserting
every fault fired and was contained (no invalid round committed, all
jobs terminal), every rejection left a loadable .atrace postmortem that
replays DIVERGED offline, and the run is seed-deterministic.

Exit code 0 = clean soak; prints one JSON line per plan and a summary.

This is the port's copy of the JAX package's tools/chaos_soak.py. Its
simulations solve on the kernel backend unless the caller asks for the
host oracle (`--backend oracle`), and on --device (`device=` of the
functions): the CUDA card unless the caller asks for the CPU. On the
card the failover ladder is the `local:cuda` rung alone, so a raised or
hung round is rejected and its work requeues (with a postmortem bundle),
where the CPU's ladder fails over to its next rung.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile


# The soak's declared SLOs (--slo): round latency is REAL wall clock
# per cycle (oracle cycles are milliseconds; a 5s cycle under this tiny
# fleet is a pathology), queue wait is VIRTUAL seconds — generous
# headroom over the worst legitimate partition-window requeue delay so
# chaos-delayed-but-recovered work does not false-positive the gate.
def soak_slos(queue_wait_s: float = 3600.0, round_s: float = 5.0):
    from armada_tpu_torch.core.config import SLOSpec

    return (
        SLOSpec(name="round-latency", signal="round_seconds",
                threshold_s=round_s, objective=0.95),
        SLOSpec(name="queue-wait", signal="queue_wait_seconds",
                threshold_s=queue_wait_s, objective=0.95),
    )


def build_sim(seed: int, backend: str, n_jobs: int, data_dir: str | None,
              slos=None, device=None):
    from armada_tpu_torch.core.config import SchedulingConfig
    from armada_tpu_torch.services.chaos import FaultPlan, FaultSpec
    from armada_tpu_torch.sim.simulator import (
        ClusterSpec,
        JobTemplate,
        NodeTemplate,
        QueueSpecSim,
        ShiftedExponential,
        Simulator,
        WorkloadSpec,
    )

    executors = ["chaos-c0", "chaos-c1"]
    # The workload spans the same horizon the fault windows are drawn
    # over (waves of submissions through [0, 0.75*duration)), so crash /
    # flap / torn-write windows actually intersect live work.
    duration = 1200.0
    timeout = 120.0
    generated = FaultPlan.generate(
        seed, duration, executors=executors, events_per_kind=2
    )
    # Partition faults on top of the generated mix, engineered around the
    # executor timeout so every seed exercises both heal regimes:
    #   - short sever healing MID-LEASE (window < timeout: no expiry,
    #     held pods report late);
    #   - long partition healing AFTER REASSIGNMENT (window > timeout:
    #     runs expired + fence bumped while dark; anti-entropy must
    #     resolve zombies/duplicates to one terminal outcome per job).
    # Starts anchor just after a submission wave lands (waves at
    # 0/225/450/675; placements need a cycle, runtimes are >= 60s), so
    # the sever catches pods RUNNING on the target — with small per-seed
    # jitter so the interleaving still varies. The long partition also
    # overlaps the second gang wave (t=490).
    wave = duration * 0.75 / 4
    short_start = wave + 35.0 + (seed % 4) * 5.0
    long_start = 2 * wave + 30.0 + (seed % 4) * 5.0
    partitions = (
        FaultSpec(
            "network_partition",
            executors[seed % 2],
            start=short_start,
            duration=timeout * 0.5,
        ),
        FaultSpec(
            "network_partition",
            executors[(seed + 1) % 2],
            start=long_start,
            duration=timeout * 2.0,
        ),
        # Second long sever on the OTHER link, over the last wave: both
        # executors see a heal-after-reassignment partition every seed,
        # whatever the generated crash/hang windows blot out.
        FaultSpec(
            "network_partition",
            executors[seed % 2],
            start=3 * wave + 30.0 + (seed % 4) * 5.0,
            duration=timeout * 2.0,
        ),
    )
    plan = FaultPlan(
        sorted(
            generated.faults + partitions,
            key=lambda f: (f.start, f.kind, f.target),
        ),
        seed=seed,
    )
    config = SchedulingConfig(
        enable_assertions=True,  # jobdb invariants checked every cycle
        # Crashed executors must expire well inside the sim horizon.
        executor_timeout_s=timeout,
        max_retries=10,
    )
    clusters = [
        ClusterSpec(name=name, node_templates=(NodeTemplate(count=10),))
        for name in executors
    ]
    waves = 4
    per_wave = max(1, n_jobs // (2 * waves))
    workload = WorkloadSpec(
        queues=tuple(
            QueueSpecSim(
                name=f"q{i}",
                job_templates=tuple(
                    JobTemplate(
                        id=f"t{i}w{w}",
                        number=per_wave,
                        cpu="2",
                        memory="4Gi",
                        runtime=ShiftedExponential(minimum=60.0, tail_mean=60.0),
                        submit_time=w * duration * 0.75 / waves + i * 20.0,
                    )
                    for w in range(waves)
                )
                # Gang waves: all-or-nothing placements in flight while
                # partitions sever an executor (the gang path is where a
                # half-resurrected zombie would hurt most).
                + tuple(
                    JobTemplate(
                        id=f"g{i}w{w}",
                        number=4,
                        gang_cardinality=2,
                        cpu="2",
                        memory="4Gi",
                        runtime=ShiftedExponential(minimum=90.0),
                        submit_time=(
                            w * duration * 0.75 / waves + 40.0 + i * 20.0
                        ),
                    )
                    for w in range(0, waves, 2)
                ),
            )
            for i in range(2)
        )
    )
    slo_tracker = None
    if slos:
        from armada_tpu_torch.services.slo import SLOTracker

        slo_tracker = SLOTracker(slos)
    return Simulator(
        clusters,
        workload,
        config,
        backend=backend,
        seed=seed,
        cycle_interval=10.0,
        max_time=6 * 3600.0,
        fault_plan=plan,
        data_dir=data_dir,
        slo=slo_tracker,
        device=device,
    ), plan


def jobdb_digest(sim) -> str:
    """Stable digest of final per-job state + placement (run ids excluded:
    they are fresh uuids every run by design)."""
    txn = sim.scheduler.jobdb.read_txn()
    rows = []
    for job in sorted(txn.all_jobs(), key=lambda j: j.id):
        run = job.latest_run
        rows.append(
            (
                job.id,
                job.state.value,
                job.num_attempts,
                run.node_id if run is not None else "",
            )
        )
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def run_plan(seed: int, backend: str = "kernel", n_jobs: int = 40,
             use_file_log: bool = True, slos=None, device=None) -> dict:
    """One soak iteration; raises on any invariant violation (with
    `slos`, a declared-SLO breach — services/slo.py burn-rate verdict
    over the run — is an invariant violation too)."""
    tmp = None
    data_dir = None
    if use_file_log:
        tmp = tempfile.TemporaryDirectory(prefix=f"chaos-soak-{seed}-")
        data_dir = tmp.name
    try:
        sim, plan = build_sim(seed, backend, n_jobs, data_dir, slos=slos,
                              device=device)
        result = sim.run()
        # Final invariant sweep on top of the per-cycle assertions
        # (assert_valid includes the split-brain invariant: at most one
        # live run per job, every run id owned by exactly one job).
        txn = sim.scheduler.jobdb.read_txn()
        txn.assert_valid()
        # Explicit double-active-run sweep, belt over the braces: a
        # healed partition must never leave a job running twice.
        from armada_tpu_torch.jobdb.jobdb import RunState

        live = (RunState.LEASED, RunState.PENDING, RunState.RUNNING)
        for job in txn.all_jobs():
            active = [r.id for r in job.runs if r.state in live]
            if len(active) > 1:
                raise AssertionError(
                    f"seed {seed}: job {job.id} holds two active runs "
                    f"{active} after the soak"
                )
        unfinished = result.total_jobs - sum(
            1 for s in result.events_by_job.values() if s.terminal
        )
        if unfinished:
            raise AssertionError(
                f"seed {seed}: {unfinished}/{result.total_jobs} jobs never "
                "reached a terminal state under chaos"
            )
        slo_verdict = None
        if sim.slo is not None:
            slo_verdict = sim.slo.evaluate(now=result.makespan)
            if not slo_verdict["ok"]:
                raise AssertionError(
                    f"seed {seed}: SLO breach: "
                    + "; ".join(slo_verdict["breaches"])
                )
        crashes = getattr(sim.log, "crashes", 0)
        anti_entropy: dict = {}
        for ex in sim.executors:
            for kind, count in getattr(ex, "anti_entropy", {}).items():
                anti_entropy[kind] = anti_entropy.get(kind, 0) + count
        return {
            "seed": seed,
            "digest": jobdb_digest(sim),
            "finished": result.finished_jobs,
            "total": result.total_jobs,
            "preemptions": result.preemptions,
            "cycles": result.cycles,
            "makespan": round(result.makespan, 1),
            "faults_fired": plan.fired(),
            "log_crashes": crashes,
            "anti_entropy": anti_entropy,
            "fences": dict(sim.scheduler.executor_fences),
            **(
                {
                    "slo": {
                        "ok": slo_verdict["ok"],
                        "slos": [
                            {k: s[k] for k in ("name", "observed", "good",
                                               "bad", "compliance")}
                            for s in slo_verdict["slos"]
                        ],
                    }
                }
                if slo_verdict is not None
                else {}
            ),
        }
    finally:
        if tmp is not None:
            tmp.cleanup()


# ------------------------------------------------- solver-fault soak mode

def build_solver_sim(seed: int, n_jobs: int, data_dir: str, device=None):
    """Kernel-backend sim under a solver-fault plan: each fault kind the
    self-healing solve path contains (services/chaos.SOLVER_FAULT_KINDS)
    gets its own window over cycles where backlogged work guarantees a
    live solve. One small cluster, multi-wave backlog (jobs >> cores, 60s+
    runtimes) so rounds keep solving through every window:

      - solver_hang over the first wave's backlog: the primary rung
        fails over same-cycle;
      - solver_raise with count=9 on "*": every rung raises for 3
        consecutive rounds, opening the non-terminal circuit breakers
        (threshold 3) — rounds land on the oracle terminal rung (always
        offered, open breaker or not) until the cooldown's shadow probe
        restores the ladder;
      - solver_nan_poison / solver_wrong_placement on later waves: the
        admission firewall rejects the poisoned round on each corrupted
        rung (nothing commits, work requeues) and quarantines a
        single-round .atrace postmortem under data_dir/quarantine.
    """
    from armada_tpu_torch.core.config import SchedulingConfig
    from armada_tpu_torch.services.chaos import FaultPlan, FaultSpec
    from armada_tpu_torch.sim.simulator import (
        ClusterSpec,
        JobTemplate,
        NodeTemplate,
        QueueSpecSim,
        ShiftedExponential,
        Simulator,
        WorkloadSpec,
    )

    j = (seed % 4) * 5.0  # per-seed window jitter: vary the hit rounds
    faults = (
        FaultSpec("solver_hang", "*", start=12.0 + j, duration=40.0,
                  count=1),
        FaultSpec("solver_raise", "*", start=102.0 + j, duration=40.0,
                  count=9),
        FaultSpec("solver_nan_poison", "*", start=202.0 + j, duration=40.0,
                  count=2),
        FaultSpec("solver_wrong_placement", "*", start=302.0 + j,
                  duration=40.0, count=2),
    )
    plan = FaultPlan(faults, seed=seed)
    config = SchedulingConfig(
        enable_assertions=True,
        solver_validate=True,
        solver_failover=True,
        max_retries=10,
    )
    clusters = [
        ClusterSpec(
            name="solver-c0",
            node_templates=(NodeTemplate(count=1, cpu="8", memory="64Gi"),),
        )
    ]
    waves = 4
    per_wave = max(2, n_jobs // waves)
    workload = WorkloadSpec(
        queues=(
            QueueSpecSim(
                name="q0",
                job_templates=tuple(
                    JobTemplate(
                        id=f"sw{w}",
                        number=per_wave,
                        cpu="2",
                        memory="4Gi",
                        runtime=ShiftedExponential(minimum=60.0,
                                                   tail_mean=30.0),
                        submit_time=w * 100.0,
                    )
                    for w in range(waves)
                ),
            ),
        )
    )
    return Simulator(
        clusters,
        workload,
        config,
        backend="kernel",
        seed=seed,
        cycle_interval=10.0,
        max_time=2 * 3600.0,
        fault_plan=plan,
        data_dir=data_dir,
        device=device,
    ), plan


def run_solver_plan(seed: int, n_jobs: int = 24, replay: bool = True,
                    device=None) -> dict:
    """One solver-fault soak iteration; raises when containment failed:
    a planned fault kind never fired, an invariant violation committed
    (jobdb assert_valid / double-active-run sweep), a job never reached
    a terminal state, a rejection has no loadable postmortem bundle, or
    (with replay=True) a quarantined round replays CLEAN under a healthy
    solver — the bundle must reproduce the corruption offline as a
    placement divergence."""
    from armada_tpu_torch.services.chaos import SOLVER_FAULT_KINDS

    with tempfile.TemporaryDirectory(
        prefix=f"chaos-solver-{seed}-"
    ) as data_dir:
        sim, plan = build_solver_sim(seed, n_jobs, data_dir, device=device)
        result = sim.run()
        txn = sim.scheduler.jobdb.read_txn()
        txn.assert_valid()
        from armada_tpu_torch.jobdb.jobdb import RunState

        live = (RunState.LEASED, RunState.PENDING, RunState.RUNNING)
        for job in txn.all_jobs():
            active = [r.id for r in job.runs if r.state in live]
            if len(active) > 1:
                raise AssertionError(
                    f"seed {seed}: job {job.id} holds two active runs "
                    f"{active} after the solver-fault soak"
                )
        unfinished = result.total_jobs - sum(
            1 for s in result.events_by_job.values() if s.terminal
        )
        if unfinished:
            raise AssertionError(
                f"seed {seed}: {unfinished}/{result.total_jobs} jobs never "
                "reached a terminal state under solver faults"
            )
        chaos = sim.scheduler.solver_chaos
        injected = dict(chaos.injected) if chaos is not None else {}
        for kind in SOLVER_FAULT_KINDS:
            if not injected.get(kind):
                raise AssertionError(
                    f"seed {seed}: planned fault {kind} never fired "
                    f"(injected={injected}) — the plan windows missed "
                    "every live solve"
                )
        rejections = list(sim.scheduler.recent_rejections)
        if not rejections:
            raise AssertionError(
                f"seed {seed}: corruption faults fired but the admission "
                "firewall rejected nothing"
            )
        failovers = list(sim.scheduler.recent_failovers)
        if not failovers:
            raise AssertionError(
                f"seed {seed}: solver faults fired but no failover was "
                "recorded"
            )
        replayed = 0
        for rej in rejections:
            bundle = rej.get("bundle")
            if not bundle or not os.path.exists(bundle):
                raise AssertionError(
                    f"seed {seed}: rejection {rej['invariant']} on "
                    f"{rej['rung']} (cycle {rej['cycle']}) has no "
                    f"postmortem bundle at {bundle!r}"
                )
            from armada_tpu_torch.trace import load_trace, replay_trace

            trace = load_trace(bundle)
            if not replay:
                continue
            # The quarantined round must reproduce its corruption
            # offline: a healthy LOCAL replay of the recorded (poisoned)
            # decisions diverges on placement. The recording process IS
            # this process, so no target/x64 mismatch arises.
            report = replay_trace(
                trace, solvers=["LOCAL"], log=lambda msg: None, device=device
            )
            if not report["divergences"].get("placement"):
                raise AssertionError(
                    f"seed {seed}: quarantined round {os.path.basename(bundle)} "
                    "replayed CLEAN — the bundle does not reproduce the "
                    f"corruption (divergences={report['divergences']})"
                )
            replayed += 1
        ladder = (
            sim.scheduler.doctor_report().get("ladder")
            if hasattr(sim.scheduler, "doctor_report")
            else None
        )
        return {
            "seed": seed,
            "mode": "solver-faults",
            "digest": jobdb_digest(sim),
            "finished": result.finished_jobs,
            "total": result.total_jobs,
            "cycles": result.cycles,
            "makespan": round(result.makespan, 1),
            "injected": injected,
            "rejections": [
                {k: rej[k] for k in ("cycle", "rung", "invariant")}
                for rej in rejections
            ],
            "failovers": [
                {k: fo[k] for k in ("cycle", "from", "to", "cause")}
                for fo in failovers
            ],
            "bundles_replayed": replayed,
            "ladder": ladder,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chaos-soak")
    ap.add_argument("--plans", type=int, default=20)
    ap.add_argument("--backend", default="kernel",
                    choices=["oracle", "kernel"])
    ap.add_argument("--jobs", type=int, default=40)
    ap.add_argument("--no-determinism-check", action="store_true")
    ap.add_argument("--solver-faults", action="store_true",
                    help="run the solver-fault soak instead (kernel "
                    "backend, solver_raise/hang/nan_poison/"
                    "wrong_placement windows; asserts containment, "
                    "quarantine bundles, and offline replay — use with "
                    "--plans 3 and --jobs 24)")
    ap.add_argument("--slo", action="store_true",
                    help="gate each plan on the soak's declared SLOs "
                    "(services/slo.py): real-wall round latency and "
                    "virtual-clock queue wait")
    ap.add_argument("--slo-queue-wait", type=float, default=3600.0,
                    help="queue-wait SLO threshold in VIRTUAL seconds "
                    "(with --slo; a deliberately tiny value proves the "
                    "gate trips)")
    ap.add_argument("--device", default=None,
                    help="device of the kernel backend's solves (default: "
                    "the CUDA card; `cpu` for a run without one)")
    args = ap.parse_args(argv)

    slos = (
        soak_slos(queue_wait_s=args.slo_queue_wait) if args.slo else None
    )
    failures = 0
    for seed in range(args.plans):
        try:
            if args.solver_faults:
                first = run_solver_plan(seed, args.jobs, device=args.device)
                if not args.no_determinism_check:
                    # Replay already proved the bundles diverge on the
                    # first run; the determinism pass only needs digests.
                    second = run_solver_plan(seed, args.jobs, replay=False,
                                             device=args.device)
                    if first["digest"] != second["digest"]:
                        raise AssertionError(
                            f"seed {seed}: nondeterministic final jobdb "
                            f"({first['digest'][:12]} != "
                            f"{second['digest'][:12]})"
                        )
                print(json.dumps(first))
                continue
            first = run_plan(seed, args.backend, args.jobs, slos=slos,
                             device=args.device)
            if not args.no_determinism_check:
                second = run_plan(seed, args.backend, args.jobs, slos=slos,
                                  device=args.device)
                if first["digest"] != second["digest"]:
                    raise AssertionError(
                        f"seed {seed}: nondeterministic final jobdb "
                        f"({first['digest'][:12]} != {second['digest'][:12]})"
                    )
            print(json.dumps(first))
        except Exception as e:
            failures += 1
            print(json.dumps({"seed": seed, "error": repr(e)}))
    print(
        json.dumps(
            {
                "plans": args.plans,
                "failures": failures,
                "determinism_checked": not args.no_determinism_check,
            }
        )
    )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
