"""Front-door soak: streaming submit→round→lease under chaos + SLO gate.

Drives a STREAMING workload (jobs are generated on the fly, never
pre-built — the harness scales to 10M jobs across thousands of tenants
without holding the workload in memory) through the full control-plane
path: per-tenant admission → jobset-keyed shard WAL ack → per-shard
exactly-once ingest → scheduling rounds → fake-executor leases, on a
virtual clock, with a seeded chaos plan tearing shard WAL appends
(torn_log_write), severing shard ingesters (network_partition) and
crash-looping them mid-batch (executor_crash) — plus a designated FLOOD
TENANT that submits far past its rate so tenant-aware shedding is
exercised every run.

After the run the gate verifies, per seed:

  - ZERO LOST ACKS: every acknowledged job id appears in the main event
    log and in the jobdb;
  - ZERO DOUBLE-APPLIES: no job id appears in the log twice (the
    exactly-once markers held through every injected crash);
  - jobdb `assert_valid` (the split-brain invariants);
  - every acked job reached a TERMINAL state (chaos delays work, never
    loses it);
  - shed traffic carried a positive retry-after (clients back off
    deliberately, they do not time out);
  - submit p99 (wall clock through admission + durable WAL ack) under
    the SLO;
  - max shard ingest lag under the SLO.

Any breach exits nonzero — the bench_gate analogue for front-door scale.
`--inject-loss` deliberately drops one acked WAL entry during delivery
(the fault the gate exists to catch) and MUST trip it.

Usage:
  python -m armada_tpu_torch.tools.frontdoor_soak                # committed config
  python -m armada_tpu_torch.tools.frontdoor_soak --seeds 2 --jobs 2000 --tenants 50
  python -m armada_tpu_torch.tools.frontdoor_soak --jobs 10000000 --tenants 5000
  python -m armada_tpu_torch.tools.frontdoor_soak --inject-loss  # must exit nonzero
  python -m armada_tpu_torch.tools.frontdoor_soak --backend oracle --device cpu

Exit code 0 = every seed met the SLO; 1 = breach; prints one JSON line
per seed plus a summary line.

This is the port's copy of the JAX package's tools/frontdoor_soak.py.
Its scheduler solves on the kernel backend unless the caller asks for
the host oracle (`--backend oracle`), on --device (`backend=` and
`device=` of run_soak): the CUDA card unless the caller asks for the
CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time as _time

# The committed soak config: the SLO gate in CI runs exactly this.
DEFAULTS = {
    "jobs": 4000,
    "tenants": 100,
    "shards": 4,
    "executors": 2,
    "nodes_per_executor": 16,
    "node_cpu": "16",
    "cycle_interval_s": 10.0,
    "job_runtime_s": 30.0,
    "batch": 20,          # jobs per submit RPC
    # The tenant flood: for a mid-run window one tenant attempts
    # flood_x TIMES its sustained token-bucket rate (absolute pressure,
    # not a share of traffic — at small scales a traffic share can sit
    # under the rate limit and never shed).
    "flood_x": 3.0,
    "tenant_rate": 10.0,  # jobs/s/tenant — generous for the steady tenants
    "tenant_burst": 40.0,
    "global_rate": 5000.0,
    "global_burst": 10000.0,
    "overload_rate": 200.0,
    "max_ingest_lag_events": 20000,
    "slo": {
        # Wall clock through admission + durable shard-WAL fsync ack.
        "submit_p99_s": 0.25,
        # Acked-but-undelivered WAL records (batches) on any one shard
        # at any instant — generous headroom over the partition-window
        # backlog the committed chaos plan produces (~tens).
        "max_shard_lag_events": 1000,
    },
}


def build_fault_plan(seed: int, duration: float, shards: int):
    """Seeded shard-targeted chaos over the soak horizon: a torn WAL
    append per shard, one mid-run ingester partition, and a bounded
    crash budget that kills delivery mid-batch a few times."""
    from armada_tpu_torch.services.chaos import FaultPlan, FaultSpec

    faults = []
    for i in range(shards):
        faults.append(
            FaultSpec(
                "torn_log_write", f"shard-{i}",
                start=duration * (0.1 + 0.15 * (i % 3)) + seed % 7,
                duration=duration * 0.5, count=2, param=0.4 + 0.1 * i,
            )
        )
    # One shard goes dark mid-run and heals: lag grows, nothing is lost.
    faults.append(
        FaultSpec(
            "network_partition", f"shard-{seed % shards}",
            start=duration * 0.35 + (seed % 5) * 3.0,
            duration=duration * 0.15,
        )
    )
    # Crash-restart another shard's ingester mid-batch a few times.
    faults.append(
        FaultSpec(
            "executor_crash", f"shard-{(seed + 1) % shards}",
            start=duration * 0.55 + (seed % 5) * 3.0,
            duration=duration * 0.3, count=3,
        )
    )
    faults.sort(key=lambda f: (f.start, f.kind, f.target))
    return FaultPlan(faults, seed=seed)


def run_soak(seed: int, cfg: dict, inject_loss: bool = False,
             verbose: bool = False, slos=None, backend: str = "kernel",
             device=None) -> dict:
    """One seeded soak; returns the gate document (breaches list
    included). Raises nothing for SLO breaches — the caller gates.

    `slos`: an iterable of core.config.SLOSpec (or True for the soak's
    defaults) attaches a services/slo.SLOTracker to the submit path —
    every submit (admitted, shed or expired) feeds the
    frontdoor_submit_seconds signal, the tracker's evaluate() verdict
    joins the breach list, and the raw observation stream lands in the
    doc under "slo" for offline re-evaluation by tools/slo_gate.py."""
    import numpy as np

    from armada_tpu_torch.core.config import SchedulingConfig
    from armada_tpu_torch.core.types import JobSpec, QueueSpec
    from armada_tpu_torch.events import InMemoryEventLog
    from armada_tpu_torch.events.model import SubmitJob
    from armada_tpu_torch.frontdoor import (
        AdmissionError,
        DeadlineExpired,
        FrontDoor,
        TenantAdmission,
    )
    from armada_tpu_torch.services.backpressure import StoreHealthMonitor
    from armada_tpu_torch.services.chaos import VirtualClock
    from armada_tpu_torch.services.fake_executor import FakeExecutor, make_nodes
    from armada_tpu_torch.services.scheduler import SchedulerService
    from armada_tpu_torch.services.submit import SubmitService

    rng = np.random.default_rng(seed)
    n_jobs = int(cfg["jobs"])
    n_tenants = int(cfg["tenants"])
    cycle = float(cfg["cycle_interval_s"])
    batch = int(cfg["batch"])
    # Submission horizon: spread jobs over enough virtual time that the
    # fleet can roughly keep up (cap the queued backlog, stream through).
    runtime = float(cfg["job_runtime_s"])
    capacity = (
        int(cfg["executors"]) * int(cfg["nodes_per_executor"])
        * int(cfg["node_cpu"])
    )
    horizon = max(10 * cycle, n_jobs * runtime / max(1, capacity) * 1.3)
    plan = build_fault_plan(seed, horizon, int(cfg["shards"]))
    clock = VirtualClock()
    config = SchedulingConfig(
        enable_assertions=n_jobs <= 20_000,
        executor_timeout_s=20 * cycle,
        terminal_job_retention_s=4 * horizon,
    )
    log = InMemoryEventLog()
    sched = SchedulerService(config, log, backend=backend, device=device)
    store_gate = StoreHealthMonitor(
        log, max_ingest_lag_events=int(cfg["max_ingest_lag_events"]),
        check_interval_s=0.0,
    )
    weights = {f"t{i:04d}": 1.0 for i in range(n_tenants)}
    admission = TenantAdmission(
        tenant_rate=float(cfg["tenant_rate"]),
        tenant_burst=float(cfg["tenant_burst"]),
        global_rate=float(cfg["global_rate"]),
        global_burst=float(cfg["global_burst"]),
        overload_rate=float(cfg["overload_rate"]),
        downstream=store_gate,
        quota_of=weights.get,
    )
    tmp = tempfile.TemporaryDirectory(prefix=f"frontdoor-soak-{seed}-")
    fd = FrontDoor(
        log, num_shards=int(cfg["shards"]), directory=tmp.name,
        admission=admission, fault_plan=plan, clock=clock,
    )
    store_gate.add_lag_source("scheduler-ingester",
                              lambda: max(0, log.end_offset - sched.ingester.cursor))
    store_gate.add_lag_source("frontdoor", fd.max_lag)
    tracker = None
    if slos:
        from armada_tpu_torch.core.config import SLOSpec
        from armada_tpu_torch.services.slo import SLOTracker

        specs = (
            (
                # The soak's default: the committed submit-p99 SLO as a
                # declared objective (the hand-rolled p99 check below
                # stays — the tracker adds burn-rate semantics and the
                # offline-reevaluable observation stream).
                SLOSpec(
                    name="frontdoor-p99",
                    signal="frontdoor_submit_seconds",
                    threshold_s=float(cfg["slo"]["submit_p99_s"]),
                    objective=0.99,
                ),
            )
            if slos is True
            else tuple(slos)
        )
        # The retained raw stream is bounded (oldest dropped): seed docs
        # stay printable at full-scale soaks while committed-config runs
        # export every observation for tools/slo_gate.py.
        tracker = SLOTracker(specs, keep_observations=50_000)
    submit = SubmitService(config, log, scheduler=sched, frontdoor=fd,
                           slo=tracker)
    for tenant in weights:
        submit.create_queue(QueueSpec(tenant))
    executors = [
        FakeExecutor(
            f"soak-ex{i}", log, sched,
            nodes=make_nodes(
                f"soak-ex{i}", count=int(cfg["nodes_per_executor"]),
                cpu=cfg["node_cpu"], memory="512Gi",
            ),
            runtime_for=lambda job_id: runtime,
        )
        for i in range(int(cfg["executors"]))
    ]
    if inject_loss:
        # The seeded fault the gate exists to catch: shard 0 silently
        # DROPS one acked WAL entry during delivery.
        dropped = []

        def lossy(shard, entry):
            if not dropped and entry.offset == 1:
                dropped.append(entry.offset)
                return True
            return False

        fd.shards[0].crash_hook = lossy

    tenants = sorted(weights)
    flood = tenants[seed % n_tenants]
    acked: set[str] = set()
    latencies: list[float] = []
    shed = expired = 0
    min_retry_after = float("inf")
    max_lag_seen = 0
    jid = 0
    submitted_target = n_jobs
    t = 0.0
    sub_rate = n_jobs / (horizon * 0.75)  # jobs per virtual second

    def submit_batch(tenant: str, count: int, now: float):
        nonlocal jid, shed, expired, min_retry_after
        jobs = []
        for _ in range(count):
            jobs.append(JobSpec(
                id=f"s{seed}-{jid:08d}", queue=tenant,
                jobset=f"{tenant}-js{jid % 7}",
                requests={"cpu": "1", "memory": "1Gi"},
            ))
            jid += 1
        started = _time.perf_counter()
        try:
            ids = submit.submit(tenant, jobs[0].jobset, jobs, now=now,
                                deadline_ts=now + 5 * cycle)
        except AdmissionError as e:
            shed += count
            min_retry_after = min(min_retry_after, e.retry_after_s)
            return
        except DeadlineExpired:
            expired += count
            return
        latencies.append(_time.perf_counter() - started)
        acked.update(ids)

    flood_window = (0.25 * horizon, 0.55 * horizon)
    flood_due = max(batch, int(
        float(cfg["flood_x"]) * float(cfg["tenant_rate"]) * cycle
    ))
    steady_sent = 0
    while True:
        clock.now = t
        due = int(sub_rate * cycle)
        remaining = submitted_target - steady_sent
        if remaining > 0:
            # The steady stream: the budgeted workload spread across
            # rotating tenants. Attempts count against the budget
            # whether admitted or shed, so the stream spans the whole
            # horizon and the fault windows land on live traffic.
            wave = min(due, remaining)
            spent = 0
            while spent < wave:
                tenant = tenants[int(rng.integers(n_tenants))]
                count = min(batch, wave - spent)
                submit_batch(tenant, count, t)
                spent += count
            steady_sent += spent
        if flood_window[0] <= t < flood_window[1]:
            # The tenant flood: flood_x times the flood tenant's
            # sustained rate for a bounded mid-run window — far past its
            # bucket, so tenant-aware shedding engages EVERY run while
            # its neighbours' buckets stay untouched. Flood attempts
            # ride on top of the steady budget (shed traffic is
            # pressure, not workload).
            for off in range(0, flood_due, batch):
                submit_batch(flood, min(batch, flood_due - off), t)
        fd.pump(now=t)
        max_lag_seen = max(max_lag_seen, fd.max_lag())
        for ex in executors:
            ex.tick(t)
        sched.cycle(now=t)
        for ex in executors:
            ex.tick(t)
        txn = sched.jobdb.read_txn()
        terminal = sum(1 for j in txn.all_jobs() if j.state.terminal)
        done_submitting = (
            steady_sent >= submitted_target or t > horizon * 0.75
        )
        if done_submitting and fd.max_lag() == 0 and terminal >= len(acked):
            break
        if t > 6 * horizon:
            break  # safety: gate will flag stuck work
        t += cycle

    # ---- verification sweep ----
    breaches = []
    submit_counts: dict[str, int] = {}
    for entry in log.read(0, 10 ** 9):
        for event in entry.sequence.events:
            if isinstance(event, SubmitJob):
                jid_ = event.job.id
                submit_counts[jid_] = submit_counts.get(jid_, 0) + 1
    duplicates = sorted(j for j, c in submit_counts.items() if c > 1)
    lost = sorted(j for j in acked if j not in submit_counts)
    if duplicates:
        breaches.append(
            f"{len(duplicates)} acked submits double-applied "
            f"(first: {duplicates[0]})"
        )
    if lost:
        breaches.append(
            f"{len(lost)} acked submits lost (first: {lost[0]})"
        )
    txn = sched.jobdb.read_txn()
    try:
        txn.assert_valid()
    except AssertionError as e:
        breaches.append(f"jobdb invariant violation: {e}")
    non_terminal = sorted(
        j for j in acked
        if (job := txn.get(j)) is None or not job.state.terminal
    )
    if non_terminal:
        breaches.append(
            f"{len(non_terminal)} acked jobs never reached a terminal "
            f"state (first: {non_terminal[0]})"
        )
    if shed and min_retry_after <= 0:
        breaches.append("shed traffic carried no positive retry-after")
    if admission.shed.get(flood, 0) == 0:
        breaches.append(
            f"flood tenant {flood} was never shed — tenant-aware "
            "admission did not engage"
        )
    latencies.sort()
    p99 = latencies[int(0.99 * (len(latencies) - 1))] if latencies else 0.0
    slo = cfg["slo"]
    if p99 > float(slo["submit_p99_s"]):
        breaches.append(
            f"submit p99 {p99 * 1e3:.1f}ms over SLO "
            f"{float(slo['submit_p99_s']) * 1e3:.0f}ms"
        )
    if max_lag_seen > int(slo["max_shard_lag_events"]):
        breaches.append(
            f"max shard lag {max_lag_seen} over SLO "
            f"{slo['max_shard_lag_events']}"
        )
    slo_block = None
    if tracker is not None:
        verdict = tracker.evaluate(now=t)
        breaches += [f"slo: {b}" for b in verdict["breaches"]]
        slo_block = {
            "ok": verdict["ok"],
            "breaches": verdict["breaches"],
            "slos": [
                {k: s[k] for k in ("name", "observed", "good", "bad",
                                   "compliance")}
                for s in verdict["slos"]
            ],
            "observations": tracker.observations(),
        }
    doc = {
        "seed": seed,
        "acked": len(acked),
        "shed": shed,
        "expired": expired,
        "flood_tenant": flood,
        "flood_shed": admission.shed.get(flood, 0),
        "submit_p99_ms": round(p99 * 1e3, 3),
        "max_shard_lag": max_lag_seen,
        "duplicates": len(duplicates),
        "lost": len(lost),
        "faults_fired": plan.fired(),
        "shard_restarts": sum(s.restarts for s in fd.shards),
        "dups_suppressed": sum(s.duplicates_suppressed for s in fd.shards),
        "wal_crashes": sum(
            getattr(s.wal, "crashes", 0) for s in fd.shards
        ),
        "makespan": round(t, 1),
        "breaches": breaches,
    }
    if slo_block is not None:
        doc["slo"] = slo_block
    fd.close()
    tmp.cleanup()
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="frontdoor-soak")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeded runs (seed = 0..N-1)")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--tenants", type=int, default=None)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--inject-loss", action="store_true",
                    help="drop one acked WAL entry (the gate MUST trip)")
    ap.add_argument("--slo", action="store_true",
                    help="attach a services/slo.SLOTracker to the submit "
                    "path: declared-SLO breaches (burn-rate semantics) "
                    "join the gate, and each seed doc carries the raw "
                    "observation stream for tools/slo_gate.py")
    ap.add_argument("--slo-threshold", type=float, default=None,
                    help="override the tracked submit-latency SLO "
                    "threshold in seconds (with --slo; a deliberately "
                    "tiny value proves the gate trips)")
    ap.add_argument("--backend", default="kernel",
                    choices=["oracle", "kernel"])
    ap.add_argument("--device", default=None,
                    help="device of the kernel backend's solves (default: "
                    "the CUDA card; `cpu` for a run without one)")
    ap.add_argument("--out", default=None,
                    help="write a bench-style artifact with the "
                         "extra.frontdoor block (tools/bench_trend.py)")
    args = ap.parse_args(argv)
    cfg = dict(DEFAULTS)
    for key in ("jobs", "tenants", "shards"):
        value = getattr(args, key)
        if value is not None:
            cfg[key] = value

    slos = None
    if args.slo:
        if args.slo_threshold is not None:
            from armada_tpu_torch.core.config import SLOSpec

            slos = (
                SLOSpec(
                    name="frontdoor-p99",
                    signal="frontdoor_submit_seconds",
                    threshold_s=args.slo_threshold,
                    objective=0.99,
                ),
            )
        else:
            slos = True
    failures = 0
    docs = []
    for seed in range(args.seeds):
        doc = run_soak(seed, cfg, inject_loss=args.inject_loss, slos=slos,
                       backend=args.backend, device=args.device)
        docs.append(doc)
        if doc["breaches"]:
            failures += 1
        print(json.dumps(doc))
    worst_p99 = max((d["submit_p99_ms"] for d in docs), default=0.0)
    summary = {
        "seeds": args.seeds,
        "failures": failures,
        "submit_p99_ms": worst_p99,
        "max_shard_lag": max((d["max_shard_lag"] for d in docs), default=0),
        "shed": sum(d["shed"] for d in docs),
        "slo": cfg["slo"],
    }
    print(json.dumps(summary))
    if args.out:
        artifact = {
            "metric": "frontdoor_soak",
            "value": worst_p99 / 1e3,
            "extra": {
                "frontdoor": {
                    "p99_ms": worst_p99,
                    "max_lag": summary["max_shard_lag"],
                    "shed": summary["shed"],
                    "seeds": args.seeds,
                    "ok": failures == 0,
                }
            },
        }
        with open(args.out, "w") as f:
            json.dump(artifact, f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
