"""The bench's scheduling round on the port's types.

`build_inputs` is bench.py's `build_inputs` (the 1M x 50k flagship and
the 100k x 5k tracking round): N nodes of 32 cpu / 256Gi, 10 equal-weight
queues, queued jobs of 1/2/4/8 cpu drawn from a seed, plus running
preemptible jobs of 2 cpu in one hog queue so that eviction and fair
preemption run. By default it uses the scheduler's default fill
configuration (batch fill window 512, fast fill off); `fast_fill=True,
fill_window=2048` is bench.py's own configuration (its flagship and
burst rounds).

With `gang_every=k`, every k-th queued job opens a gang of 2, 4 or 8
identical members (same queue and request), as the JAX package's
mixed-fleet scenarios draw them (`parallel/scenarios.py`, `_gang_for`).
Gangs are placed member by member through the node selection chain, so a
round with gangs selects nodes where the bench's round only fills and
returns evicted jobs to their own nodes.

`WarmCycle` is bench.py's warm end-to-end cycle (`run_config`'s
`warm_cycle`), the round as the scheduler runs it at steady state: an
`IncrementalRound` takes last round's leases and fresh submits, a
`ResidentRound` delta-syncs the padded round into persistent device
buffers, `solve_round` solves it host-driven, and the round firewall checks
the decisions against the host mirror.

`submit_events` and `ServiceRun` drive the same round through the
control plane: the bench's queued jobs submitted through the submit
service into an event log, and a scheduler service fed that log, with
fake executors reporting the nodes, cycle after cycle.
"""

from __future__ import annotations

import time

import numpy as np

from .core.config import PriorityClass, SchedulingConfig
from .core.types import Gang, JobSpec, NodeSpec, QueueSpec, RunningJob

N_QUEUES = 10
N_RUNNING = 5000
# The decision arrays of a solve (every key but the host-driven run's
# `truncated` and `profile`).
_NOT_ARRAYS = ("truncated", "profile")


def scheduling_config(n_running=N_RUNNING, fast_fill=False, fill_window=512):
    """The round's SchedulingConfig; `fast_fill` and `fill_window` set the
    fill configuration (`enableFastFill`, `batchFillWindow`)."""
    return SchedulingConfig(
        priority_classes={
            "high": PriorityClass("high", 30000, preemptible=False),
            "low": PriorityClass("low", 1000, preemptible=True),
        },
        default_priority_class="low",
        protected_fraction_of_fair_share=0.5 if n_running else 1.0,
        enable_fast_fill=fast_fill,
        batch_fill_window=fill_window,
    )


def build_inputs(n_jobs, n_nodes, n_running=N_RUNNING, n_queues=N_QUEUES, gang_every=0,
                 fast_fill=False, fill_window=512):
    """(config, pool, nodes, queues, running, queued) for
    `build_round_snapshot`; the config is `scheduling_config`'s."""
    cfg = scheduling_config(n_running, fast_fill, fill_window)
    rng = np.random.default_rng(0)
    nodes = [
        NodeSpec(
            id=f"node-{i:05d}",
            pool="default",
            total_resources={"cpu": "32", "memory": "256Gi"},
        )
        for i in range(n_nodes)
    ]
    queues = [QueueSpec(f"queue-{i:02d}", 1.0) for i in range(n_queues)]
    cpus = rng.choice([1, 2, 4, 8], size=n_jobs)
    qidx = rng.integers(0, n_queues, size=n_jobs)
    gang, left, lead = None, 0, 0
    queued = []
    for i in range(n_jobs):
        if left == 0 and gang_every and i % gang_every == 0:
            card = int(rng.choice([2, 4, 8]))
            gang, left, lead = Gang(id=f"gang-{i:07d}", cardinality=card), card, i
        g = lead if left else i
        queued.append(JobSpec(
            id=f"job-{i:07d}",
            queue=f"queue-{qidx[g]:02d}",
            priority_class="low",
            requests={"cpu": str(int(cpus[g])), "memory": f"{int(cpus[g]) * 2}Gi"},
            submitted_ts=float(i),
            gang=gang if left else None,
        ))
        if left:
            left -= 1
    # Running jobs all in one hog queue: over its fair share, so evicted
    # and mostly rescheduled, driving eviction and fair preemption.
    running = [
        RunningJob(
            job=JobSpec(
                id=f"run-{i:07d}",
                queue="queue-00",
                priority_class="low",
                requests={"cpu": "2", "memory": "4Gi"},
                submitted_ts=float(-n_running + i),
            ),
            node_id=f"node-{i % n_nodes:05d}",
            scheduled_at_priority=1000,
        )
        for i in range(n_running)
    ]
    return cfg, "default", nodes, queues, running, queued


def refill(dev, cfg):
    """A prepared (padded) round of `build_inputs` under the fill options
    of `cfg` (`scheduling_config(..., fast_fill=..., fill_window=...)`), as
    a fresh prep would build it. While the window stays above 0 and the
    round stays off the market, the fill options set only the fields of
    `kernel_prep.fill_fields`; every slot array is the same."""
    import dataclasses

    from .solver.kernel_prep import fill_fields

    if dev.batch_window <= 0 or cfg.batch_fill_window <= 0:
        raise ValueError("refill: the window must stay above 0 (it shapes the slot arrays)")
    if dev.market_driven or cfg.market_driven:
        raise ValueError("refill: a market round has no fill window")
    return dataclasses.replace(dev, **fill_fields(cfg))


# The policy variants of a round (`policy_inputs`, `repolicy`): queue
# weights 1, 2, ..., Q in name order, so that the priority policy's
# leading key decides something, and for the deadline policy queue q's
# deadline at DEADLINE_T0_S + DEADLINE_STEP_S * q, every third queue
# with none (+inf).
POLICY_KINDS = ("proportional", "priority", "deadline")
DEADLINE_T0_S = 1_700_000_000.0
DEADLINE_STEP_S = 3600.0


def _policy_deadline(rank: int) -> float:
    return float("inf") if rank % 3 == 2 else DEADLINE_T0_S + DEADLINE_STEP_S * rank


def policy_inputs(inputs, kind):
    """`build_inputs`' tuple under fairness policy `kind`: the config's
    default policy set, queue q (in name order) at priority factor
    1/(q + 1), and under the deadline policy each of its queued jobs
    carrying its queue's deadline annotation."""
    import dataclasses

    from .solver.policy import DEADLINE_ANNOTATION

    cfg, pool, nodes, queues, running, queued = inputs
    rank = {name: r for r, name in enumerate(sorted(q.name for q in queues))}
    queues = [dataclasses.replace(q, priority_factor=1.0 / (rank[q.name] + 1)) for q in queues]
    if kind == "deadline":
        queued = [
            dataclasses.replace(j, annotations={
                **j.annotations, DEADLINE_ANNOTATION: repr(_policy_deadline(rank[j.queue]))})
            if rank[j.queue] % 3 != 2 else j
            for j in queued
        ]
    cfg = dataclasses.replace(cfg, fairness_policy_default=kind)
    return cfg, pool, nodes, queues, running, queued


def repolicy(dev, kind):
    """A prepared (padded) round under fairness policy `kind`, its queue
    weights and deadlines set as `policy_inputs` sets them. For a round
    of `build_inputs` this is what a fresh prep of `policy_inputs(inputs,
    kind)` builds (only the policy spec, the weights and the deadlines
    differ), without a second host prep of a 1M-job round."""
    import dataclasses

    from .solver.policy import spec_from_config

    real = dev.queue_weight > 0
    rank = dev.queue_name_rank
    weight = np.where(real, rank + 1.0, 0.0).astype(dev.queue_weight.dtype)
    deadline = np.full(rank.shape, np.inf)
    if kind == "deadline":
        deadline = np.where(real, [_policy_deadline(int(r)) for r in rank], np.inf)
    return dataclasses.replace(
        dev,
        fairness_policy=spec_from_config(SchedulingConfig(fairness_policy_default=kind), "default"),
        queue_weight=weight,
        queue_deadline=deadline.astype(np.float64),
    )


class WarmCycle:
    """bench.py's warm scheduling cycle on the port, over `build_inputs`'
    tuple (or any `IncrementalRound` inputs).

    `cold()` builds nothing new: it pays the reset upload and solves.
    Each `cycle()` then, as bench.py does:
    - binds last round's scheduled decisions (`IncrementalRound.bind`);
    - submits as many 2-cpu / 4Gi jobs of class "low", round-robin over
      the queues (`add_jobs`);
    - syncs the resident round (`ResidentRound.device_round`: the O(J)
      prep, the diff against the mirror and the delta upload);
    - solves it host-driven (`solve_round`) at hot window `window`
      (bench.py's 2 x the fill window) with `window_min_slots=0`,
      reading back the live rows only;
    - runs the round firewall on the host mirror.
    Runs on the card unless `device` says otherwise."""

    def __init__(self, inputs, *, device=None, window=None):
        from .snapshot.incremental import IncrementalRound
        from .snapshot.residency import ResidentRound

        self.inc = IncrementalRound(*inputs)
        self.resident = ResidentRound(device)
        self.device = self.resident.device
        self.queues = [q.name for q in inputs[3]]
        self.window = 2 * int(inputs[0].batch_fill_window) if window is None else int(window)
        self.next_id = 0
        self.out = None

    def solve(self, dev, host=None, rows=None):
        """One solve of `dev` as the cycle solves (the resident tree with
        its mirror, or a fresh host round)."""
        from .solver.kernel import solve_round

        return solve_round(dev, host=host, device=self.device, window=self.window,
                           window_min_slots=0, readback_rows=rows)

    def fresh_solve(self):
        """The current generation solved from a fresh upload of
        `pad_device_round(inc.device_round())`, as a round without
        residency would; for holding the resident solve to it. Returns
        (outputs, seconds of the host prep and pad, the snapshot being
        cached for the generation)."""
        from .solver.kernel_prep import pad_device_round

        rows = self.inc.snapshot().num_jobs
        t0 = time.perf_counter()
        dev = pad_device_round(self.inc.device_round())
        prep_s = time.perf_counter() - t0
        return self.solve(dev, rows=rows), prep_s

    def cold(self) -> dict:
        """The reset upload and the first solve: their seconds, `h2d_s`
        and `solve_s`, and the reset's `last_sync`."""
        from .solver.kernel import _sync

        t0 = time.perf_counter()
        dev = self.resident.device_round(self.inc)
        _sync(self.device)
        h2d_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.out = self.solve(dev, self.resident.host_round(), self.inc.snapshot().num_jobs)
        return {"h2d_s": h2d_s, "solve_s": time.perf_counter() - t0,
                "sync": dict(self.resident.last_sync)}

    def cycle(self) -> dict:
        """One warm cycle; returns its seconds by part (`cycle_s` is the
        delta, the sync and the solve; `snapshot_s`, the snapshot's
        assembly, is the first part of the sync's `h2d_s`; the firewall
        runs after, as in bench.py), loops, scheduled jobs, the solve's
        transfer ledger and the sync's `last_sync`."""
        from .observe.ledger import round_ledger
        from .solver.kernel import _sync
        from .solver.validate import validate_round

        inc, out = self.inc, self.out
        snap = inc.snapshot()
        J = snap.num_jobs
        sched = np.flatnonzero(np.asarray(out["scheduled_mask"])[:J])
        assigned = np.asarray(out["assigned_node"])[:J]
        prio = np.asarray(out["scheduled_priority"])[:J]
        leases = [(str(snap.job_ids[j]), snap.node_ids[int(assigned[j])], int(prio[j]), 1.0)
                  for j in sched]
        new_jobs = [
            JobSpec(
                id=f"cycle-{self.next_id + i:08d}",
                queue=self.queues[i % len(self.queues)],
                priority_class="low",
                requests={"cpu": "2", "memory": "4Gi"},
                submitted_ts=3e6 + self.next_id + i,
            )
            for i in range(len(leases))
        ]
        self.next_id += len(leases)
        t0 = time.perf_counter()
        inc.bind(leases)
        inc.add_jobs(new_jobs)
        delta_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        inc.snapshot()  # cached for the sync's prep: timed as its own part
        snapshot_s = time.perf_counter() - t0
        dev = self.resident.device_round(inc)
        _sync(self.device)
        h2d_s = time.perf_counter() - t0
        host = self.resident.host_round()
        t0 = time.perf_counter()
        with round_ledger() as led:
            out = self.solve(dev, host, J + len(new_jobs))
        solve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        violation = validate_round({k: v for k, v in out.items() if k not in _NOT_ARRAYS},
                                   dev=host)
        validate_s = time.perf_counter() - t0
        self.out = out
        return {
            "delta_s": delta_s,
            "h2d_s": h2d_s,
            "snapshot_s": snapshot_s,
            "solve_s": solve_s,
            "validate_s": validate_s,
            "cycle_s": delta_s + h2d_s + solve_s,
            "loops": int(out["num_loops"]),
            "scheduled_jobs": int(np.asarray(out["scheduled_mask"]).sum()),
            "leased": len(leases),
            "violation": None if violation is None else str(violation),
            "transfer": led.as_dict(),
            "sync": dict(self.resident.last_sync),
            "profile": {k: v for k, v in out.get("profile", {}).items() if k != "transfer"},
        }

    def fairness(self) -> dict:
        """The last solve's fairness ledger (observe/fairness.py) on the
        host mirror, as bench.py reports it: Jain index, max regret,
        preemptions attributed, policy."""
        from .observe.fairness import ledger_from_device_round

        snap = self.inc.snapshot()
        block = ledger_from_device_round(
            self.resident.host_round(),
            {k: v for k, v in self.out.items() if k not in _NOT_ARRAYS},
            snap.num_jobs, snap.num_queues,
        )
        return {
            "jain": block["ledger"]["jain"],
            "max_regret": block["ledger"]["max_regret"],
            "preemptions_attributed": len(block["preemptions"]),
            "policy": block["ledger"].get("policy", "drf"),
        }


def submit_events(n_jobs, n_queues=N_QUEUES, fast_fill=True, fill_window=2048):
    """(config, log entries, submit seconds): the queued jobs of
    `build_inputs(n_jobs, ...)` (no running jobs) and their queues,
    submitted through the port's SubmitService into a fresh event log,
    one submit per queue. The config is `scheduling_config`'s."""
    from .events import InMemoryEventLog
    from .services.submit import SubmitService

    cfg, _, _, queues, _, queued = build_inputs(
        n_jobs, 1, n_running=0, n_queues=n_queues, fast_fill=fast_fill, fill_window=fill_window)
    log = InMemoryEventLog()
    submit = SubmitService(cfg, log)
    for q in queues:
        submit.create_queue(q)
    by_queue: dict[str, list] = {}
    for job in queued:
        by_queue.setdefault(job.queue, []).append(job)
    t0 = time.perf_counter()
    for name, jobs in by_queue.items():
        submit.submit(name, "bench", jobs, now=0.0)
    submit_s = time.perf_counter() - t0
    return cfg, log.read(0, log.end_offset), submit_s


class ServiceRun:
    """A scheduler service (kernel backend, `snapshot_mode="auto"`) fed a
    copy of `entries`, on `device` (the card unless the caller asks for
    the CPU), with its solve kernel path set to `kernel_path`, and
    `n_executors` fake executors reporting `n_nodes` nodes of 32 cpu /
    256Gi between them, in one pool; jobs run for `runtime` seconds.
    `ingest_s` is the service's first sync of the log (the service is
    built over an empty log, then `entries` are published into it). `cycle()` ticks
    the executors, runs one scheduling cycle at the virtual time `now`
    and advances it by `interval`; it returns the cycle's leases (job,
    executor, node), preemptions, wall seconds and the service's
    `last_cycle_stats`."""

    def __init__(self, cfg, entries, n_nodes, *, kernel_path="cuda", device=None, n_executors=2,
                 runtime=3600.0, interval=10.0):
        import dataclasses

        from .events import InMemoryEventLog
        from .services.fake_executor import FakeExecutor, make_nodes
        from .services.scheduler import SchedulerService

        log = InMemoryEventLog()
        self.sched = SchedulerService(dataclasses.replace(cfg, solve_kernel_path=kernel_path), log,
                                      backend="kernel", device=device)
        log.publish_many(e.sequence for e in entries)
        t0 = time.perf_counter()
        self.sched.ingester.sync()
        self.ingest_s = time.perf_counter() - t0
        per = n_nodes // n_executors
        self.executors = [
            FakeExecutor(f"executor-{k}", log, self.sched,
                         nodes=make_nodes(f"executor-{k}", count=per, cpu="32", memory="256Gi"),
                         runtime_for=lambda job_id: runtime)
            for k in range(n_executors)
        ]
        self.now = 0.0
        self.interval = interval

    def cycle(self) -> dict:
        from .events import JobRunLeased, JobRunPreempted

        for ex in self.executors:
            ex.tick(self.now)
        t0 = time.perf_counter()
        seqs = self.sched.cycle(now=self.now)
        cycle_s = time.perf_counter() - t0
        self.now += self.interval
        events = [e for seq in seqs for e in seq.events]
        return {
            "leases": sorted((e.job_id, e.executor, e.node_id)
                             for e in events if isinstance(e, JobRunLeased)),
            "preempted": sorted(e.job_id for e in events if isinstance(e, JobRunPreempted)),
            "cycle_s": cycle_s,
            "stats": dict(self.sched.last_cycle_stats),
        }


def sim_workload():
    """(cluster specs, workload spec, config) of the JAX package's
    differential simulation (tests/test_sim_differential.py): ten nodes
    in two zones, a steady queue of long jobs, a bursty queue of gangs of
    8 and non-preemptible urgent jobs, and zone-pinned jobs, on a config
    with a preemptible default class and a protected fraction of 0.5."""
    from .sim.simulator import (
        ClusterSpec,
        JobTemplate,
        NodeTemplate,
        QueueSpecSim,
        ShiftedExponential,
        WorkloadSpec,
    )

    cfg = SchedulingConfig(
        priority_classes={
            "high": PriorityClass("high", 30000, preemptible=False),
            "low": PriorityClass("low", 1000, preemptible=True),
        },
        default_priority_class="low",
        protected_fraction_of_fair_share=0.5,
    )
    clusters = [ClusterSpec("c1", node_templates=(
        NodeTemplate(count=6, cpu="16", memory="64Gi", labels={"zone": "a"}),
        NodeTemplate(count=4, cpu="32", memory="128Gi", labels={"zone": "b"}),
    ))]
    spec = WorkloadSpec(queues=(
        QueueSpecSim("steady", job_templates=(
            JobTemplate(id="long", number=40, cpu="2", memory="4Gi",
                        runtime=ShiftedExponential(minimum=300.0)),
        )),
        QueueSpecSim("bursty", priority_factor=2.0, job_templates=(
            JobTemplate(id="gangs", number=24, cpu="4", memory="4Gi", gang_cardinality=8,
                        submit_time=50.0, runtime=ShiftedExponential(minimum=120.0)),
            JobTemplate(id="urgent", number=10, cpu="2", memory="2Gi", priority_class="high",
                        submit_time=100.0, runtime=ShiftedExponential(minimum=60.0)),
        )),
        QueueSpecSim("zoned", job_templates=(
            JobTemplate(id="pin", number=12, cpu="1", memory="1Gi", node_selector={"zone": "b"},
                        submit_time=30.0,
                        runtime=ShiftedExponential(minimum=90.0, tail_mean=30.0)),
        )),
    ))
    return clusters, spec, cfg


def sim_history(result) -> dict:
    """The fleet history a differential simulation compares: final
    states, placements of succeeded jobs, preemptions, finished jobs."""
    return {
        "states": {k: v.value for k, v in result.events_by_job.items()},
        "placements": result.placements,
        "preemptions": result.preemptions,
        "finished": result.finished_jobs,
    }
