"""The system under test, driven as Armada's scheduler loop drives it.

One `Pool` holds the port's event log, its submit service, its scheduler
service on the card (kernel backend, "cuda" kernels, the incremental
snapshot and the resident round) and the fake executors that stand in
for the pool's clusters. `step(k)` is one schedule period at virtual
time k x the period: the period's submissions through the submit
service, the executors' ticks (heartbeats, lease pickup, completions),
then `SchedulerService.cycle`. Steps run back to back: a closed loop, so
a slower cycle schedules less often, as Armada's loop does.

Each step leaves a record: host seconds of its three parts, their
`time.time_ns` bounds (the profiler's clock, for naming idle gaps), the
cycle's `last_cycle_stats`, the event sequences it published, and the
log offsets around the ticks (read after the window for completions).
"""

from __future__ import annotations

import gc
import time

from .traffic import Traffic


def scheduling_config(config: dict):
    """The program's SchedulingConfig for a configuration file."""
    from armada_tpu_torch.core.config import RateLimits, SchedulingConfig
    from armada_tpu_torch.core.priorities import PriorityClass

    if config["fairness"] != "drf":
        raise ValueError(f"fairness {config['fairness']!r}: the reference follows drf only")
    return SchedulingConfig(
        priority_classes={
            name: PriorityClass(name, int(pc["priority"]), preemptible=bool(pc["preemptible"]))
            for name, pc in config["priority_classes"].items()
        },
        default_priority_class=config["default_priority_class"],
        protected_fraction_of_fair_share=float(config["protected_fraction_of_fair_share"]),
        max_queue_lookback=int(config["max_queue_lookback"]),
        rate_limits=RateLimits(
            maximum_scheduling_rate=float(config["maximum_scheduling_rate"]),
            maximum_scheduling_burst=int(config["maximum_scheduling_burst"]),
            maximum_per_queue_scheduling_rate=float(config["maximum_per_queue_scheduling_rate"]),
            maximum_per_queue_scheduling_burst=int(config["maximum_per_queue_scheduling_burst"]),
        ),
        max_scheduling_duration_s=float(config["max_scheduling_duration_s"]),
        enable_fast_fill=bool(config["enable_fast_fill"]),
        batch_fill_window=int(config["batch_fill_window"]),
        solve_kernel_path="cuda",
    )


def node_table(config: dict) -> list[tuple]:
    """[(node id, executor, cpu, memory)]: `executors` clusters sharing
    the pool's nodes equally."""
    n, e = int(config["nodes"]), int(config["executors"])
    res = config["node_resources"]
    return [
        (f"executor-{x}-node-{i:05d}", f"executor-{x}", res["cpu"], res["memory"])
        for x in range(e) for i in range(n // e)
    ]


class GcClock:
    """Seconds the interpreter's cyclic collector ran, and its full
    (generation 2) collections, since the clock was made."""

    def __init__(self):
        self.seconds, self.full, self._t = 0.0, 0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.full += int(info.get("generation") == 2)
            self._t = None

    def close(self):
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)


class Pool:
    def __init__(self, config: dict, mix: dict, seed: int, *, device=None):
        self.config, self.mix = config, mix
        self.traffic = Traffic(config, mix, seed)
        self.cfg = scheduling_config(config)
        self.device = device
        self.nodes = node_table(config)
        self.records: list[dict] = []
        self.sched = None
        self.gc = GcClock()

    def runtime_for(self, job_id: str) -> float:
        """A job's runtime in seconds, from its sequence number."""
        t = self.traffic
        seq = int(job_id.rsplit("-", 1)[1])
        k = 0 if seq < t.backlog else 1 + (seq - t.backlog) // t.per_period
        b = t.block(k)
        return float(b.runtime[seq - b.first]) * t.period

    def _submit(self, k: int, specs: dict) -> None:
        now = self.traffic.block(k).now
        for queue, jobs in specs.items():
            if jobs:
                self.submit.submit(queue, "portbench", jobs, now=now)

    def start(self) -> dict:
        """The event log with the queues and the backlog (cycle 0's
        submissions), then the scheduler service, whose first sync
        ingests them, then the executors. Returns seconds by part."""
        from armada_tpu_torch.core.types import NodeSpec, QueueSpec
        from armada_tpu_torch.events import InMemoryEventLog
        from armada_tpu_torch.services.fake_executor import FakeExecutor
        from armada_tpu_torch.services.scheduler import SchedulerService
        from armada_tpu_torch.services.submit import SubmitService

        self.log = InMemoryEventLog()
        self.submit = SubmitService(self.cfg, self.log)
        pf = float(self.config["queue_priority_factor"])
        for name in self.traffic.queues:
            self.submit.create_queue(QueueSpec(name, pf))
        t0 = time.perf_counter()
        specs = self.traffic.specs(self.traffic.block(0))
        t1 = time.perf_counter()
        self._submit(0, specs)
        t2 = time.perf_counter()
        self.sched = SchedulerService(self.cfg, self.log, backend="kernel", device=self.device)
        t3 = time.perf_counter()
        by_exec: dict[str, list] = {}
        for node_id, executor, cpu, mem in self.nodes:
            by_exec.setdefault(executor, []).append(NodeSpec(
                id=node_id, name=node_id, executor=executor, pool="default",
                total_resources={"cpu": cpu, "memory": mem},
            ))
        self.executors = [
            FakeExecutor(name, self.log, self.sched, nodes=nodes, runtime_for=self.runtime_for)
            for name, nodes in by_exec.items()
        ]
        return {"build_s": t1 - t0, "submit_s": t2 - t1, "ingest_s": t3 - t2}

    def step(self, k: int) -> dict:
        now = k * self.traffic.period
        specs = self.traffic.specs(self.traffic.block(k)) if k else {}  # made before the clock
        g0, f0 = self.gc.seconds, self.gc.full
        t0 = time.time_ns()
        p0 = time.perf_counter()
        self._submit(k, specs)
        p1 = time.perf_counter()
        t1 = time.time_ns()
        off0 = self.log.end_offset
        for ex in self.executors:
            ex.tick(now)
        off1 = self.log.end_offset
        p2 = time.perf_counter()
        t2 = time.time_ns()
        seqs = self.sched.cycle(now=now)
        p3 = time.perf_counter()
        t3 = time.time_ns()
        rec = {
            "k": k, "now": now,
            "submit_s": p1 - p0, "tick_s": p2 - p1, "cycle_s": p3 - p2,
            "ns": (t0, t1, t2, t3),
            "stats": dict(self.sched.last_cycle_stats),
            "sequences": seqs,
            "tick_offsets": (off0, off1),
            "gc_s": self.gc.seconds - g0,
            "gc_full": self.gc.full - f0,
        }
        self.records.append(rec)
        return rec

    def decode(self) -> list[dict]:
        """Each record's leases [(job, executor, node, priority)],
        preemptions, completions reported by its ticks and whether the
        round budget cut its round, for judge."""
        from armada_tpu_torch.events import JobRunLeased, JobRunPreempted, JobSucceeded

        out = []
        for rec in self.records:
            leases, preempted, succeeded = [], [], []
            for seq in rec["sequences"]:
                for e in seq.events:
                    if isinstance(e, JobRunLeased):
                        leases.append((e.job_id, e.executor, e.node_id, int(e.scheduled_at_priority)))
                    elif isinstance(e, JobRunPreempted):
                        preempted.append(e.job_id)
            off0, off1 = rec["tick_offsets"]
            for entry in self.log.read(off0, off1 - off0):
                succeeded += [e.job_id for e in entry.sequence.events if isinstance(e, JobSucceeded)]
            out.append({"leases": leases, "preempted": preempted, "succeeded": succeeded,
                        "truncated": bool(rec["stats"].get("truncated", False))})
        return out

    def close(self) -> None:
        """Drop the program's state (the service, its resident round and
        the executors); the records and the log stay."""
        self.sched = None
        self.executors = []
        self.gc.close()
