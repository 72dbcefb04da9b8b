"""Discrete-event simulator: whole-fleet runs in virtual time.

The reference's simulator (internal/scheduler/simulator/
simulator.go:64,206) is both the correctness oracle and the benchmark
harness: it builds synthetic clusters and workloads from specs, pops events
off a virtual-time priority queue, and drives the *real* scheduling code
path; job runtimes come from shifted-exponential distributions. Same design
here: the Simulator owns the real SchedulerService + FakeExecutors on a
virtual clock, so simulated behavior is the production code path, not a
model of it.

Specs mirror the reference's YAML testdata
(simulator/testdata/{clusters,workloads}): ClusterSpec{pool, node groups},
WorkloadSpec{queues -> job templates with counts/sizes/arrival times}.

This is the port's copy of the JAX package's sim/simulator.py; its
kernel backend (the default) solves on `device` (the CUDA card unless
the caller asks for the CPU). The YAML front end (sim/cli.py) waits for the server and
CLI slice (ROADMAP A7.9).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from ..core.config import SchedulingConfig
from ..core.types import Gang, JobSpec, NodeSpec, QueueSpec
from ..events import InMemoryEventLog
from ..jobdb import JobState
from ..services.fake_executor import FakeExecutor
from ..services.scheduler import SchedulerService
from ..services.submit import SubmitService


@dataclass(frozen=True)
class NodeTemplate:
    count: int
    cpu: str = "32"
    memory: str = "1024Gi"
    gpu: str = "0"
    labels: dict = field(default_factory=dict)
    taints: tuple = ()


@dataclass(frozen=True)
class ClusterSpec:
    name: str
    pool: str = "default"
    node_templates: tuple = (NodeTemplate(count=100),)


@dataclass(frozen=True)
class ShiftedExponential:
    """Job runtime distribution: minimum + Exp(tailMean), as in
    simulator.proto's shifted-exponential runtimes."""

    minimum: float = 60.0
    tail_mean: float = 0.0

    def sample(self, rng) -> float:
        if self.tail_mean <= 0:
            return self.minimum
        return self.minimum + rng.exponential(self.tail_mean)


@dataclass(frozen=True)
class JobTemplate:
    id: str
    number: int
    cpu: str = "1"
    memory: str = "4Gi"
    gpu: str = "0"
    priority_class: str = ""
    queue_priority: int = 0
    runtime: ShiftedExponential = ShiftedExponential()
    submit_time: float = 0.0
    gang_cardinality: int = 0  # >0: submit in gangs of this size
    node_selector: dict = field(default_factory=dict)
    jobset: str = ""


@dataclass(frozen=True)
class QueueSpecSim:
    name: str
    priority_factor: float = 1.0
    job_templates: tuple = ()


@dataclass(frozen=True)
class WorkloadSpec:
    queues: tuple = ()


@dataclass
class SimResult:
    finished_jobs: int
    total_jobs: int
    makespan: float
    preemptions: int
    cycles: int
    events_by_job: dict
    placements: dict  # job_id -> node_id of final successful run


class Simulator:
    def __init__(
        self,
        cluster_specs: list[ClusterSpec],
        workload: WorkloadSpec,
        config: SchedulingConfig | None = None,
        *,
        backend: str = "kernel",
        # Sharded-solve mesh spec, forwarded to SchedulerService: an int
        # (1D shard count), an "HxC" string / (hosts, chips) tuple
        # (two-level hierarchy, parallel/multihost.py), or a DeviceMesh.
        # None = unsharded.
        mesh=None,
        snapshot_mode: str = "auto",
        seed: int = 0,
        cycle_interval: float = 10.0,
        max_time: float = 7 * 24 * 3600.0,
        fault_plan=None,
        # The device of every kernel-backend solve (SchedulerService's
        # `device`): the CUDA card unless the caller asks for the CPU.
        device=None,
        # The JAX package's options whose modules wait for a later slice;
        # each refuses anything but its default: data_dir (the
        # file-backed log, ROADMAP A7.9), trace_path and span_path (the
        # flight recorder and span export, A7.7), autotune and whatif
        # (A7.8), frontdoor and slo (A7.9).
        data_dir: str | None = None,
        trace_path: str | None = None,
        span_path: str | None = None,
        autotune=False,
        whatif=False,
        frontdoor=None,
        slo=None,
    ):
        for name, value, item in (
            ("data_dir", data_dir, "A7.9"),
            ("trace_path", trace_path, "A7.7"),
            ("span_path", span_path, "A7.7"),
            ("autotune", autotune, "A7.8"),
            ("whatif", whatif, "A7.8"),
            ("frontdoor", frontdoor, "A7.9"),
            ("slo", slo, "A7.9"),
        ):
            if value:
                raise NotImplementedError(
                    f"Simulator({name}=...) waits for ROADMAP {item}"
                )
        self.config = config or SchedulingConfig()
        self.rng = np.random.default_rng(seed)
        self.cycle_interval = cycle_interval
        self.max_time = max_time

        # Deterministic chaos (services/chaos.py): the plan runs on the
        # sim's VIRTUAL clock, so injected faults land at the same instants
        # every run of a seed.
        self.fault_plan = fault_plan
        self.chaos_clock = None
        # Fault window boundaries are interesting instants: stepping the
        # virtual clock onto each start/heal keeps partition semantics
        # crisp (a sever lands exactly mid-lease, a heal triggers
        # anti-entropy on its own tick) and deterministic per seed.
        self._fault_instants: tuple[float, ...] = ()
        if fault_plan is not None:
            instants = set()
            for f in fault_plan.faults:
                instants.add(f.start)
                if f.duration != float("inf"):
                    instants.add(f.start + f.duration)
            self._fault_instants = tuple(sorted(instants))
        is_leader = lambda: True  # noqa: E731
        if fault_plan is not None:
            from ..services.chaos import ChaosLeader, VirtualClock
            from ..services.leader import StandaloneLeader

            self.chaos_clock = VirtualClock()
            is_leader = ChaosLeader(
                StandaloneLeader(), fault_plan, clock=self.chaos_clock
            )
        self.log = InMemoryEventLog()
        self.scheduler = SchedulerService(
            self.config, self.log, backend=backend, mesh=mesh,
            snapshot_mode=snapshot_mode, is_leader=is_leader, device=device,
        )
        if fault_plan is not None:
            from ..services.chaos import SOLVER_FAULT_KINDS, SolverChaos

            if any(f.kind in SOLVER_FAULT_KINDS for f in fault_plan.faults):
                # Solver-fault seam: raise/hang faults fire before each
                # ladder rung's solve, poison faults corrupt its output
                # — the admission firewall + failover ladder must
                # contain every one (tools/chaos_soak.py asserts no
                # poisoned round ever commits).
                self.scheduler.attach_solver_chaos(
                    SolverChaos(fault_plan, clock=self.chaos_clock)
                )
        self.submit = SubmitService(
            self.config, self.log, scheduler=self.scheduler
        )

        self._runtimes: dict[str, float] = {}
        self.executors: list[FakeExecutor] = []
        for spec in cluster_specs:
            nodes = []
            for ti, tmpl in enumerate(spec.node_templates):
                for i in range(tmpl.count):
                    resources = {"cpu": tmpl.cpu, "memory": tmpl.memory}
                    if tmpl.gpu not in ("0", 0, ""):
                        resources["nvidia.com/gpu"] = tmpl.gpu
                    nodes.append(
                        NodeSpec(
                            id=f"{spec.name}-{ti}-{i:05d}",
                            name=f"{spec.name}-{ti}-{i:05d}",
                            executor=spec.name,
                            pool=spec.pool,
                            labels=dict(tmpl.labels),
                            taints=tuple(tmpl.taints),
                            total_resources=resources,
                        )
                    )
            self.executors.append(
                FakeExecutor(
                    spec.name,
                    self.log,
                    self.scheduler,
                    nodes=nodes,
                    pool=spec.pool,
                    runtime_for=lambda job_id: self._runtimes.get(job_id, 60.0),
                    fault_plan=fault_plan,
                )
            )

        # Build submission schedule.
        self._pending_submissions: list[tuple[float, str, str, list[JobSpec]]] = []
        self.total_jobs = 0
        gang_counter = itertools.count()
        for q in workload.queues:
            self.submit.create_queue(QueueSpec(q.name, q.priority_factor))
            for tmpl in q.job_templates:
                jobs = []
                gang = None
                for i in range(tmpl.number):
                    if tmpl.gang_cardinality > 0 and i % tmpl.gang_cardinality == 0:
                        gang = Gang(
                            id=f"gang-{next(gang_counter)}",
                            cardinality=tmpl.gang_cardinality,
                        )
                    requests = {"cpu": tmpl.cpu, "memory": tmpl.memory}
                    if tmpl.gpu not in ("0", 0, ""):
                        requests["nvidia.com/gpu"] = tmpl.gpu
                    job_id = f"{q.name}-{tmpl.id}-{i:06d}"
                    jobs.append(
                        JobSpec(
                            id=job_id,
                            queue=q.name,
                            jobset=tmpl.jobset or tmpl.id,
                            priority=tmpl.queue_priority,
                            priority_class=tmpl.priority_class,
                            requests=requests,
                            node_selector=dict(tmpl.node_selector),
                            gang=gang if tmpl.gang_cardinality > 0 else None,
                        )
                    )
                    self._runtimes[job_id] = tmpl.runtime.sample(self.rng)
                self.total_jobs += len(jobs)
                self._pending_submissions.append(
                    (tmpl.submit_time, q.name, tmpl.jobset or tmpl.id, jobs)
                )
        self._pending_submissions.sort(key=lambda x: x[0])

    def run(self) -> SimResult:
        t = 0.0
        cycles = 0
        preemptions = 0
        sub_idx = 0
        finished = 0

        while t <= self.max_time:
            if self.chaos_clock is not None:
                self.chaos_clock.now = t
            # Submit everything due by t.
            while (
                sub_idx < len(self._pending_submissions)
                and self._pending_submissions[sub_idx][0] <= t
            ):
                _, queue, jobset, jobs = self._pending_submissions[sub_idx]
                self.submit.submit(queue, jobset, jobs, now=t)
                sub_idx += 1

            for ex in self.executors:
                ex.tick(t)
            seqs = self.scheduler.cycle(now=t)
            for seq in seqs:
                for event in seq.events:
                    if type(event).__name__ == "JobRunPreempted":
                        preemptions += 1
            for ex in self.executors:
                ex.tick(t)
            cycles += 1

            txn = self.scheduler.jobdb.read_txn()
            states = [j.state for j in txn.all_jobs()]
            finished = sum(1 for s in states if s.terminal)
            all_submitted = sub_idx >= len(self._pending_submissions)
            if all_submitted and states and finished == len(states):
                break

            # Advance virtual time: next interesting instant. Only FUTURE
            # instants count — a hung/crashed executor (chaos) can hold
            # runs whose finish time already passed; pinning on those
            # would freeze the clock.
            nxt = t + self.cycle_interval
            for ex in self.executors:
                for run in ex.active.values():
                    if not run.running_reported:
                        started = run.started + ex.startup_delay
                        if started > t:
                            nxt = min(nxt, started)
                    if run.finishes_at > t:
                        nxt = min(nxt, run.finishes_at)
            if sub_idx < len(self._pending_submissions):
                due = self._pending_submissions[sub_idx][0]
                if due > t:
                    nxt = min(nxt, due)
            for instant in self._fault_instants:
                if instant > t:
                    nxt = min(nxt, instant)
                    break  # sorted: the first future boundary is nearest
            t = max(nxt, t + 1e-9)

        txn = self.scheduler.jobdb.read_txn()
        placements = {}
        events_by_job = {}
        for job in txn.all_jobs():
            events_by_job[job.id] = job.state
            run = job.latest_run
            if run is not None and job.state == JobState.SUCCEEDED:
                placements[job.id] = run.node_id
        return SimResult(
            finished_jobs=sum(
                1 for s in events_by_job.values() if s == JobState.SUCCEEDED
            ),
            total_jobs=self.total_jobs,
            makespan=t,
            preemptions=preemptions,
            cycles=cycles,
            events_by_job=events_by_job,
            placements=placements,
        )
