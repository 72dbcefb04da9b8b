"""Shadow solves over forked round state: plans, rollouts, the service.

A plan is produced by:

  1. forking the live round (`fork.py` — captured seam, jobdb fallback,
     or a recorded `.atrace` round for parity checks);
  2. applying the requested mutations to the fork (`mutations.py`);
  3. re-solving the mutated fork with the UNCHANGED production code
     path: a `ForkRollout` boots a REAL SchedulerService + FakeExecutors
     on a private virtual clock seeded with the fork's exact post-round
     state, and runs a bounded number of cycles under any solver spec
     (oracle / LOCAL / hotwindow[:W] / mesh "2x4");
  4. diffing the rollout's decisions against the live baseline into a
     structured `Plan`: displaced jobs and where they land, placements
     + ETA-in-rounds for injected gangs, per-queue/per-pool headroom,
     and (for drains) the predicted `DrainOutcome`.

Plans run on a bounded worker pool off the round thread; the pending
backlog is capped and excess requests fail fast with `WhatIfBusyError`
(RESOURCE_EXHAUSTED on the wire) — a planner burst must add zero
latency to live rounds, and a plan never changes what a live round
decides (the planner-isolation burst of tests/test_torch_whatif.py).

This is the port's copy of the JAX package's whatif/planner.py. A
rollout's SchedulerService and a parity solve run on the live
scheduler's device (`SchedulerService.device`): the CUDA card by
default, where LOCAL is the `local:cuda` rung (the hand-written fill
kernels) and hotwindow:W that rung with window W; the CPU where the
live service runs there. Where the JAX package runs a plan on a worker
thread (its round is one jitted call, which takes the interpreter lock
once), the port runs each plan's rollout in a worker process
(`worker.py`): the live solve's host loop hands the lock over at every
torch call, and a rollout on a thread beside it made a live cycle about
10x slower on an H100 host. The live process keeps the bounded
backlog, builds the fork and sends its post-round `ForkState` with the
mutations as their dicts (`PlanJob`), its job and node specs as keys
into what the process kept of its last plan (`worker.Shared`); the
process applies the mutations, runs the `ForkRollout` and diffs it into
the `Plan` (`rollout_plan`), and sends back the plan with the rollout's
leases and preemptions. `WhatIfService.plan_stats` records what each
plan cost the live process. A drain plan's `execute_drain` and parity
checks stay in the live process.
"""

from __future__ import annotations

import math
import os
import pickle
import threading
import time as _time
from collections import deque
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace

import numpy as np

from ..core.resources import parse_quantity
from ..events import EventSequence, InMemoryEventLog, JobRunLeased, JobRunPreempted, SubmitJob
from ..jobdb import JobState
from .fork import ForkCapture, ForkState, RoundFork, fork_from_scheduler, fork_from_trace
from .mutations import Mutation, mutations_from_dicts
from .worker import RolloutWorkers


class WhatIfBusyError(RuntimeError):
    """The planner's bounded queue is full: backpressure, not latency.
    Mapped to RESOURCE_EXHAUSTED on both gRPC wires."""


def resolve_rollout_solver(spec, backend: str, config):
    """(backend, mesh, config) for one solver spec string. `spec=None`
    inherits the forked scheduler's own backend, unsharded. LOCAL and
    hotwindow:W are the kernel backend, whose first rung is the config's
    kernel path (`local:cuda`); hotwindow:W sets its window to W."""
    if spec in (None, "", "auto"):
        return ("oracle" if backend == "oracle" else "kernel"), None, config
    s = str(spec)
    if s.lower() == "oracle":
        return "oracle", None, config
    if s.upper() == "LOCAL":
        return "kernel", None, config
    if s.lower().startswith("hotwindow"):
        window = (
            int(s.split(":", 1)[1])
            if ":" in s
            else int(getattr(config, "hot_window_slots", 0)) or 4096
        )
        return (
            "kernel",
            None,
            dc_replace(config, hot_window_slots=window, hot_window_min_slots=0),
        )
    # Anything else is a mesh spelling ("8", "2x4", a tuple).
    return "kernel", s, config


@dataclass
class Plan:
    """Structured what-if outcome; every field JSON-able via to_dict."""

    kind: str  # "whatif" | "drain"
    pool: str
    solver: str
    rounds_simulated: int
    cycle_interval: float
    mutations: list = field(default_factory=list)  # mutation dicts
    baseline: dict = field(default_factory=dict)
    displaced: list = field(default_factory=list)
    injected: list = field(default_factory=list)
    headroom: dict = field(default_factory=dict)
    drain: dict | None = None
    # Fairness delta (observe/fairness.py): per-queue
    # delivered-share/regret movement between the live round's ledger
    # and the rollout's settled ledger — which queues PAY for the plan
    # (drain/inject) and which gain.
    fairness_delta: dict = field(default_factory=dict)
    plan_seconds: float = 0.0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "pool": self.pool,
            "solver": self.solver,
            "rounds_simulated": self.rounds_simulated,
            "cycle_interval": self.cycle_interval,
            "mutations": list(self.mutations),
            "baseline": dict(self.baseline),
            "displaced": list(self.displaced),
            "injected": list(self.injected),
            "headroom": dict(self.headroom),
            "drain": dict(self.drain) if self.drain is not None else None,
            "fairness_delta": dict(self.fairness_delta),
            "plan_seconds": self.plan_seconds,
        }

    def render(self) -> str:
        lines = [
            f"what-if plan ({self.kind}) · pool {self.pool} · solver "
            f"{self.solver} · {self.rounds_simulated} rounds simulated",
            f"baseline: {self.baseline.get('running', 0)} running, "
            f"{self.baseline.get('queued', 0)} queued on "
            f"{self.baseline.get('nodes', 0)} nodes",
        ]
        if self.drain is not None:
            d = self.drain
            rounds = d.get("rounds_to_drain")
            lines.append(
                f"drain {d.get('executor')}: "
                f"{len(d.get('completed', []))} complete voluntarily, "
                f"{len(d.get('preempted', []))} preempted, "
                f"{len(d.get('blocked', []))} blocked; "
                + (
                    f"drained in {rounds} rounds"
                    if rounds is not None
                    else "NOT drained within the horizon"
                )
            )
        for item in self.displaced:
            landed = item.get("landed_node")
            lines.append(
                f"  displaced {item['job_id']} ({item['from_node']}) -> "
                + (
                    f"{landed} at round {item.get('rounds_to_land')}"
                    if landed
                    else "no landing within the horizon"
                )
            )
        for g in self.injected:
            eta = g.get("eta_rounds")
            lines.append(
                f"  injected {g['name']} x{g['jobs']} (queue {g['queue']}): "
                + (
                    f"starts in {eta} round(s) on "
                    f"{len(g.get('nodes', []))} node(s)"
                    if eta is not None
                    else "does NOT start within the horizon"
                    + (f" — {g['reason']}" if g.get("reason") else "")
                )
            )
        pool_room = self.headroom.get("pool", {})
        if pool_room:
            free = ", ".join(
                f"{k}={v}" for k, v in sorted(pool_room.get("free", {}).items())
            )
            lines.append(f"headroom: {free}")
        delta_queues = self.fairness_delta.get("queues") or {}
        movers = sorted(
            (
                (name, d)
                for name, d in delta_queues.items()
                if abs(d.get("delta_delivered", 0.0)) > 1e-9
            ),
            key=lambda kv: kv[1].get("delta_delivered", 0.0),
        )
        if movers:
            lines.append("fairness delta (who pays):")
            for name, d in movers[:8]:
                lines.append(
                    f"  queue {name}: delivered "
                    f"{d.get('baseline_delivered', 0.0):.4f} -> "
                    f"{d.get('planned_delivered', 0.0):.4f} "
                    f"({d.get('delta_delivered', 0.0):+.4f})"
                )
        return "\n".join(lines)


class ForkRollout:
    """A real SchedulerService + FakeExecutors on a private virtual
    clock, seeded bit-for-bit from a ForkState. Multi-round rollouts
    drive the production cycle path (the sim.Simulator design), so the
    planner never models scheduling — it runs it."""

    def __init__(
        self,
        state: ForkState,
        *,
        solver=None,
        backend: str = "kernel",
        cycle_interval: float = 10.0,
        runtime_for=None,
        now: float = 0.0,
        device=None,
    ):
        from ..services.fake_executor import FakeExecutor
        from ..services.scheduler import SchedulerService

        self.state = state
        self.cycle_interval = float(cycle_interval)
        self.solver_label = str(solver) if solver not in (None, "") else (
            "oracle" if backend == "oracle" else "LOCAL"
        )
        backend, mesh, config = resolve_rollout_solver(solver, backend, state.config)
        self.log = InMemoryEventLog()
        # A far-future default keeps un-modeled jobs running for the whole
        # horizon: the planner is pessimistic about voluntary completion
        # unless the caller supplies remaining-runtime estimates.
        horizon = max(1e9, self.cycle_interval * 1e6)
        if isinstance(runtime_for, Mapping):
            runtime_for = _RemainingRuntimes(dict(runtime_for), horizon)
        self._runtime_for = runtime_for or (lambda job_id: horizon)
        self._seed(now)
        self.scheduler = SchedulerService(
            config, self.log, backend=backend, mesh=mesh,
            queues=list(state.queues), device=device,
        )
        self.scheduler.cordoned_queues.update(state.cordoned_queues)
        self.scheduler.cordoned_executors.update(state.cordoned_executors)
        by_executor: dict[str, list] = {}
        for node in state.nodes:
            by_executor.setdefault(state.executor_of(node), []).append(node)
        self.executors = [
            FakeExecutor(
                name,
                self.log,
                self.scheduler,
                nodes=nodes,
                pool=state.pool,
                runtime_for=self._runtime_for,
            )
            for name, nodes in sorted(by_executor.items())
        ]
        self.leases: dict[str, tuple] = {}  # job_id -> (cycle, node, executor)
        self.preempts: dict[str, tuple] = {}  # job_id -> (cycle, reason)
        self.cycles = 0
        self._drains = []
        for name, deadline_s in state.drain_executors:
            self._drains.append(
                self.scheduler.drains.start(name, deadline_s=deadline_s)
            )

    def _seed(self, now: float) -> None:
        """Publish the fork state into the rollout's private log: every
        job's real spec (gang identity included), running jobs leased at
        their forked placements. The rollout scheduler's first sync then
        materializes exactly the forked jobdb view."""
        state = self.state
        for i, r in enumerate(state.running):
            spec = r.job
            self.log.publish(
                EventSequence.of(
                    spec.queue,
                    spec.jobset or "whatif",
                    SubmitJob(created=min(spec.submitted_ts, now), job=spec),
                    JobRunLeased(
                        created=r.leased_ts or now,
                        job_id=spec.id,
                        run_id=f"fork-run-{i:06d}",
                        executor=state.node_executor.get(r.node_id, "")
                        or next(
                            (
                                n.executor
                                for n in state.nodes
                                if n.id == r.node_id
                            ),
                            "",
                        ),
                        node_id=r.node_id,
                        pool=state.pool,
                        scheduled_at_priority=r.scheduled_at_priority,
                    ),
                )
            )
        for spec in state.queued:
            self.log.publish(
                EventSequence.of(
                    spec.queue,
                    spec.jobset or "whatif",
                    SubmitJob(created=min(spec.submitted_ts, now), job=spec),
                )
            )

    def attach_drain(self, executor: str, deadline_s: float | None = None):
        ctl = self.scheduler.drains.start(executor, deadline_s=deadline_s)
        self._drains.append(ctl)
        return ctl

    @property
    def drains(self):
        return self._drains

    def run(self, rounds: int, stop_when=None) -> None:
        t = 0.0
        for cycle in range(1, int(rounds) + 1):
            for ex in self.executors:
                ex.tick(t)
            seqs = self.scheduler.cycle(now=t)
            self.cycles = cycle
            for seq in seqs:
                for event in seq.events:
                    if isinstance(event, JobRunLeased):
                        self.leases[event.job_id] = (
                            cycle,
                            event.node_id,
                            event.executor,
                        )
                    elif isinstance(event, JobRunPreempted):
                        self.preempts[event.job_id] = (cycle, event.reason)
            for ex in self.executors:
                ex.tick(t)
            if stop_when is not None and stop_when(self):
                break
            t += self.cycle_interval

    # -- final-state reads ---------------------------------------------

    def job_state(self, job_id: str):
        job = self.scheduler.jobdb.get(job_id)
        return job.state if job is not None else None

    def headroom(self) -> dict:
        """Free capacity after the rollout settles: pool totals minus
        live allocations, plus per-queue allocation/fair-share from the
        last round report."""
        totals: dict[str, float] = {}
        for node in self.state.nodes:
            if node.unschedulable:
                continue
            if self.scheduler.cordoned_executors and (
                self.state.executor_of(node)
                in self.scheduler.cordoned_executors
            ):
                continue
            for name, qty in node.total_resources.items():
                totals[name] = totals.get(name, 0) + float(parse_quantity(qty))
        allocated: dict[str, float] = {}
        by_queue: dict[str, dict] = {}
        txn = self.scheduler.jobdb.read_txn()
        for job in txn.leased_jobs():
            bucket = by_queue.setdefault(job.queue, {})
            for name, qty in job.spec.requests.items():
                q = float(parse_quantity(qty))
                allocated[name] = allocated.get(name, 0) + q
                bucket[name] = bucket.get(name, 0) + q
        queues = {
            name: {"allocated": dict(alloc)} for name, alloc in by_queue.items()
        }
        report = self.scheduler.reports.latest_reports().get(self.state.pool)
        if report is not None:
            for qname, qr in report.queues.items():
                queues.setdefault(qname, {})["fair_share"] = qr.fair_share
                queues[qname]["actual_share"] = qr.actual_share
        return {
            "pool": {
                "total": totals,
                "allocated": allocated,
                "free": {
                    k: totals.get(k, 0) - allocated.get(k, 0) for k in totals
                },
            },
            "queues": queues,
        }


@dataclass(frozen=True)
class _RemainingRuntimes:
    """A rollout's `runtime_for` given as a mapping: remaining seconds by
    job id, `default` (the horizon) for the jobs it does not name."""

    seconds: dict
    default: float

    def __call__(self, job_id: str) -> float:
        return self.seconds.get(job_id, self.default)


def _check_runtime_for(runtime_for) -> None:
    """A plan's `runtime_for` crosses to the rollout process: None, a
    mapping of job id to remaining seconds, or a picklable callable (a
    module-level function, as the JAX package's planner takes any
    callable). Anything else is refused here, in the caller, before the
    plan takes a backlog slot."""
    if runtime_for is None or isinstance(runtime_for, Mapping):
        return
    if not callable(runtime_for):
        raise TypeError(f"runtime_for must be a mapping or a callable, not {runtime_for!r}")
    try:
        pickle.dumps(runtime_for)
    except Exception as e:
        raise TypeError(
            "runtime_for cannot cross to the what-if rollout process: pass a "
            "mapping of job id to remaining seconds (or a picklable callable, "
            f"such as a module-level function) instead of {runtime_for!r} ({e})"
        ) from e


@dataclass
class PlanJob:
    """One plan's inputs as host data: what the live process sends to a
    rollout process. `state` is the fork's post-round state, before the
    mutations (`mutations`, as their dicts), its specs shared with the
    process (`_shared_state`); `live_fairness` the live round's fairness
    document for the pool, to diff the rollout's against."""

    state: ForkState
    mutations: list
    pool: str
    backend: str
    cycle: int | None
    live_fairness: dict | None
    solver: object
    rounds: int
    cycle_interval: float
    runtime_for: object
    kind: str
    device: object


def _running_jobs(jobs, node_ids, priorities, leased_ts, away) -> list:
    from ..core.types import RunningJob

    return [RunningJob(job=j, node_id=n, scheduled_at_priority=p, leased_ts=t, away=a)
            for j, n, p, t, a in zip(jobs, node_ids, priorities, leased_ts, away)]


class _SharedRunning:
    """A fork's running jobs as columns, their specs shared with the
    rollout process; loaded there as the list of RunningJob."""

    def __init__(self, running, share):
        self.args = (
            share([r.job for r in running]),
            [r.node_id for r in running],
            [r.scheduled_at_priority for r in running],
            [r.leased_ts for r in running],
            [r.away for r in running],
        )

    def __reduce__(self):
        return _running_jobs, self.args


def _shared_state(state: ForkState, share) -> ForkState:
    """`state` with its node, queued and running jobs' specs passed
    through `share` (worker.Worker.share): the rollout process loads the
    same state, and keeps those specs for the next plan."""
    return dc_replace(state, nodes=share(state.nodes), queued=share(state.queued),
                      running=_SharedRunning(state.running, share))


def rollout_plan(job: PlanJob) -> dict:
    """Apply the mutations to the fork, run its rollout and diff it into
    a `Plan`. Runs in a rollout process (worker.py); returns the plan's
    dict (`plan_seconds` this function's), the rollout's leases (job id
    to cycle, node and executor) and preemptions (job id to cycle and
    reason), the process's id and the hand-written kernels' launches of
    the rollout."""
    from ..ops import kernels

    before = dict(kernels.LAUNCHES)
    t0 = _time.monotonic()
    state = job.state
    baseline_running = {r.job.id: r.node_id for r in state.running}
    baseline = {
        "running": len(state.running),
        "queued": len(state.queued),
        "nodes": len(state.nodes),
        "cycle": job.cycle,
    }
    for m in mutations_from_dicts(job.mutations):
        m.apply(state)
    feasibility = _injection_feasibility(state)
    rounds = job.rounds
    if state.drain_executors:
        # The horizon must COVER every drain's deadline (else the
        # dry-run predicts "nothing happens" about a deadline it
        # never reached), plus the requested rounds for requeue
        # landings. Bounded: the early-stop predicate ends the
        # rollout as soon as the drain completes and everything
        # displaced has landed.
        default_deadline = float(getattr(state.config, "drain_deadline_s", 0.0))
        worst = max(
            default_deadline if dl is None else float(dl)
            for _, dl in state.drain_executors
        )
        rounds += min(int(math.ceil(worst / job.cycle_interval)) + 1, 1000)
    rollout = ForkRollout(
        state,
        solver=job.solver,
        backend=job.backend,
        cycle_interval=job.cycle_interval,
        runtime_for=job.runtime_for,
        device=job.device,
    )

    injected = set(state.injected_job_ids)

    def goals_met(r: ForkRollout) -> bool:
        if any(d.state != "done" for d in r.drains):
            return False
        if injected and not all(j in r.leases for j in injected):
            return False
        displaced_pending = [
            jid
            for jid in r.preempts
            if jid in baseline_running and jid not in r.leases
        ]
        return not displaced_pending

    rollout.run(rounds, stop_when=goals_met)

    displaced = []
    surviving_nodes = {n.id for n in state.nodes}
    for jid, from_node in sorted(baseline_running.items()):
        pre = rollout.preempts.get(jid)
        lease = rollout.leases.get(jid)
        moved = pre is not None or (
            lease is not None and lease[1] != from_node
        )
        if not moved and from_node in surviving_nodes:
            continue
        displaced.append(
            {
                "job_id": jid,
                "from_node": from_node,
                "reason": pre[1] if pre else "node removed from fork",
                "landed_node": lease[1] if lease else None,
                "rounds_to_land": lease[0] if lease else None,
            }
        )
    injected_out = _injected_outcomes(state, rollout, feasibility)
    drain_doc = None
    if rollout.drains:
        # One drain per plan today; report the first controller.
        drain_doc = rollout.drains[0].outcome().to_dict()
    plan = Plan(
        kind=job.kind,
        pool=job.pool,
        solver=rollout.solver_label,
        rounds_simulated=rollout.cycles,
        cycle_interval=rollout.cycle_interval,
        mutations=list(job.mutations),
        baseline=baseline,
        displaced=displaced,
        injected=injected_out,
        headroom=rollout.headroom(),
        drain=drain_doc,
        fairness_delta=_fairness_delta(job.live_fairness, job.pool, rollout),
        plan_seconds=round(_time.monotonic() - t0, 4),
    )
    launches = {k: n - before.get(k, 0) for k, n in kernels.LAUNCHES.items()}
    return {"plan": plan.to_dict(), "leases": rollout.leases, "preempts": rollout.preempts,
            "pid": os.getpid(), "launches": launches}


def _fairness_delta(base_doc, pool: str, rollout: ForkRollout) -> dict:
    """Which queues pay: the live round's fairness ledger (the
    scheduler's tracker) vs the rollout's settled ledger (the
    rollout scheduler runs the same fairness observatory). Either
    side missing (no round yet / idle rollout) reports {}."""
    roll_tracker = getattr(rollout.scheduler, "fairness", None)
    plan_doc = roll_tracker.latest(pool) if roll_tracker else None
    if not base_doc or not plan_doc:
        return {}

    def rows(doc):
        return {
            str(r["queue"]): r
            for r in (doc.get("ledger") or {}).get("queues", ())
        }

    base_rows, plan_rows = rows(base_doc), rows(plan_doc)
    queues = {}
    for name in sorted(base_rows.keys() | plan_rows.keys()):
        b = base_rows.get(name, {})
        p = plan_rows.get(name, {})
        b_del = float(b.get("delivered_share", 0.0))
        p_del = float(p.get("delivered_share", 0.0))
        queues[name] = {
            "baseline_delivered": b_del,
            "planned_delivered": p_del,
            "delta_delivered": p_del - b_del,
            "baseline_regret": float(b.get("regret", 0.0)),
            "planned_regret": float(p.get("regret", 0.0)),
        }
    payers = sorted(
        (n for n, d in queues.items() if d["delta_delivered"] < -1e-9),
        key=lambda n: queues[n]["delta_delivered"],
    )
    return {
        "baseline_jain": float(
            (base_doc.get("ledger") or {}).get("jain", 1.0)
        ),
        "planned_jain": float(
            (plan_doc.get("ledger") or {}).get("jain", 1.0)
        ),
        "queues": queues,
        "payers": payers,
    }


def _injection_feasibility(state: ForkState) -> dict:
    """Static could-this-EVER-fit verdicts for injected jobs, through
    the SAME snapshot-build helper the SubmitChecker uses
    (services/submit_check.static_check) — checker and planner
    feasibility semantics cannot drift."""
    if not state.injected_job_ids:
        return {}
    from ..services.submit_check import static_check

    by_jobset: dict[str, list] = {}
    for spec in state.queued:
        if spec.id in set(state.injected_job_ids):
            by_jobset.setdefault(spec.jobset, []).append(spec)
    by_executor: dict[str, list] = {}
    for node in state.nodes:
        ex = state.executor_of(node)
        if ex in state.cordoned_executors:
            continue
        by_executor.setdefault(ex, []).append(node)
    verdicts = {}
    for jobset, jobs in by_jobset.items():
        reasons = []
        ok = False
        for name, nodes in sorted(by_executor.items()):
            result = static_check(state.config, state.pool, nodes, jobs)
            if result.schedulable:
                ok = True
                break
            reasons.append(f"{name}: {result.reason}")
        verdicts[jobset] = (ok, "" if ok else "; ".join(reasons))
    return verdicts


def _injected_outcomes(state: ForkState, rollout: ForkRollout, feasibility: dict) -> list:
    out = []
    # Group injected jobs by their synthetic jobset (one per
    # inject_gang mutation).
    by_set: dict[str, list] = {}
    for spec in state.queued:
        if spec.id in set(state.injected_job_ids):
            by_set.setdefault(spec.jobset, []).append(spec)
    for jobset, specs in sorted(by_set.items()):
        ids = [s.id for s in specs]
        leases = [rollout.leases.get(j) for j in ids]
        placed = all(le is not None for le in leases)
        eta = max(le[0] for le in leases) if placed else None
        nodes = sorted({le[1] for le in leases if le is not None})
        feasible, reason = feasibility.get(jobset, (True, ""))
        if placed:
            reason = ""
        elif not feasible:
            reason = f"never schedulable: {reason}"
        else:
            reason = _unplaced_reason(rollout, ids) or (
                "no capacity within the horizon"
            )
        gang = specs[0].gang
        out.append(
            {
                "name": gang.id if gang is not None else jobset,
                "queue": specs[0].queue,
                "jobs": len(specs),
                "gang_cardinality": gang.cardinality if gang else 0,
                "eta_rounds": eta,
                "nodes": nodes,
                "feasible": bool(feasible),
                "reason": reason,
            }
        )
    return out


def _unplaced_reason(rollout: ForkRollout, ids: list) -> str:
    report = rollout.scheduler.reports.latest_reports().get(
        rollout.state.pool
    )
    if report is None:
        return ""
    for jid in ids:
        reason = report.job_reasons.get(jid)
        if reason:
            return reason
    return ""


class WhatIfService:
    """The what-if planner's service face: bounded worker pool, plan
    history, drain start/status pass-through, parity checks. Rollouts
    run in worker processes (`worker.py`), one per worker, started at
    the first plan; `close()` stops them."""

    def __init__(
        self,
        scheduler,
        *,
        metrics=None,
        workers: int | None = None,
        queue_depth: int | None = None,
        default_rounds: int | None = None,
        cycle_interval: float = 10.0,
        keep_recent: int = 32,
    ):
        cfg = scheduler.config
        self.scheduler = scheduler
        # Rollout cycles model the LIVE cycle cadence: rounds-to-drain
        # and ETA-in-rounds are honest only when the shadow clock ticks
        # like the real one (server.py passes its cycle_period).
        self.cycle_interval = float(cycle_interval)
        self.metrics = metrics if metrics is not None else scheduler.metrics
        self.default_rounds = int(
            default_rounds
            if default_rounds is not None
            else getattr(cfg, "whatif_default_rounds", 8)
        )
        self.queue_depth = int(
            queue_depth
            if queue_depth is not None
            else getattr(cfg, "whatif_queue_depth", 8)
        )
        n_workers = max(
            1, int(workers if workers is not None else getattr(cfg, "whatif_workers", 1))
        )
        self._pool = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="whatif"
        )
        self.rollouts = RolloutWorkers()
        self._pending = 0
        self._lock = threading.Lock()
        self.capture = ForkCapture()
        scheduler.attach_fork_capture(self.capture)
        self.recent: deque = deque(maxlen=keep_recent)
        # Per plan, what it cost the live process, in seconds: building
        # the fork (`fork_s`), its post-round state (`prep_s`), the job
        # with its specs shared (`share_s`), pickling it (`send_s`),
        # reading the plan back (`recv_s`), and their sum (`live_s`);
        # the plan's wall time (`plan_s`), its fork's jobs and the specs
        # pickled for it (`sent`), the rollout process, the kernel
        # launches of its rollout there, and the rollout's leases and
        # preemptions (`leases`, `preempts`: see rollout_plan).
        self.plan_stats: deque = deque(maxlen=keep_recent)

    def close(self) -> None:
        """Stop the rollout processes and the worker threads."""
        self.rollouts.close()
        self._pool.shutdown(wait=True)

    # -- bounded submission --------------------------------------------

    def _metric_ok(self) -> bool:
        return (
            self.metrics is not None
            and getattr(self.metrics, "registry", None) is not None
        )

    def _gauge_depth(self) -> None:
        if self._metric_ok():
            self.metrics.whatif_queue_depth.set(self._pending)

    def _run_bounded(self, kind: str, fn):
        """Run `fn` on the worker pool with backlog backpressure: the
        CALLER's thread blocks on the result (it's an RPC handler), the
        round thread never runs planner code, and a full backlog fails
        fast instead of queueing unboundedly."""
        with self._lock:
            if self._pending >= self.queue_depth:
                raise WhatIfBusyError(
                    f"what-if planner backlog full ({self._pending} pending, "
                    f"cap {self.queue_depth}); retry later"
                )
            self._pending += 1
            self._gauge_depth()

        def timed():
            t0 = _time.monotonic()
            try:
                return fn()
            finally:
                elapsed = _time.monotonic() - t0
                with self._lock:
                    self._pending -= 1
                    self._gauge_depth()
                if self._metric_ok():
                    self.metrics.whatif_plans.labels(kind=kind).inc()
                    self.metrics.whatif_plan_seconds.labels(kind=kind).observe(
                        elapsed
                    )

        return self._pool.submit(timed).result()

    # -- forks ----------------------------------------------------------

    def ensure_fork(self, pool: str | None = None) -> RoundFork:
        fork = self.capture.latest(pool)
        # A capture is only current if it came from one of the last two
        # cycles: in incremental-snapshot mode the seam skips rounds
        # (the capture would otherwise serve an arbitrarily stale
        # rebuild round's state), so stale captures fall back to a
        # fresh jobdb fork exactly like a missing one.
        if fork is not None and fork.cycle is not None and (
            self.scheduler.cycle_count - fork.cycle <= 1
        ):
            return fork
        return fork_from_scheduler(self.scheduler, pool)

    # -- planning -------------------------------------------------------

    def plan(
        self,
        mutations: list[Mutation],
        *,
        pool: str | None = None,
        solver=None,
        rounds: int | None = None,
        runtime_for=None,
        cycle_interval: float | None = None,
        kind: str = "whatif",
    ) -> Plan:
        """The plan of `mutations` on a fork of the live round. Its
        rollout runs in a rollout process, so `runtime_for` (the
        remaining seconds of each job the rollout runs) is None, a
        mapping of job id to seconds, or a picklable callable."""
        _check_runtime_for(runtime_for)
        dicts = [m.to_dict() for m in mutations]

        # The fork build runs INSIDE the bounded worker too: before any
        # round is captured, fork_from_scheduler walks the whole jobdb —
        # a burst must be shed before that work, not after.
        def run():
            t0 = _time.perf_counter()
            fork = self.ensure_fork(pool)
            return self._plan_on_fork(
                fork,
                dicts,
                solver=solver,
                rounds=rounds,
                runtime_for=runtime_for,
                cycle_interval=cycle_interval,
                kind=kind,
                fork_s=_time.perf_counter() - t0,
            )

        return self._run_bounded(kind, run)

    def plan_drain(
        self,
        executor: str,
        *,
        pool: str | None = None,
        solver=None,
        rounds: int | None = None,
        deadline_s: float | None = None,
        runtime_for=None,
        cycle_interval: float | None = None,
    ) -> Plan:
        from .mutations import DrainExecutor

        return self.plan(
            [DrainExecutor(name=executor, deadline_s=deadline_s)],
            pool=pool,
            solver=solver,
            rounds=rounds,
            runtime_for=runtime_for,
            cycle_interval=cycle_interval,
            kind="drain",
        )

    def _plan_on_fork(
        self,
        fork: RoundFork,
        mutations: list,
        *,
        solver=None,
        rounds: int | None = None,
        runtime_for=None,
        cycle_interval: float | None = None,
        kind: str = "whatif",
        fork_s: float = 0.0,
    ) -> Plan:
        """Send the plan of `mutations` (their dicts) on `fork` to a
        rollout process and wait for it."""
        t0 = _time.perf_counter()
        tracker = getattr(self.scheduler, "fairness", None)
        state = fork.post_round_state()
        t1 = _time.perf_counter()
        with self.rollouts.worker() as w:
            job = PlanJob(
                state=_shared_state(state, w.share),
                mutations=list(mutations),
                pool=fork.pool,
                backend=fork.backend,
                cycle=fork.cycle,
                live_fairness=tracker.latest(fork.pool) if tracker is not None else None,
                solver=solver,
                rounds=int(rounds if rounds is not None else self.default_rounds),
                cycle_interval=float(
                    cycle_interval if cycle_interval is not None else self.cycle_interval
                ),
                runtime_for=runtime_for,
                kind=kind,
                device=self.scheduler.device,
            )
            sent = w.table.pending_fresh()
            t2 = _time.perf_counter()
            payload = w.dumps(rollout_plan, job)
            t3 = _time.perf_counter()
            del job
            out = w.call(payload)
        t4 = _time.perf_counter()
        plan = Plan(**out["plan"])
        plan.plan_seconds = round(t4 - t0, 4)
        self.recent.appendleft(plan.to_dict())
        t5 = _time.perf_counter()
        self.plan_stats.append({
            "kind": kind, "fork_s": fork_s, "prep_s": t1 - t0, "share_s": t2 - t1,
            "send_s": t3 - t2, "recv_s": t5 - t4, "live_s": fork_s + (t3 - t0) + (t5 - t4),
            "plan_s": plan.plan_seconds, "jobs": len(state.running) + len(state.queued),
            "sent": sent, "pid": out["pid"], "launches": out["launches"],
            "leases": out["leases"], "preempts": out["preempts"],
        })
        return plan

    # -- drain execution (live control plane) ---------------------------

    def execute_drain(
        self, executor: str, *, deadline_s: float | None = None
    ) -> dict:
        """Start (or poll) a REAL drain on the live scheduler: the
        coordinator steps it once per scheduling cycle through the
        event path. Idempotent; returns the current status."""
        ctl = self.scheduler.drains.start(
            executor, deadline_s=deadline_s, metrics=self.metrics
        )
        return ctl.status()

    def drain_status(self, executor: str | None = None):
        return self.scheduler.drains.status(executor)

    # -- parity ---------------------------------------------------------

    def parity(
        self,
        *,
        pool: str | None = None,
        solver="LOCAL",
        fork: RoundFork | None = None,
        trace_path: str | None = None,
        round_i: int = 0,
        allow_foreign: bool = False,
    ) -> dict:
        """Bit-exact check: re-solve an UNMUTATED fork under `solver`
        and compare against the live decision stream (the replayer's
        compare on trace forks). The planner's isolation proof: shadow
        solves reproduce the live kernel's decisions exactly."""
        if fork is None:
            if trace_path is not None:
                fork = fork_from_trace(
                    trace_path, round_i, allow_foreign=allow_foreign
                )
            else:
                fork = self.capture.latest(pool)
        if fork is None:
            raise KeyError(
                "no captured round to check parity against (no round has "
                "solved since the planner attached)"
            )
        return self._run_bounded(
            "parity",
            lambda: parity_check(fork, solver, device=self.scheduler.device),
        )


def parity_check(fork: RoundFork, solver="LOCAL", *, device=None) -> dict:
    """Solve the fork's exact DeviceRound under a solver spec on `device`
    (the CUDA card unless the caller asks for the CPU) and diff the
    decision stream against the recorded/live one."""
    from ..trace.replayer import compare_round, replay_solver

    label, solve = replay_solver(solver, fork.trace_header, device=device)
    dev = fork.device_round()
    t0 = _time.monotonic()
    out = solve(dev)
    solve_s = _time.monotonic() - t0
    if fork.trace_record is not None:
        divergences = compare_round(fork.trace_record, out)
    else:
        divergences = _compare_live(fork, out)
    return {
        "solver": label,
        "pool": fork.pool,
        "num_jobs": fork.num_jobs,
        "solve_s": round(solve_s, 4),
        "divergences": divergences,
        "ok": not divergences,
    }


def _compare_live(fork: RoundFork, out: dict) -> list:
    """compare_round's logic against a live captured result dict (the
    round fork's result arrays are already sliced to the unpadded
    prefix)."""
    recorded = fork.recorded_decisions() or {}
    J, Q = fork.num_jobs, fork.num_queues
    job_keys = (
        "assigned_node",
        "scheduled_priority",
        "scheduled_mask",
        "preempted_mask",
    )
    queue_keys = ("fair_share", "demand_capped_fair_share")
    divergences = []
    for key in job_keys + queue_keys:
        if key not in recorded or key not in out:
            continue
        n = J if key in job_keys else Q
        want = np.asarray(recorded[key])[:n]
        got = np.asarray(out[key])[:n]
        if not np.array_equal(want, got, equal_nan=True):
            where = [int(i) for i in np.flatnonzero(want != got)[:4]]
            divergences.append(
                {
                    "kind": "placement",
                    "key": key,
                    "detail": f"{key}[:{n}] differs at indices {where}",
                }
            )
    if fork.backend == "kernel" and "num_loops" in recorded and "num_loops" in out:
        want = int(np.asarray(recorded["num_loops"]))
        got = int(np.asarray(out["num_loops"]))
        if want != got:
            divergences.append(
                {
                    "kind": "loop_stream",
                    "key": "num_loops",
                    "detail": f"recorded {want} loops, replayed {got}",
                }
            )
    return divergences
