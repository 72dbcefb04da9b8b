"""Consistent, immutable forks of the scheduler's round state.

Three fork sources, one `RoundFork` surface:

  - `ForkCapture` — the flight-recorder seam in
    `services/scheduler.py._schedule_pool`: right after a round solves,
    the scheduler hands the capture REFERENCES to the round's already-
    built inputs (NodeSpec/QueueSpec/RunningJob/JobSpec lists, the
    RoundSnapshot, the solver result arrays). Everything referenced is
    either frozen or freshly built per round and never mutated again,
    so capturing costs a handful of dict/set copies on the round
    thread — no extra array builds (the hard isolation requirement).
    Incremental-snapshot rounds share mutable state across cycles and
    are NOT captured; the planner falls back to a jobdb fork.

  - `fork_from_scheduler` — builds the round inputs from the live jobdb
    through the scheduler's own `_build_pool_inputs` (thread-safe jobdb
    reads). Runs on the planner worker, never the round thread.

  - `fork_from_trace` — reconstructs a recorded round from a flight-
    recorder `.atrace` bundle (bit-exact padded DeviceRound + decision
    stream). Supports the replayer-style parity compare and device-
    level node mutations; JobSpec-level mutations need a live fork.

This is the port's copy of the JAX package's whatif/fork.py. A fork holds
host state only (specs, the snapshot, numpy decision arrays); the solves
that read it run on the planner's device (whatif/planner.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace


@dataclass
class ForkState:
    """The mutable working copy mutations edit and the rollout seeds.

    `running`/`queued` are the post-round state: the captured round's
    own decisions already applied (scheduled jobs bound, preempted jobs
    dropped), so a no-op mutation list re-solves to a fixed point."""

    pool: str
    config: object
    nodes: list = field(default_factory=list)
    queues: list = field(default_factory=list)
    running: list = field(default_factory=list)
    queued: list = field(default_factory=list)
    node_executor: dict = field(default_factory=dict)
    cordoned_queues: set = field(default_factory=set)
    cordoned_executors: set = field(default_factory=set)
    excluded_nodes: dict = field(default_factory=dict)
    # Mutation bookkeeping consumed by the planner's diff:
    injected_job_ids: list = field(default_factory=list)
    injected_gangs: list = field(default_factory=list)  # (gang_id, queue, card)
    drain_executors: list = field(default_factory=list)

    def executor_of(self, node) -> str:
        return (
            self.node_executor.get(node.id)
            or node.executor
            or "whatif-exec"
        )


@dataclass
class RoundFork:
    """One immutable fork. Fields not applicable to a source are None."""

    source: str  # "round" | "jobdb" | "trace"
    pool: str
    config: object = None
    cycle: int | None = None
    now: float | None = None
    backend: str = "kernel"
    # round/jobdb sources:
    snap: object = None  # RoundSnapshot (round source only)
    result: dict | None = None  # live solver output (round source only)
    inputs: tuple | None = None  # (nodes, queues, running, queued, excluded)
    node_executor: dict | None = None
    cordoned_queues: set = field(default_factory=set)
    cordoned_executors: set = field(default_factory=set)
    # trace source:
    trace_record: object = None  # trace.replayer.RoundRecord
    trace_header: dict | None = None

    # -- derived views --------------------------------------------------

    def device_round(self):
        """The padded DeviceRound the kernel solves — the recorded one
        for trace forks, re-prepped deterministically otherwise (prep is
        a pure function of the snapshot, so the result is bit-exact with
        what the live round solved)."""
        if self.trace_record is not None:
            return self.trace_record.device_round()
        if self.snap is None:
            raise ValueError(
                "fork has no snapshot: jobdb forks support planning only"
            )
        from ..solver.kernel_prep import pad_device_round, prep_device_round

        return pad_device_round(prep_device_round(self.snap))

    def recorded_decisions(self) -> dict | None:
        """The live decision stream to compare shadow solves against."""
        import numpy as np

        if self.trace_record is not None:
            return self.trace_record.decisions()
        if self.result is None:
            return None
        return {k: np.asarray(v) for k, v in self.result.items()
                if hasattr(v, "__len__") or isinstance(v, (int, float))}

    @property
    def num_jobs(self) -> int:
        if self.trace_record is not None:
            return self.trace_record.num_jobs
        return self.snap.num_jobs if self.snap is not None else 0

    @property
    def num_queues(self) -> int:
        if self.trace_record is not None:
            return self.trace_record.num_queues
        return self.snap.num_queues if self.snap is not None else 0

    def post_round_state(self) -> ForkState:
        """ForkState with this round's decisions applied (see ForkState).
        Requires JobSpec-level inputs (round/jobdb forks)."""
        if self.inputs is None:
            raise ValueError(
                f"{self.source} fork carries no JobSpec-level inputs; "
                "mutations/rollouts need a live (round or jobdb) fork"
            )
        import numpy as np

        from ..core.types import RunningJob

        nodes, queues, running, queued, excluded = self.inputs
        state = ForkState(
            pool=self.pool,
            config=self.config,
            nodes=list(nodes),
            queues=list(queues),
            node_executor=dict(self.node_executor or {}),
            cordoned_queues=set(self.cordoned_queues),
            cordoned_executors=set(self.cordoned_executors),
            excluded_nodes={k: list(v) for k, v in (excluded or {}).items()},
        )
        if self.result is None or self.snap is None:
            state.running = list(running)
            state.queued = list(queued)
            return state
        # Apply the captured round's own decisions so the fork is the
        # POST-round cluster: scheduled queued jobs become running at
        # their assigned nodes, preempted running jobs drop (terminal
        # under live round-preemption semantics).
        snap = self.snap
        scheduled = np.asarray(self.result["scheduled_mask"], bool)
        preempted = np.asarray(self.result["preempted_mask"], bool)
        assigned = np.asarray(self.result["assigned_node"])
        prio = np.asarray(self.result["scheduled_priority"])
        idx = {jid: j for j, jid in enumerate(snap.job_ids)}
        for r in running:
            j = idx.get(r.job.id)
            if j is not None and preempted[j]:
                continue
            state.running.append(r)
        for spec in queued:
            j = idx.get(spec.id)
            if j is not None and scheduled[j]:
                state.running.append(
                    RunningJob(
                        job=spec,
                        node_id=snap.node_ids[int(assigned[j])],
                        scheduled_at_priority=int(prio[j]),
                        leased_ts=float(self.now or 0.0),
                    )
                )
            else:
                state.queued.append(spec)
        return state


class ForkCapture:
    """Latest-round fork per pool, fed from the scheduler's round thread
    (references only — see module docstring) and read from the planner
    worker."""

    def __init__(self):
        self._latest: dict[str, RoundFork] = {}
        self._lock = threading.Lock()

    def capture(
        self,
        *,
        pool: str,
        cycle: int,
        now: float,
        config,
        snap,
        result,
        inputs,
        node_executor,
        cordoned_queues,
        cordoned_executors,
        backend: str,
    ) -> None:
        fork = RoundFork(
            source="round",
            pool=pool,
            config=config,
            cycle=cycle,
            now=now,
            backend=backend,
            snap=snap,
            result=result,
            inputs=inputs,
            node_executor=node_executor,
            cordoned_queues=cordoned_queues,
            cordoned_executors=cordoned_executors,
        )
        with self._lock:
            self._latest[pool] = fork

    def latest(self, pool: str | None = None) -> RoundFork | None:
        with self._lock:
            if pool is not None:
                return self._latest.get(pool)
            if len(self._latest) == 1:
                return next(iter(self._latest.values()))
            # Multiple pools: newest capture wins for pool-less asks.
            newest = None
            for fork in self._latest.values():
                if newest is None or (fork.cycle or 0) >= (newest.cycle or 0):
                    newest = fork
            return newest

    def pools(self) -> list[str]:
        with self._lock:
            return sorted(self._latest)


def fork_from_scheduler(scheduler, pool: str | None = None) -> RoundFork:
    """Fork the live jobdb state for one pool (planner-worker path: the
    jobdb is lock-protected, so this never races the round thread; it
    just costs a build the captured fork would have amortized)."""
    if pool is None:
        pools = {
            (n.pool or hb.pool)
            for hb in scheduler.executors.values()
            for n in hb.nodes
        }
        pool = sorted(pools)[0] if pools else (
            scheduler.config.pools[0].name if scheduler.config.pools
            else "default"
        )
    (
        nodes,
        queues,
        running,
        queued,
        node_executor,
        _txn,
        excluded_nodes,
    ) = scheduler._build_pool_inputs(pool)
    return RoundFork(
        source="jobdb",
        pool=pool,
        config=scheduler.config,
        cycle=scheduler.cycle_count,
        backend=scheduler.backend,
        inputs=(nodes, queues, running, queued, excluded_nodes),
        node_executor=dict(node_executor),
        cordoned_queues=set(scheduler.cordoned_queues),
        cordoned_executors=set(scheduler.cordoned_executors),
    )


def fork_from_trace(
    path: str, round_i: int = 0, *, allow_foreign: bool = False
) -> RoundFork:
    """Fork a recorded round from an `.atrace` bundle: the bit-exact
    padded DeviceRound + decision stream, for replayer-style parity
    checks (tier-1 smoke over tests/fixtures/sim_steady.atrace)."""
    from ..trace.replayer import check_target, load_trace

    trace = load_trace(path)
    check_target(trace.header, allow_foreign=allow_foreign)
    rounds = [r for r in trace.rounds if not r.truncated]
    if not rounds:
        raise ValueError(f"{path}: no untruncated rounds to fork")
    rec = rounds[min(round_i, len(rounds) - 1)]
    return RoundFork(
        source="trace",
        pool=rec.pool,
        backend=rec.backend,
        trace_record=rec,
        trace_header=trace.header,
    )


def cordon_node_in_fork(fork: RoundFork, node_id: str) -> RoundFork:
    """Device-level node cordon for trace forks: flips the node's
    unschedulable lane in the DeviceRound. (Live forks cordon through
    mutations.CordonNode on the NodeSpec list instead.)"""
    import dataclasses as _dc

    import numpy as np

    if fork.trace_record is None:
        raise ValueError("device-level cordon applies to trace forks only")
    dev = fork.device_round()
    ids = (fork.trace_record.raw.get("ids") or {}).get("nodes")
    if not ids or node_id not in ids:
        raise KeyError(f"node {node_id!r} not in the recorded id vocabulary")
    unsched = np.array(dev.node_unschedulable)
    unsched[ids.index(node_id)] = True
    mutated = _dc.replace(dev, node_unschedulable=unsched)
    out = replace(fork)
    out.device_round = lambda: mutated  # type: ignore[method-assign]
    return out
