"""The scheduler service: leader-gated cycle loop.

Mirrors the structure of the reference's Scheduler.Run/cycle
(internal/scheduler/scheduler.go:148,282):

  each cycle: sync jobDb from the event log -> expire stale executors ->
  per pool: snapshot (jobs x nodes -> tensors) -> solve -> derive events ->
  publish to the log.

The jobDb is updated via the ingester on the next sync (the log is the
source of truth; publishing then re-consuming gives the same idempotent
at-least-once recovery the reference gets from Pulsar + serials,
scheduler.go:257-281). The solve runs either on the port's torch kernel
(`backend="kernel"`, the default, on `device`: the CUDA card unless the
caller asks for the CPU) or the Python oracle (`backend="oracle"`).

This is the port's copy of the JAX package's services/scheduler.py.
What differs:
- the kernel backend is the default, so a default service solves on
  the card;
- the failover ladder's rungs are the port's (solver/failover.py):
  `local:cuda` runs the hand-written kernels, plain LOCAL and
  `hotwindow` the "lax" path. On the card the ladder ends on the
  configured kernel path, so a round that fails there is rejected and
  requeued, never re-solved on the plain path or the host; on the CPU
  the host oracle ends the ladder, as in the JAX package;
- the mesh rung waits for its solve with `torch.cuda.synchronize` where
  the reference calls `jax.block_until_ready`;
- the seams whose modules wait for a later slice refuse to engage with
  NotImplementedError naming their ROADMAP item: market pools and the
  optimiser (A7.4), the compile telemetry (A7.5, so a round's profile
  carries no compile delta), the flight recorder and its postmortem
  bundles (A7.7), autotune and the what-if planner (A7.8), metrics and
  the SLO tracker (A7.9); the code that only fed them is left out;
- `last_cycle_stats` also names each round's snapshot mode, resident
  sync, ladder rung, failover and seconds, and a kernel service refuses
  to start where its device is missing.

`from_reference_checkpoint` carries a JAX-package service's
`checkpoint_state()` into this one.
"""

from __future__ import annotations

import time as _time
from collections import deque
from dataclasses import dataclass

from ..core.config import SchedulingConfig
from ..core.types import NodeSpec, QueueSpec, RunningJob
from ..events import (
    EventSequence,
    JobErrors,
    JobRequeued,
    JobRunErrors,
    JobRunLeased,
    JobRunPreempted,
)
from ..events.model import new_id
from ..jobdb import JobDb, JobState
from ..jobdb.ingest import SchedulerIngester
from ..snapshot.round import build_round_snapshot


@dataclass
class ExecutorHeartbeat:
    """Executor-reported cluster state (the LeaseRequest node snapshot,
    pkg/executorapi/executorapi.proto)."""

    name: str
    pool: str
    nodes: list
    last_seen: float = 0.0


class SchedulerService:
    def __init__(
        self,
        config: SchedulingConfig,
        log,
        *,
        backend: str = "kernel",
        mesh=None,
        snapshot_mode: str = "auto",
        queues: list[QueueSpec] | None = None,
        is_leader=lambda: True,
        runner=None,
        bid_price_provider=None,
        checkpoint=None,
        device=None,
    ):
        if config.market_driven or bid_price_provider is not None:
            raise NotImplementedError(
                "market-driven pools and their post-round seams (pricer, "
                "idealised value, bid refresh) wait for ROADMAP A7.4"
            )
        if config.optimiser is not None and config.optimiser.enabled:
            raise NotImplementedError(
                "the fairness optimiser pass waits for ROADMAP A7.4"
            )
        self.config = config
        self.log = log
        # The device every kernel-backend solve, resident round and mesh
        # shard runs on: the CUDA card unless the caller asks for the CPU.
        # None keeps the defaults (one card; a card per mesh shard). A
        # kernel service refuses to start where its device is missing,
        # and its failover ladder on the card never leaves the card
        # (solver/failover.build_ladder).
        if backend == "kernel":
            from ..device import resolve_device

            resolve_device(device)
        self.device = device
        self.jobdb = JobDb()
        self.ingester = SchedulerIngester(
            log, self.jobdb, error_rules=config.error_categories,
            settings_handler=self._apply_settings_event,
            transition_observer=self._observe_transition,
        )
        self.backend = backend
        # Multi-chip: node axis sharded over a device mesh — the product
        # analogue of the reference's multi-cluster union scheduling
        # (scheduling_algo.go:135-147). `mesh` is a spec that
        # parallel.multihost.resolve_solver takes ("HxC", an int, a
        # DeviceMesh); placements are exactly those of the single-device
        # solve.
        self.mesh = mesh
        self._sharded_run = None
        # Snapshot strategy: "auto" uses incremental O(delta) cycles when
        # eligible (kernel backend, no market/away) and keeps the padded
        # round device-resident across warm cycles (snapshot/residency.py)
        # on single-device solves; "resident" is the same engagement
        # spelled explicitly; "incremental" keeps the O(delta) host state
        # but re-uploads every cycle (no device residency); "rebuild"
        # always rebuilds. A pool that cannot run incrementally this
        # cycle (exclude/pending-leases, structure change) demotes to
        # rebuild for THAT cycle only — the resident device state
        # survives and resyncs by delta on re-engagement.
        self.snapshot_mode = snapshot_mode
        self._inc_state: dict = {}
        self._cycle_incremental_ok = False
        # pool -> snapshot.residency.ResidentRound (device-resident
        # padded round + owned host mirror), kept outside _inc_state so
        # an incremental rebuild does not discard warm device buffers.
        self._resident: dict = {}
        self.queues: dict[str, QueueSpec] = {q.name: q for q in (queues or [])}
        self.priority_overrides: dict[str, float] = {}
        # Per-pool fairness-policy runtime overrides (solver/policy.py):
        # pool -> canonical policy string, layered over the config's
        # fairnessPolicy block. Event-sourced (FairnessPolicyChange) and
        # checkpointed, like priority overrides. The BASE pools mapping
        # is kept aside so clearing an override restores the file config.
        self.fairness_policy_overrides: dict[str, str] = {}
        self._base_policy_pools: dict[str, str] = dict(
            config.fairness_policy_pools
        )
        # (pool, policy) -> shadow A/B scorecard registered before a
        # flip; the set_fairness_policy divergence gate requires one
        # unless force=True.
        self._policy_shadow: dict[tuple, dict] = {}
        self.cordoned_queues: set[str] = set()
        self.cordoned_executors: set[str] = set()
        self.executors: dict[str, ExecutorHeartbeat] = {}
        # Lease fencing (split-brain safety, docs/architecture.md): a
        # monotonic token per executor, bumped (event-sourced via
        # ExecutorFenced) whenever _expire_stale_executors reassigns that
        # executor's runs. The gRPC layer rejects lease/report calls
        # carrying an older token with FAILED_PRECONDITION, so a healed
        # partition cannot resurrect zombie runs. `fence_breached` holds
        # executors fenced since their last anti-entropy sync — surfaced
        # as advisory health detail (health.FencedExecutorChecker).
        self.executor_fences: dict[str, int] = {}
        self.fence_breached: set[str] = set()
        self.is_leader = is_leader
        self.cycle_count = 0
        # Leadership-acquisition timestamp (same clock as cycle(now) —
        # virtual in the simulator): anchors the orphaned-lease grace
        # period below. Reset whenever leadership is (re)gained so a
        # re-elected leader with a cold heartbeat map re-runs the grace
        # instead of mass-expiring healthy executors' jobs.
        self.started_at: float | None = None
        self._last_token_id: str | None = None
        # Orphan sweeps run once after the grace expires and again for a
        # timeout window after any executor is dropped (covers a background
        # solve leasing onto an executor expired mid-cycle), instead of
        # scanning every leased job every cycle forever.
        self._orphan_sweep_done = False
        self._orphan_recheck_until = 0.0
        self.last_cycle_stats: dict = {}
        # Rate-limit token buckets persisted across cycles (the reference's
        # limiter carries over; MaximumSchedulingRate refills it). Keyed per
        # pool for the global bucket; per (pool, queue) for queue buckets.
        self._rate_tokens: dict[str, float] = {}
        self._queue_rate_tokens: dict[tuple, float] = {}
        self._rate_last_refill: dict[str, float] = {}
        from .reports import SchedulingReportsRepository

        self.reports = SchedulingReportsRepository()
        # Job-journey ledger (services/job_timeline.py): per-job state
        # transitions + per-round unschedulable reasons, bounded; the
        # backing store for `armadactl job-trace` / GET /api/jobtrace.
        from .job_timeline import JobTimelineStore

        self.timeline = JobTimelineStore()
        # In-process tracer (utils/tracing.py): cycle/round spans with
        # the solve profile as child spans. Defaults to the process-wide
        # tracer; attach_tracer swaps in another.
        from ..utils.tracing import TRACER

        self.tracer = TRACER
        # Fairness observatory (armada_tpu/observe/fairness.py): every
        # round's share ledger + preemption attribution feed this
        # tracker — per-queue starvation streaks with the multiwindow
        # alert, the scheduler_fairness_* metric families, and the
        # document behind GET /api/fairness / the FairnessReport RPC /
        # `armadactl fairness`. Always on: it is pure host bookkeeping
        # over arrays the round already computed.
        from ..observe.fairness import FairnessTracker

        self.fairness = FairnessTracker(config.fairness_starvation_rounds)
        # Staged executor drains (whatif/drain.py): cordon -> voluntary
        # completion -> deadline preempt-requeue, stepped once per cycle
        # through the same event path as every other transition.
        from ..whatif.drain import DrainCoordinator

        self.drains = DrainCoordinator(self)
        # Round-deadline guardrail (maxSchedulingDuration): wall-clock
        # deadline for the current cycle's rounds, armed per cycle in
        # _schedule_all_pools; pools share the budget in round order.
        self._round_deadline: float | None = None
        from .backpressure import RoundDeadlinePressure

        # Repeated truncation trips per-pool backpressure; surfaced via
        # the health multi-checker and submit-side shedding (server.py).
        self.round_pressure = RoundDeadlinePressure(
            config.truncated_rounds_backpressure
        )
        # Self-healing solve path (solver/validate.py admission firewall
        # + solver/failover.py backend ladder): every solve attempt's
        # output is validated against host-side invariants before
        # anything commits; a raising/hanging/rejected round retries
        # down the ladder within the same cycle. `solver_chaos` is the
        # seeded fault-injection seam (services/chaos.SolverChaos,
        # attach_solver_chaos); the deques + quarantine dir back the
        # doctor surfaces (`armadactl doctor`, GET /api/doctor).
        from ..solver.failover import FailoverLadder, build_ladder

        self.solver_chaos = None
        self.quarantine_dir = config.quarantine_dir or ""
        self.recent_rejections: deque = deque(maxlen=32)
        self.recent_failovers: deque = deque(maxlen=32)
        self._rungs = build_ladder(backend, mesh, config, device=device)
        self.failover = (
            FailoverLadder(
                self._rungs,
                failure_threshold=config.solver_failover_threshold,
                cooldown_rounds=config.solver_failover_cooldown_rounds,
            )
            if config.solver_failover
            else None
        )
        if checkpoint is not None:
            # Bounded restart (services/checkpoint.py): seed the jobdb and
            # event-sourced settings from the checkpoint, then the sync
            # below replays only the log suffix past its cursor.
            cursor, state = checkpoint
            self.jobdb.load(state["jobdb"])
            self.priority_overrides.update(state["priority_overrides"])
            # Older checkpoints predate policy overrides: absent means
            # every pool runs the file config's policy.
            self.fairness_policy_overrides.update(
                state.get("fairness_policy_overrides", {})
            )
            self._refresh_policy_config()
            self.cordoned_queues.update(state["cordoned_queues"])
            self.cordoned_executors.update(state["cordoned_executors"])
            # Older checkpoints predate fencing: absent means no fences.
            self.executor_fences.update(state.get("executor_fences", {}))
            self.fence_breached.update(state.get("fence_breached", ()))
            self.ingester.cursor = cursor
        self.ingester.sync()  # restore jobdb + event-sourced settings
        from ..utils.logging import get_logger

        self.log_ = get_logger("armada_tpu_torch.scheduler")
        from .runner import SyncRunner

        # Sync or async scheduling runner (runner/types.go seam).
        self.runner = runner if runner is not None else SyncRunner()

    def checkpoint_state(self):
        """(cursor, state) for CheckpointManager: the jobdb plus every
        event-sourced setting materialized by _apply_settings_event, all
        reflecting exactly the log prefix below the ingester cursor."""
        return self.ingester.cursor, {
            "jobdb": self.jobdb.dump(),
            "priority_overrides": dict(self.priority_overrides),
            "fairness_policy_overrides": dict(self.fairness_policy_overrides),
            "cordoned_queues": set(self.cordoned_queues),
            "cordoned_executors": set(self.cordoned_executors),
            "executor_fences": dict(self.executor_fences),
            "fence_breached": set(self.fence_breached),
        }

    def attach_metrics(self, metrics):
        raise NotImplementedError(
            "the scheduler metrics registry waits for ROADMAP A7.9"
        )

    def attach_tracer(self, tracer):
        """Replace the process-default tracer."""
        self.tracer = tracer

    def attach_trace_recorder(self, recorder):
        raise NotImplementedError("the flight recorder waits for ROADMAP A7.7")

    def attach_autotune(self, controller):
        raise NotImplementedError("autotune waits for ROADMAP A7.8")

    def attach_slo(self, tracker):
        raise NotImplementedError("the SLO tracker waits for ROADMAP A7.9")

    def attach_fork_capture(self, capture):
        raise NotImplementedError("the what-if planner waits for ROADMAP A7.8")

    def attach_whatif(self, service):
        raise NotImplementedError("the what-if planner waits for ROADMAP A7.8")

    def attach_solver_chaos(self, chaos):
        """Attach the solver-fault injection seam
        (services/chaos.SolverChaos): raise/hang faults fire before each
        rung's solve, poison faults corrupt its output — proving the
        admission firewall + failover ladder contain every kind."""
        self.solver_chaos = chaos

    def doctor_report(self) -> dict:
        """The self-healing-solve state the doctor surfaces render
        (`armadactl doctor`, GET /api/doctor, the Doctor RPC): ladder
        breaker states, recent firewall rejections with their postmortem
        bundle paths, and recent failovers."""
        ladder = (
            self.failover.snapshot(self.cycle_count)
            if self.failover is not None
            else [
                {
                    "rung": r.label,
                    "kind": r.kind,
                    "state": "disabled",
                    "state_code": -1,
                    "consecutive_failures": 0,
                    "terminal": i == len(self._rungs) - 1,
                }
                for i, r in enumerate(self._rungs)
            ]
        )
        return {
            "cycle": self.cycle_count,
            "validation_enabled": bool(self.config.solver_validate),
            "failover_enabled": self.failover is not None,
            "ladder": ladder,
            "rejections": list(self.recent_rejections),
            "failovers": list(self.recent_failovers),
            "quarantine_dir": self.quarantine_dir,
        }

    def _observe_transition(self, txn, event, sequence=None):
        """Feed the per-job journey ledger (services/job_timeline.py),
        called before each event applies — the sequence carries the
        publisher's trace context. (The JAX package also books its
        state-transition metrics here; they wait for ROADMAP A7.9.)"""
        self.timeline.observe_event(event, sequence)

    # ---- control-plane inputs ----

    def upsert_queue(self, queue: QueueSpec, cordoned: bool | None = None):
        self.queues[queue.name] = queue
        if cordoned is not None:
            if cordoned:
                self.cordoned_queues.add(queue.name)
            else:
                self.cordoned_queues.discard(queue.name)

    def set_priority_override(self, queue: str, priority_factor: float | None):
        """External priority override (internal/scheduler/priorityoverride):
        replaces the queue's priority factor for scheduling; None clears.
        Event-sourced: survives restarts via the durable log. No-op calls
        (clearing an absent override, re-setting the same value) publish
        nothing so idempotent retries keep the log bounded."""
        from ..events.model import CONTROL_PLANE_JOBSET, PriorityOverride

        if priority_factor is None:
            if queue not in self.priority_overrides:
                return
            self.priority_overrides.pop(queue)
            self.log.publish(EventSequence.of(
                "", CONTROL_PLANE_JOBSET,
                PriorityOverride(created=_time.time(), queue=queue, cleared=True),
            ))
            return
        import math

        pf = float(priority_factor)
        if not math.isfinite(pf) or pf <= 0:
            raise ValueError(
                f"priority factor must be finite and > 0, got {priority_factor!r}"
            )
        if self.priority_overrides.get(queue) == pf:
            return
        self.priority_overrides[queue] = pf
        self.log.publish(EventSequence.of(
            "", CONTROL_PLANE_JOBSET,
            PriorityOverride(created=_time.time(), queue=queue, priority_factor=pf),
        ))

    # ---- fairness policy control plane (solver/policy.py) ----

    def fairness_policy(self, pool: str) -> str:
        """The ACTIVE policy string for a pool: runtime override when
        set, else the file config's fairnessPolicy block."""
        from ..solver import policy as fp

        return fp.spec_to_str(fp.spec_from_config(self.config, pool))

    def note_policy_shadow(self, pool: str, policy: str, scorecard: dict):
        """Register a shadow A/B scorecard (tools/policy_ab.py or a
        what-if `policy=` plan) for a candidate flip — the evidence the
        set_fairness_policy divergence gate requires."""
        from ..solver import policy as fp

        spec = fp.normalize_spec(policy)
        self._policy_shadow[(pool, fp.spec_to_str(spec))] = dict(scorecard)

    def set_fairness_policy(
        self, pool: str, policy: str | None, *, force: bool = False
    ):
        """Flip a pool's fairness policy at runtime; None clears back to
        the file config. Event-sourced (FairnessPolicyChange) so the
        flip survives restarts and failovers; the next round solves
        under the new objective (the policy is a static field of the
        padded round, so the flip resets the pool's warm state).

        Divergence gate: a non-default policy is only adopted after a
        shadow scorecard for (pool, policy) was registered via
        note_policy_shadow (replay the pool's recorded rounds through
        tools/policy_ab.py, or run a what-if `policy=` plan), unless
        force=True."""
        from ..events.model import CONTROL_PLANE_JOBSET, FairnessPolicyChange
        from ..solver import policy as fp

        if policy is None:
            if pool not in self.fairness_policy_overrides:
                return
            self.fairness_policy_overrides.pop(pool)
            self._refresh_policy_config([pool])
            self.log.publish(EventSequence.of(
                "", CONTROL_PLANE_JOBSET,
                FairnessPolicyChange(
                    created=_time.time(), pool=pool, cleared=True
                ),
            ))
            return
        spec = fp.normalize_spec(policy)  # ValueError on unknown kinds
        policy_str = fp.spec_to_str(spec)
        if self.fairness_policy(pool) == policy_str:
            return
        if (
            fp.spec_kind(spec) != "drf"
            and not force
            and (pool, policy_str) not in self._policy_shadow
        ):
            raise ValueError(
                f"no shadow scorecard registered for pool {pool!r} under "
                f"{policy_str!r}: replay the pool's recorded rounds with "
                "tools/policy_ab.py (or a what-if policy= plan) and "
                "register it via note_policy_shadow, or pass force=True"
            )
        self.fairness_policy_overrides[pool] = policy_str
        self._refresh_policy_config([pool])
        self.log.publish(EventSequence.of(
            "", CONTROL_PLANE_JOBSET,
            FairnessPolicyChange(
                created=_time.time(), pool=pool, policy=policy_str
            ),
        ))

    def _refresh_policy_config(self, pools_changed=None):
        """Materialize base pools + runtime overrides into the config
        every snapshot/prep/oracle seam reads, and drop warm solver
        state for flipped pools: the policy is a static round field, so
        a resident DeviceRound or incremental snapshot built under the
        old objective must not serve another round."""
        import dataclasses as _dc

        pools = dict(self._base_policy_pools)
        pools.update(self.fairness_policy_overrides)
        if pools != self.config.fairness_policy_pools:
            self.config = _dc.replace(
                self.config, fairness_policy_pools=pools
            )
        for pool in pools_changed or ():
            self._inc_state.pop(pool, None)
            self._resident.pop(pool, None)

    def _effective_queue(self, name: str, overrides: dict | None = None) -> QueueSpec:
        overrides = overrides if overrides is not None else self.priority_overrides
        spec = self.queues.get(name, QueueSpec(name))
        override = overrides.get(name)
        if override is not None:
            spec = QueueSpec(name, override)
        return spec

    def report_executor(self, hb: ExecutorHeartbeat):
        self.executors[hb.name] = hb

    # ---- lease fencing (split-brain safety) ----

    def executor_fence(self, name: str) -> int:
        """Current fencing token for an executor (0 = never fenced)."""
        return self.executor_fences.get(name, 0)

    def note_executor_synced(self, name: str) -> None:
        """An anti-entropy ExecutorSync completed: the executor holds the
        current fence again; clear the advisory health breach.
        Event-sourced (ExecutorFenced with synced=True) so a restarted
        scheduler's log replay does not resurrect the breach alarm for
        executors that healed long ago. Idempotent: repeated syncs of an
        unbreached executor publish nothing."""
        if name not in self.fence_breached:
            return
        from ..events.model import CONTROL_PLANE_JOBSET, ExecutorFenced

        self.fence_breached.discard(name)
        self.log.publish(EventSequence.of(
            "",
            CONTROL_PLANE_JOBSET,
            ExecutorFenced(
                created=_time.time(),
                name=name,
                fence=self.executor_fence(name),
                synced=True,
            ),
        ))

    def set_executor_cordon(self, name: str, cordoned: bool):
        """Cordon a whole executor cluster: no new placements there
        (the reference's executor cordon via executor settings).
        Event-sourced: survives restarts via the durable log; no-op calls
        publish nothing so idempotent retries keep the log bounded."""
        from ..events.model import CONTROL_PLANE_JOBSET, ExecutorCordon

        if cordoned == (name in self.cordoned_executors):
            return
        if cordoned:
            self.cordoned_executors.add(name)
        else:
            self.cordoned_executors.discard(name)
        self.log.publish(EventSequence.of(
            "", CONTROL_PLANE_JOBSET,
            ExecutorCordon(created=_time.time(), name=name, cordoned=cordoned),
        ))

    def _apply_settings_event(self, event):
        """Materialize control-plane settings events (the reference's
        executor-settings and override tables from controlplaneevents).
        Runs inside ingester.sync(), so a standby's first post-failover
        cycle catches up settings on the same cursor as the jobdb."""
        from ..events.model import (
            ExecutorCordon,
            ExecutorFenced,
            FairnessPolicyChange,
            PriorityOverride,
        )

        if isinstance(event, ExecutorFenced):
            # Monotonic: replays and out-of-order application never lower
            # a fence (lowering would re-admit stale-fenced reports).
            current = self.executor_fences.get(event.name, 0)
            self.executor_fences[event.name] = max(current, event.fence)
            if event.synced:
                # ExecutorSync completed at this fence: clear the breach
                # unless a LATER fence bump already superseded the sync.
                if event.fence >= self.executor_fences[event.name]:
                    self.fence_breached.discard(event.name)
            else:
                self.fence_breached.add(event.name)
        elif isinstance(event, ExecutorCordon):
            if event.cordoned:
                self.cordoned_executors.add(event.name)
            else:
                self.cordoned_executors.discard(event.name)
        elif isinstance(event, PriorityOverride):
            if event.cleared:
                self.priority_overrides.pop(event.queue, None)
            else:
                self.priority_overrides[event.queue] = event.priority_factor
        elif isinstance(event, FairnessPolicyChange):
            if event.cleared:
                self.fairness_policy_overrides.pop(event.pool, None)
            else:
                self.fairness_policy_overrides[event.pool] = event.policy
            self._refresh_policy_config([event.pool])

    # ---- cycle ----

    def cycle(self, now: float | None = None) -> list[EventSequence]:
        """One scheduling cycle; returns the published event sequences.

        Leader-token protocol (leaderelection.go token model): the token is
        captured at cycle start and re-validated immediately before
        publishing. Losing leadership mid-cycle drops the publish; the new
        leader re-derives identical events idempotently
        (scheduler.go:225-233)."""
        token = None
        if hasattr(self.is_leader, "get_token"):
            token = self.is_leader.get_token()
            if not token.leader:
                self._last_token_id = None
                return []
        elif not self.is_leader():
            self._last_token_id = None
            return []
        now = _time.time() if now is None else now
        token_id = token.id if token is not None else ""
        if self._last_token_id != token_id:
            # Fresh (re-)election: restart the orphaned-lease grace period.
            self._last_token_id = token_id
            self.started_at = now
            self._orphan_sweep_done = False
        with self._span("scheduler.cycle", cycle=self.cycle_count):
            return self._cycle_body(now, token)

    def _span(self, name: str, **attrs):
        """A tracer span, or a no-op when tracing is detached."""
        if self.tracer is None:
            import contextlib

            return contextlib.nullcontext()
        return self.tracer.span(name, **attrs)

    def _cycle_body(self, now: float, token) -> list[EventSequence]:
        self.ingester.sync()
        sequences: list[EventSequence] = []
        sequences += self._expire_stale_executors(now)
        sequences += self._handle_failed_runs(now)
        sequences += self._reconcile_runs(now)
        # Staged executor drains (whatif/drain.py): cordon is published
        # by the controller itself; deadline preempt-requeues ride this
        # cycle's sequences (leader-gated with everything else) and
        # apply before the NEXT cycle's round, which then reschedules
        # the displaced jobs off the cordoned executor.
        sequences += self.drains.step(now)

        # Scheduling through the runner seam: sync solves inline; async
        # applies the previous solve's result first and only starts the next
        # solve AFTER those results are published and ingested (otherwise the
        # new solve would see already-leased jobs as still queued and lease
        # them twice). A failed background solve must not abort the cycle:
        # expiry events still publish, and the next cycle solves again.
        try:
            finished = self.runner.poll()
            if finished is not None:
                sequences += finished
        except Exception as e:
            self.log_.with_fields(cycle=self.cycle_count).error(
                "background solve failed: %r", e
            )
        if self.runner.idle and self.runner.synchronous:
            self.runner.submit(lambda now=now: self._schedule_all_pools(now))
            finished = self.runner.poll()
            if finished is not None:
                sequences += finished

        # Periodic pruning of old terminal jobs keeps the jobdb (and the
        # penalty scan) bounded, like the reference's DB pruners.
        if self.cycle_count % 600 == 599:
            self.jobdb.prune_terminal(now - self.config.terminal_job_retention_s)

        # A lease published onto an executor no longer in the heartbeat map
        # (a background solve outliving the executor, by any margin) must
        # reopen the orphan sweep, or the job stays LEASED forever.
        for seq in sequences:
            for event in seq.events:
                if (
                    isinstance(event, JobRunLeased)
                    and event.executor not in self.executors
                ):
                    self._orphan_sweep_done = False

        if token is not None and not self.is_leader.validate(token):
            return []  # lost leadership mid-cycle: nothing published
        for seq in sequences:
            self.log.publish(seq)
        self.ingester.sync()  # optimistic immediate apply (same process)
        if self.config.enable_assertions:
            # Logical sanitizer: jobdb invariants hold after every cycle
            # (jobdb.Assert / EnableAssertions in the reference).
            self.jobdb.read_txn().assert_valid()

        if self.runner.idle and not self.runner.synchronous:
            self.runner.submit(lambda now=now: self._schedule_all_pools(now))
        self.cycle_count += 1
        return sequences

    def _schedule_all_pools(self, now: float) -> list[EventSequence]:
        """Per-pool rounds against one jobdb snapshot; jobs leased by an
        earlier pool are excluded from later pools (the reference writes
        each pool's results into the jobdb txn, scheduling_algo.go:147-188).

        All shared mutable inputs are snapshotted up front: this may run on
        the async runner's background thread while gRPC/cycle threads mutate
        the originals."""
        # Arm the round deadline: every pool's round this cycle draws from
        # one budget (the reference's maxSchedulingDuration bounds the whole
        # scheduling round, config.yaml:105).
        budget = self.config.max_scheduling_duration_s
        self._round_deadline = (
            _time.monotonic() + budget if budget > 0 else None
        )
        executors = dict(self.executors)
        cordoned = set(self.cordoned_queues)
        overrides = dict(self.priority_overrides)
        skipped = self._skipped_executors(executors)
        pools = {
            (n.pool or hb.pool)
            for hb in executors.values()
            for n in hb.nodes
        } | {hb.pool for hb in executors.values()}
        # Configured pools with away pools run rounds even with no own
        # nodes alive — all their work may ride borrowed capacity.
        pools |= {p.name for p in self.config.pools if p.away_pools}
        pools = pools or {p.name for p in self.config.pools}
        self._cycle_incremental_ok = self._incremental_eligible(pools)
        sequences: list[EventSequence] = []
        leased_this_cycle: set[str] = set()
        # Leases from earlier pools' rounds this cycle, visible to later
        # rounds as if already in the jobdb (the reference writes each
        # pool's results into the txn; pool node sets can now overlap via
        # away pools, so id-exclusion alone would double-book nodes).
        pending_leases: dict[str, tuple] = {}
        for pool in sorted(pools):
            # Per-pool round span: the solve profile (setup/pass1/gather/
            # finish) lands as child spans from _solve; the summary attrs
            # are set on this span when the round completes.
            with self._span("scheduler.round", pool=pool,
                            cycle=self.cycle_count):
                pool_seqs = self._schedule_pool(
                    pool, now, exclude=leased_this_cycle,
                    executors=executors, cordoned=cordoned,
                    overrides=overrides,
                    skipped=skipped, pending_leases=pending_leases,
                )
            for seq in pool_seqs:
                for event in seq.events:
                    if isinstance(event, JobRunLeased):
                        leased_this_cycle.add(event.job_id)
                        pending_leases[event.job_id] = (
                            event.node_id,
                            event.pool,
                            event.scheduled_at_priority,
                            event.created,
                            event.run_id,
                        )
            sequences += pool_seqs
        return sequences

    def _skipped_executors(self, executors: dict) -> set[str]:
        """Executors excluded from this round: operator-cordoned, or
        lagging on lease acknowledgement (maxUnacknowledgedJobsPerExecutor,
        scheduling_algo.go:1049-1066). Their running jobs still count toward
        queue usage; their nodes are just not schedulable. Computed once per
        cycle from a snapshot — pool-independent."""
        skipped = {n for n in self.cordoned_executors if n in executors}
        limit = self.config.max_unacknowledged_jobs_per_executor
        if limit:
            unacked: dict[str, int] = {}
            txn = self.jobdb.read_txn()
            for job in txn.leased_jobs():
                run = job.latest_run
                if run is not None and job.state == JobState.LEASED:
                    unacked[run.executor] = unacked.get(run.executor, 0) + 1
            for name, count in unacked.items():
                if count > limit and name in executors:
                    skipped.add(name)
                    self.log_.with_fields(executor=name, unacked=count).warning(
                        "executor lagging on lease acks; skipping this round"
                    )
        return skipped

    def _expire_stale_executors(self, now: float) -> list[EventSequence]:
        """Jobs on executors that stopped heartbeating are requeued or
        failed (scheduler.go:1099 expireJobsIfNecessary).

        Heartbeats are in-memory only, so after a restart/failover the map
        starts empty while the jobdb restores jobs leased to executors that
        may never report again. Jobs whose executor is absent from the map
        are therefore also expired, once a startup grace period (one
        executor timeout, anchored at the first cycle) has given live
        executors the chance to heartbeat. The same path catches a
        background solve publishing a lease onto an executor that was
        expired mid-cycle: the orphaned lease expires on a later cycle."""
        if self.started_at is None:
            self.started_at = now
        timeout = self.config.executor_timeout_s
        stale = {
            name
            for name, hb in self.executors.items()
            if now - hb.last_seen > timeout
        }
        for name in stale:
            self.executors.pop(name, None)
        if stale:
            # Leases published onto a just-dropped executor by an in-flight
            # background solve surface shortly after: keep re-checking for
            # one timeout window.
            self._orphan_recheck_until = now + timeout
        expire_orphans = (now - self.started_at) > timeout and (
            not self._orphan_sweep_done or now < self._orphan_recheck_until
        )
        if expire_orphans:
            self._orphan_sweep_done = True
        if not stale and not expire_orphans:
            return []
        sequences = []
        expired_executors: set[str] = set()
        txn = self.jobdb.read_txn()
        for job in txn.leased_jobs():
            run = job.latest_run
            if run is None:
                continue
            if run.executor in stale:
                reason = f"executor {run.executor} timed out"
            elif expire_orphans and run.executor not in self.executors:
                reason = (
                    f"executor {run.executor} unknown "
                    "(no heartbeat since scheduler start)"
                )
            else:
                continue
            expired_executors.add(run.executor)
            events = [
                JobRunErrors(
                    created=now,
                    job_id=job.id,
                    run_id=run.id,
                    error=reason,
                    retryable=True,
                )
            ]
            if job.num_attempts >= self.config.max_retries + 1:
                events.append(
                    JobErrors(created=now, job_id=job.id, error="max retries exceeded")
                )
            else:
                events.append(JobRequeued(created=now, job_id=job.id))
            sequences.append(
                EventSequence.of(job.queue, job.jobset, *events)
            )
        # Fence every executor whose runs were just reassigned: its view
        # of those leases is now void, and a lease/report exchange still
        # carrying the old token must fail FAILED_PRECONDITION until it
        # completes an anti-entropy sync. Event-sourced in the SAME batch
        # as the expiries, so a dropped publish (lost leadership) drops
        # both atomically and the fence map can never run ahead of the
        # jobdb it protects.
        if expired_executors:
            from ..events.model import CONTROL_PLANE_JOBSET, ExecutorFenced

            sequences.append(
                EventSequence.of(
                    "",
                    CONTROL_PLANE_JOBSET,
                    *[
                        ExecutorFenced(
                            created=now,
                            name=name,
                            fence=self.executor_fence(name) + 1,
                        )
                        for name in sorted(expired_executors)
                    ],
                )
            )
        return sequences

    def _reconcile_runs(self, now: float) -> list[EventSequence]:
        """Run↔node reconciliation (scheduling/reconciliation.go, consumed
        at scheduling_algo.go:293-398): leased runs whose reported node
        vanished or changed pool are invalid. Preemptible invalid jobs are
        preempted — gang-aware: the rest of the gang goes with them
        (reconcilePoolJobs) — and non-preemptible ones are failed. Non-gang
        jobs on deleted nodes are only logged, like the reference
        (checkJobsOnDeletedNodes)."""
        pools_on = {
            p.name: p for p in self.config.pools if p.run_reconciliation
        }
        if not pools_on:
            return []
        node_pool: dict[str, str] = {}
        for hb in self.executors.values():
            for node in hb.nodes:
                node_pool[node.id] = hb.pool
        txn = self.jobdb.read_txn()
        invalid: list[tuple] = []  # (job, reason)
        for job in txn.leased_jobs():
            run = job.latest_run
            if run is None or run.pool not in pools_on:
                continue
            cfg = pools_on[run.pool]
            is_gang = job.spec.gang is not None
            if run.node_id not in node_pool:
                if is_gang:
                    invalid.append(
                        (job, f"node {run.node_id} no longer exists")
                    )
                else:
                    self.log_.with_fields(job=job.id).warning(
                        "non-gang job on deleted node %s", run.node_id
                    )
                continue
            allowed = {run.pool, *cfg.away_pools}
            if node_pool[run.node_id] not in allowed:
                invalid.append(
                    (
                        job,
                        f"node {run.node_id} moved from pool {run.pool} "
                        f"to {node_pool[run.node_id]}",
                    )
                )
        if not invalid:
            return []
        sequences = []
        handled: set[str] = set()
        for job, reason in invalid:
            if job.id in handled:
                continue
            handled.add(job.id)
            preemptible = self.config.priority_class(
                job.spec.priority_class
            ).preemptible
            run = job.latest_run
            if preemptible:
                events = [
                    JobRunPreempted(
                        created=now,
                        job_id=job.id,
                        run_id=run.id if run else "",
                        reason=f"reconciliation: {reason}",
                    )
                ]
                sequences.append(EventSequence.of(job.queue, job.jobset, *events))
                # Gang-aware: preempt the remaining preemptible members.
                if job.spec.gang is not None:
                    for member in txn.gang_jobs(job.queue, job.spec.gang.id):
                        if member.id in handled or member.state.terminal:
                            continue
                        if not self.config.priority_class(
                            member.spec.priority_class
                        ).preemptible:
                            continue
                        handled.add(member.id)
                        mrun = member.latest_run
                        sequences.append(
                            EventSequence.of(
                                member.queue,
                                member.jobset,
                                JobRunPreempted(
                                    created=now,
                                    job_id=member.id,
                                    run_id=mrun.id if mrun else "",
                                    reason=(
                                        "reconciliation: other gang members"
                                        f" invalid ({job.id})"
                                    ),
                                ),
                            )
                        )
            else:
                sequences.append(
                    EventSequence.of(
                        job.queue,
                        job.jobset,
                        JobErrors(
                            created=now,
                            job_id=job.id,
                            error=f"reconciliation: {reason}",
                        ),
                    )
                )
        return sequences

    def _handle_failed_runs(self, now: float) -> list[EventSequence]:
        """Runs reported failed by executors: requeue the job (with the
        failed node recorded for anti-affinity) or fail it after max
        retries (scheduler.go:589-636 generateUpdateMessages)."""
        from ..jobdb.jobdb import RunState

        sequences = []
        txn = self.jobdb.read_txn()
        # Indexed: only jobs whose latest run failed and await the decision
        # (no full-store walk; jobdb._failed_pending).
        for job in txn.failed_run_jobs():
            run = job.latest_run
            if run is None or run.state != RunState.FAILED:
                continue
            if not run.retryable:
                # Fatal pod issue (podchecks Action.FAIL): no retry.
                event = JobErrors(
                    created=now, job_id=job.id, error=job.error or "fatal run error"
                )
            elif job.num_attempts >= self.config.max_retries + 1:
                event = JobErrors(
                    created=now, job_id=job.id, error="max retries exceeded"
                )
            else:
                event = JobRequeued(created=now, job_id=job.id)
            sequences.append(EventSequence.of(job.queue, job.jobset, event))
        return sequences

    def _build_pool_inputs(
        self,
        pool: str,
        exclude: set[str] = frozenset(),
        executors: dict | None = None,
        overrides: dict | None = None,
        skipped: set[str] | None = None,
        pending_leases: dict | None = None,
    ):
        executors = executors if executors is not None else dict(self.executors)
        if skipped is None:
            skipped = self._skipped_executors(executors)
        # Cross-pool borrowing (scheduling_algo.go:421-504): this round's
        # node set is the pool's own nodes plus its configured away pools'
        # nodes; pools that list US as an away pool contribute their
        # running jobs as away candidates / allocation pressure.
        pool_cfg = next((p for p in self.config.pools if p.name == pool), None)
        away_node_pools = set(pool_cfg.away_pools) if pool_cfg else set()
        allowed_pools = {pool} | away_node_pools
        borrower_pools = {
            p.name for p in self.config.pools if pool in p.away_pools
        }
        import dataclasses as _dc_nodes

        nodes: list[NodeSpec] = []
        node_executor: dict[str, str] = {}
        for hb in executors.values():
            for node in hb.nodes:
                # Per-node pools (node_group.go GetPool): an executor's
                # nodes may span pools; match each node, not the cluster.
                if (node.pool or hb.pool) not in allowed_pools:
                    continue
                if hb.name in skipped and not node.unschedulable:
                    # Skipped (cordoned / lagging) executors take no NEW
                    # placements but their nodes stay IN the round as
                    # unschedulable, keeping running jobs bound — a
                    # cordon must not read as "nodes vanished", which
                    # would dangle running jobs at NO_NODE and let the
                    # solver gang-preempt their mates the next cycle
                    # (the drain orchestrator relies on this: cordon
                    # first, preempt only at ITS deadline).
                    node = _dc_nodes.replace(node, unschedulable=True)
                nodes.append(node)
                node_executor[node.id] = hb.name

        from ..core.resources import parse_quantity

        txn = self.jobdb.read_txn()
        running: list[RunningJob] = []
        # Jobs of unrelated pools running on this round's nodes: their
        # resources become unallocatable on the node — scheduled around,
        # never evicted (scheduling_algo.go:489-498 otherPoolsJobs).
        # Floating resources are pool-level, never node capacity: they must
        # not enter node unallocatable (they would drive the zeroed
        # floating columns negative and fail every fit on the node).
        blockers: dict[str, dict] = {}
        floating_names = {fr.name for fr in self.config.floating_resources}

        def classify(job, node_id, run_pool, prio, leased_ts):
            if run_pool == pool or run_pool in borrower_pools:
                running.append(
                    RunningJob(
                        job=job.spec.with_(priority=job.priority),
                        node_id=node_id,
                        scheduled_at_priority=prio,
                        leased_ts=leased_ts,
                        away=run_pool != pool,
                    )
                )
            elif node_id in node_executor:
                bucket = blockers.setdefault(node_id, {})
                for name, qty in job.spec.requests.items():
                    if name in floating_names:
                        continue
                    bucket[name] = bucket.get(name, 0) + parse_quantity(qty)

        pending_leases = pending_leases or {}
        for job in txn.leased_jobs():
            run = job.latest_run
            if run is None or job.id in pending_leases:
                continue
            classify(job, run.node_id, run.pool, run.scheduled_at_priority,
                     run.leased)
        # Leases from earlier pools' rounds this cycle (not yet in the
        # jobdb): bind them exactly like jobdb runs so overlapping node
        # sets never double-book.
        for jid, (node_id, run_pool, prio, leased_ts, _rid) in pending_leases.items():
            job = txn.get(jid)
            if job is not None:
                classify(job, node_id, run_pool, prio, leased_ts)
        if blockers:
            import dataclasses as _dc

            from ..core.priorities import priority_levels

            top = int(priority_levels(self.config.priority_classes)[-1])
            patched = []
            for node in nodes:
                extra = blockers.get(node.id)
                if not extra:
                    patched.append(node)
                    continue
                unalloc = {
                    k: dict(v)
                    for k, v in (node.unallocatable_by_priority or {}).items()
                }
                at_top = unalloc.setdefault(top, {})
                for name, qty in extra.items():
                    at_top[name] = parse_quantity(at_top.get(name, 0)) + qty
                patched.append(
                    _dc.replace(node, unallocatable_by_priority=unalloc)
                )
            nodes = patched
        # Unsorted: the snapshot builder re-derives fair-share order
        # vectorized (np.lexsort), so the O(k log k) Python sort is skipped.
        queued_jobs = [
            j
            for j in txn.queued_jobs(sort=False)
            if j.id not in exclude
            # Pool eligibility (getQueuedJobs, scheduling_algo.go:533):
            # empty pools = eligible everywhere.
            and (not j.spec.pools or pool in j.spec.pools)
        ]
        queued = [j.spec.with_(priority=j.priority) for j in queued_jobs]
        # Retry anti-affinity: nodes where earlier attempts failed
        # (scheduler.go:589-636).
        excluded_nodes = {
            j.id: list(j.failed_nodes) for j in queued_jobs if j.failed_nodes
        }
        queue_names = {j.queue for j in queued} | {r.job.queue for r in running}
        queues = [
            self._effective_queue(name, overrides) for name in sorted(queue_names)
        ]
        return nodes, queues, running, queued, node_executor, txn, excluded_nodes

    def _short_job_penalties(self, txn, pool: str, now: float) -> dict:
        """Requests of recently finished short jobs, per queue: they count
        against the queue's ordering cost until started + window passes
        (short_job_penalty.go)."""
        window = self.config.short_job_penalty_s
        if not window:
            return {}
        from ..core.resources import parse_quantity

        penalties: dict[str, dict] = {}
        # Indexed candidate set: terminal jobs finished inside the window
        # (jobdb._finished_recent; entries past the window self-prune).
        for job in txn.finished_since(now - window):
            # Any terminal state except preemption counts (the reference
            # penalizes failed/cancelled churn too, short_job_penalty.go).
            if job.state == JobState.PREEMPTED:
                continue
            run = job.latest_run
            if run is None or run.pool != pool or not run.started:
                continue
            if run.finished - run.started >= window:
                continue  # not a short job
            if now >= run.started + window:
                continue  # penalty window passed
            bucket = penalties.setdefault(job.queue, {})
            for name, qty in job.spec.requests.items():
                bucket[name] = bucket.get(name, 0) + parse_quantity(qty)
        return penalties

    def _schedule_pool(
        self,
        pool: str,
        now: float,
        exclude: set[str] = frozenset(),
        executors: dict | None = None,
        cordoned: set | None = None,
        overrides: dict | None = None,
        skipped: set[str] | None = None,
        pending_leases: dict | None = None,
    ) -> list[EventSequence]:
        inc = None
        t_build = _time.monotonic()
        txn = self.jobdb.read_txn()
        if self._cycle_incremental_ok and not exclude and not pending_leases:
            inc = self._incremental_round(
                pool, now, executors, overrides, skipped, cordoned, txn
            )
        if inc is not None:
            st = self._inc_state[pool]
            node_executor = st["node_executor"]
            g_tokens, q_tokens = st["tokens"]
            if not st["node_executor"] or inc._size == len(inc._free):
                # Idle round: persist the refilled buckets anyway —
                # _refill_rate_tokens already advanced the refill clock,
                # so dropping them would freeze depleted buckets for the
                # whole idle stretch.
                self._rate_tokens[pool] = g_tokens
                for qn, tokens in q_tokens.items():
                    self._queue_rate_tokens[(pool, qn)] = tokens
                return []
            snap = inc.snapshot()
        else:
            (
                nodes,
                queues,
                running,
                queued,
                node_executor,
                txn,
                excluded_nodes,
            ) = self._build_pool_inputs(
                pool, exclude, executors, overrides, skipped, pending_leases
            )
            if not nodes or not (queued or running):
                return []
            g_tokens, q_tokens = self._refill_rate_tokens(
                pool, now, [q.name for q in queues]
            )
            snap = build_round_snapshot(
                self.config,
                pool,
                nodes,
                queues,
                running,
                queued,
                excluded_nodes=excluded_nodes,
                cordoned_queues=(
                    cordoned if cordoned is not None else self.cordoned_queues
                ),
                short_job_penalty=self._short_job_penalties(txn, pool, now),
                global_rate_tokens=g_tokens,
                queue_rate_tokens=q_tokens,
            )
        # Device-resident round state (snapshot/residency.py): keep the
        # padded DeviceRound on device across warm cycles and delta-sync
        # it in _attempt_round. Mesh solves re-pad and re-place the node
        # axis per round, so residency engages on single-device solves
        # only; "incremental" mode keeps the legacy re-upload path. A
        # cycle that demoted to rebuild (inc is None) keeps the resident
        # buffers — the next incremental cycle resyncs them by delta.
        use_resident = (
            inc is not None
            and self.mesh is None
            and self.snapshot_mode in ("auto", "resident")
        )
        if self.snapshot_mode not in ("auto", "resident") or self.mesh is not None:
            self._resident.pop(pool, None)
        elif use_resident and pool not in self._resident:
            from ..snapshot.residency import ResidentRound

            self._resident[pool] = ResidentRound(self.device)
        snapshot_mode_used = (
            "resident" if use_resident
            else ("incremental" if inc is not None else "rebuild")
        )
        solve_started = _time.time()
        t_solve = _time.monotonic()
        result = self._solve(snap, inc=inc)
        if use_resident:
            self._maybe_check_resident_drift(pool)
        if result is None:
            # The admission firewall rejected every usable rung's round
            # (or the ladder ran out of budget): NOTHING commits this
            # cycle — no leases, no preemptions, no ledger entry — and
            # the queued work simply waits for the next round.
            self.log_.with_fields(
                cycle=self.cycle_count, pool=pool, stage="scheduling-round",
            ).warning("round rejected; committing nothing, work requeued")
            return []
        # Round-deadline guardrail: a truncated round still commits the
        # partial placement below (queued placements are a prefix of the
        # full round's decisions; evicted running jobs got their pinned
        # rebind via the solver's rescue pass, so no extra preemptions);
        # unplaced jobs stay QUEUED and the next cycle resumes from the
        # truncation point via the jobdb. Repeated truncation trips
        # per-pool backpressure.
        truncated = bool(result.get("truncated", False))
        self.round_pressure.note_round(pool, truncated)
        if truncated:
            self.log_.with_fields(
                cycle=self.cycle_count,
                pool=pool,
                streak=self.round_pressure.streak(pool),
                loops=result.get("num_loops", 0),
            ).warning(
                "scheduling round truncated by maxSchedulingDuration; "
                "committing partial placement"
            )
        # Spend rate-limit tokens on newly scheduled jobs (ReserveN in the
        # reference, gang_scheduler.go:118-123); rescheduled evictees are
        # free (scheduled_mask covers new work only).
        import numpy as np_

        n_new = int(np_.asarray(result["scheduled_mask"]).sum())
        self._rate_tokens[pool] = max(0.0, g_tokens - n_new)
        by_queue: dict[str, int] = {}
        for j in np_.flatnonzero(result["scheduled_mask"]):
            qn = snap.queue_names[int(snap.job_queue[j])]
            by_queue[qn] = by_queue.get(qn, 0) + 1
        # Persist EVERY queue's refilled balance, not just spenders — an
        # idle queue's bucket must recover toward its burst.
        for qn, tokens in q_tokens.items():
            self._queue_rate_tokens[(pool, qn)] = max(
                0.0, tokens - by_queue.get(qn, 0)
            )
        resident = self._resident.get(pool) if use_resident else None
        self.last_cycle_stats = {
            "pool": pool,
            "jobs": snap.num_jobs,
            "nodes": snap.num_nodes,
            "scheduled": int(result["scheduled_mask"].sum()),
            "preempted": int(result["preempted_mask"].sum()),
            # The port's additions: how the round was built, synced and
            # solved (chip_smoke.py's service phase reads them).
            "snapshot_mode": snapshot_mode_used,
            "sync": dict(resident.last_sync) if resident is not None else None,
            "rung": result.get("rung"),
            "failover": result.get("failover"),
            "truncated": truncated,
            "snapshot_s": t_solve - t_build,
            "sync_s": result.get("sync_s", 0.0),
            "solve_s": _time.monotonic() - t_solve,
        }
        if self.tracer is not None:
            round_span = self.tracer.current_span()
            if round_span is not None and round_span.name == "scheduler.round":
                round_span.attrs.update(
                    jobs=snap.num_jobs,
                    nodes=snap.num_nodes,
                    scheduled=self.last_cycle_stats["scheduled"],
                    preempted=self.last_cycle_stats["preempted"],
                    truncated=truncated,
                )
                if result.get("failover"):
                    # Failover attribution: the round span names the rung
                    # that actually produced the committed placement.
                    round_span.attrs.update(
                        failover_from=result["failover"]["from"],
                        failover_to=result["failover"]["to"],
                        failover_cause=result["failover"]["cause"],
                    )
        self.log_.with_fields(
            cycle=self.cycle_count, pool=pool, stage="scheduling-round",
            jobs=snap.num_jobs, nodes=snap.num_nodes,
            scheduled=self.last_cycle_stats["scheduled"],
            preempted=self.last_cycle_stats["preempted"],
            solve_s=round(_time.time() - solve_started, 4),
        ).info("scheduling round complete")
        self._record_round(pool, snap, result, solve_started, now=now)

        by_jobset: dict[tuple, list] = {}
        import numpy as np

        for j in np.flatnonzero(result["scheduled_mask"]):
            job = txn.get(snap.job_ids[j])
            node_id = snap.node_ids[int(result["assigned_node"][j])]
            event = JobRunLeased(
                created=now,
                job_id=job.id,
                run_id=new_id("run"),
                executor=node_executor.get(node_id, ""),
                node_id=node_id,
                pool=pool,
                scheduled_at_priority=int(result["scheduled_priority"][j]),
            )
            by_jobset.setdefault((job.queue, job.jobset), []).append(event)

        fo = result.get("failover")
        if fo and by_jobset:
            # Failover attribution on the job journey: every job leased
            # this round was placed by a fallback rung, and `armadactl
            # job-trace` should say so.
            self.timeline.note_solver_failover(
                [e.job_id for events in by_jobset.values() for e in events],
                now,
                f"placed by fallback solver {fo['to']} after "
                f"{fo['cause']} on {fo['from']}",
            )

        # Preemption attribution (armada_tpu/observe/fairness.py): every
        # round preemption's event carries its aggressor queue/gang and
        # mechanism, so `armadactl job-trace` answers "preempted by
        # queue B gang g-7 under DRF rebalance" instead of a bare
        # "preempted by scheduler round".
        attributed = {
            int(p["job"]): p.get("reason", "")
            for p in (result.get("fairness_decorated") or {}).get(
                "preemptions", ()
            )
        }
        for j in np.flatnonzero(result["preempted_mask"]):
            job = txn.get(snap.job_ids[j])
            run = job.latest_run
            run_id = run.id if run else ""
            if not run_id and pending_leases and job.id in pending_leases:
                # Preempting a lease granted by an earlier pool's round in
                # this same cycle (cross-pool away eviction): the run isn't
                # in the jobdb yet — the pending lease carries its id.
                run_id = pending_leases[job.id][4]
            event = JobRunPreempted(
                created=now,
                job_id=job.id,
                run_id=run_id,
                reason=attributed.get(int(j))
                or "preempted by scheduler round",
            )
            by_jobset.setdefault((job.queue, job.jobset), []).append(event)

        # Continue each job's submit trace onto its lease/preempt events:
        # the journey ledger holds the SubmitJobs batch's traceparent, so
        # the whole jobset shares one context in the common case. Mixed
        # groups (jobs from different submit traces batched into one
        # sequence) stay unstamped rather than mis-attributed.
        tps = self.timeline.traceparents(
            [e.job_id for events in by_jobset.values() for e in events]
        )
        sequences = []
        for (queue, jobset), events in by_jobset.items():
            contexts = {tps[e.job_id] for e in events}
            tp = contexts.pop() if len(contexts) == 1 else ""
            sequences.append(
                EventSequence.of(queue, jobset, *events, traceparent=tp)
            )
        return sequences

    def _resolve_sharded_run(self, kernel_path: str = "lax"):
        """Lazily build the sharded solve runner for self.mesh: an int or
        1D DeviceMesh selects the single-host node-sharded path, an "HxC"
        string / (hosts, chips) tuple / 2D DeviceMesh the two-level
        hierarchy (parallel/multihost.py). kernel_path (the first pool's
        configured solve kernel; the runner is built once and shared)
        selects the winner-kernel dist of the hierarchy when "cuda".
        With a `device` given, every shard runs on it (shard threads on
        one card, or on the CPU); with none, each shard takes a card of
        its own."""
        if self._sharded_run is None:
            from ..parallel.mesh import DeviceMesh
            from ..parallel.multihost import parse_mesh_spec, resolve_solver

            devices = None
            if self.device is not None and not isinstance(self.mesh, DeviceMesh):
                devices = [self.device] * parse_mesh_spec(self.mesh).n_shards
            self._sharded_run = resolve_solver(
                self.mesh, kernel_path=kernel_path, devices=devices
            )
            self._mesh_size = self._sharded_run.n_shards
        return self._sharded_run

    def _emit_solve_spans(self, pool: str, profile: dict | None,
                          solve_s: float, transfer: dict | None = None):
        """Child spans of the open round span for the hot-window solve
        profile: setup/pass1/gather/finish laid out sequentially over
        the measured solve window, plus the loop mix and rewindow count
        as attrs on the round span itself — so the exported spans show
        WHERE a round spent its time. The transfer ledger rides as
        round-span attrs."""
        tracer = self.tracer
        if tracer is None:
            return
        parent = tracer.current_span()
        if parent is not None and parent.name == "scheduler.round":
            parent.attrs.update(
                solve_s=round(solve_s, 4),
                backend=self.backend,
            )
            if transfer:
                parent.attrs.update(
                    transfer_bytes_up=int(transfer.get("bytes_up", 0)),
                    transfer_bytes_down=int(transfer.get("bytes_down", 0)),
                    transfer_donated_bytes=int(
                        transfer.get("donated_bytes", 0)
                    ),
                    transfer_donated_buffers=int(
                        transfer.get("donated_buffers", 0)
                    ),
                )
        if not profile:
            return
        if parent is not None:
            parent.attrs.update(
                gang_loops=profile.get("gang_loops", 0),
                fill_loops=profile.get("fill_loops", 0),
                merged_fill_loops=profile.get("merged_fill_loops", 0),
                rewindows=profile.get("rewindows", 0),
                window_slots=profile.get("window_slots", 0),
            )
        import time as _t

        from ..utils.tracing import add_segment_spans

        add_segment_spans(
            tracer, parent, _t.time_ns() - int(solve_s * 1e9), profile,
            pool=pool,
        )

    # ------------------------------------------------------------------
    # Incremental snapshots (O(delta) cycles): the service-side analogue
    # of the reference's serial-based delta sync (scheduler.go:441). The
    # jobdb changelog feeds per-pool IncrementalRound state; structural
    # changes (nodes, queues/weights, vocab misses, truncated history)
    # fall back to a full rebuild for that cycle.
    # ------------------------------------------------------------------

    def _incremental_eligible(self, pools) -> bool:
        """Kernel-backend rounds run incrementally per pool (each pool
        keeps its own _inc_state; a pool that cannot — cross-pool
        exclude set, pending leases, structure change — demotes to
        rebuild for that cycle only). Market mode re-prices existing
        queued specs in place (bid refresh), and cross-pool away
        classification depends on multi-pool run state — both use the
        rebuild path."""
        return (
            self.backend == "kernel"
            and self.snapshot_mode != "rebuild"
            and not self.config.market_driven
            and not any(p.away_pools for p in self.config.pools)
        )

    @staticmethod
    def _node_sig(nodes) -> int:
        """Content signature of the round's node set (cached per NodeSpec
        object — heartbeats that resend the same objects re-hash nothing)."""
        sigs = []
        for n in nodes:
            s = n.__dict__.get("_content_sig")
            if s is None:
                s = hash((
                    n.id,
                    n.executor,
                    n.pool,
                    n.unschedulable,
                    tuple(sorted(n.labels.items())),
                    n.taints,
                    tuple(sorted(n.total_resources.items())),
                    tuple(
                        (p, tuple(sorted(r.items())))
                        for p, r in sorted(
                            (n.unallocatable_by_priority or {}).items()
                        )
                    ),
                ))
                object.__setattr__(n, "_content_sig", s)
            sigs.append(s)
        return hash(tuple(sigs))

    def _queue_sig(self, queue_names, overrides) -> int:
        return hash(
            tuple(
                (name, self._effective_queue(name, overrides).weight)
                for name in sorted(queue_names)
            )
        )

    def _refill_rate_tokens(self, pool, now, queue_names):
        """Refill the persisted token buckets for this cycle (the
        reference's limiter carries across cycles; rate * dt refills)."""
        limits = self.config.rate_limits
        last = self._rate_last_refill.get(pool)
        dt = max(0.0, now - last) if last is not None else 0.0
        self._rate_last_refill[pool] = now
        g_tokens = min(
            self._rate_tokens.get(pool, float(limits.maximum_scheduling_burst))
            + dt * limits.maximum_scheduling_rate,
            float(limits.maximum_scheduling_burst),
        )
        q_tokens = {
            name: min(
                self._queue_rate_tokens.get(
                    (pool, name),
                    float(limits.maximum_per_queue_scheduling_burst),
                )
                + dt * limits.maximum_per_queue_scheduling_rate,
                float(limits.maximum_per_queue_scheduling_burst),
            )
            for name in queue_names
        }
        return g_tokens, q_tokens

    def _incremental_round(
        self, pool, now, executors, overrides, skipped, cordoned, txn
    ):
        """Return an up-to-date IncrementalRound for this cycle, or None
        when the rebuild path must run (no nodes / structure changed in a
        way that needs the full input build)."""
        from ..snapshot.incremental import (
            IncrementalRound,
            SnapshotRebuildRequired,
        )

        executors = executors if executors is not None else dict(self.executors)
        if skipped is None:
            skipped = self._skipped_executors(executors)
        import dataclasses as _dc_nodes

        nodes = []
        node_executor: dict[str, str] = {}
        for hb in executors.values():
            for node in hb.nodes:
                if (node.pool or hb.pool) != pool:
                    continue
                if hb.name in skipped and not node.unschedulable:
                    # Mirror the rebuild path: skipped executors' nodes
                    # stay in the round as unschedulable (running jobs
                    # keep their binding; no new placements). The fresh
                    # NodeSpec changes the node signature, so a cordon
                    # flip forces the rebuild the new state needs.
                    node = _dc_nodes.replace(node, unschedulable=True)
                nodes.append(node)
                node_executor[node.id] = hb.name
        if not nodes:
            return None
        node_sig = self._node_sig(nodes)

        st = self._inc_state.get(pool)

        def rebuild():
            (
                _nodes,
                queues,
                running,
                queued,
                _node_executor,
                _txn,
                excluded,
            ) = self._build_pool_inputs(pool, frozenset(), executors,
                                        overrides, skipped)
            if not (queued or running):
                self._inc_state.pop(pool, None)
                return None
            inc = IncrementalRound(
                self.config, pool, _nodes, queues, running, queued,
            )
            self._inc_state[pool] = {
                "inc": inc,
                "serial": self.jobdb.serial,
                "node_sig": node_sig,
                "queue_sig": self._queue_sig(
                    [q.name for q in queues], overrides
                ),
                "node_executor": _node_executor,
                "queue_names": [q.name for q in queues],
                "excluded": dict(excluded or {}),
            }
            return inc

        if st is not None:
            queue_sig = self._queue_sig(st["queue_names"], overrides)
        if (
            st is None
            or st["node_sig"] != node_sig
            or st["queue_sig"] != queue_sig
        ):
            inc = rebuild()
        else:
            changed = self.jobdb.changed_since(st["serial"])
            if changed is None:
                inc = rebuild()
            else:
                inc = st["inc"]
                try:
                    self._apply_job_deltas(pool, st, inc, changed, txn)
                except (SnapshotRebuildRequired, KeyError) as e:
                    self.log_.with_fields(pool=pool).info(
                        "incremental snapshot rebuild: %s", e
                    )
                    inc = rebuild()
        if inc is None:
            return None
        st = self._inc_state[pool]
        g_tokens, q_tokens = self._refill_rate_tokens(
            pool, now, st["queue_names"]
        )
        st["tokens"] = (g_tokens, q_tokens)
        inc.set_round_params(
            excluded_nodes=st["excluded"],
            cordoned_queues=(
                cordoned if cordoned is not None else self.cordoned_queues
            ),
            short_job_penalty=self._short_job_penalties(txn, pool, now),
            global_rate_tokens=g_tokens,
            queue_rate_tokens=q_tokens,
        )
        return inc

    def _apply_job_deltas(self, pool, st, inc, changed, txn):
        """Translate jobdb changes since the watermark into incremental
        ops; raises SnapshotRebuildRequired on anything unexpected."""
        from ..snapshot.incremental import SnapshotRebuildRequired

        adds, binds, unbinds, removes = [], [], [], []
        live = (JobState.LEASED, JobState.PENDING, JobState.RUNNING)
        excluded = st["excluded"]
        for jid in changed:
            job = txn.get(jid)
            row = inc._id_to_row.get(jid)
            if job is None or job.state.terminal:
                if row is not None:
                    removes.append(jid)
                excluded.pop(jid, None)
                continue
            if job.spec.pools and pool not in job.spec.pools:
                # Pool-restricted elsewhere (getQueuedJobs eligibility,
                # scheduling_algo.go:533) — not this round's candidate.
                if row is not None:
                    removes.append(jid)
                excluded.pop(jid, None)
                continue
            if job.failed_nodes:
                excluded[jid] = list(job.failed_nodes)
            else:
                excluded.pop(jid, None)
            if job.state == JobState.QUEUED:
                if row is None:
                    adds.append(job.spec.with_(priority=job.priority))
                else:
                    if inc._is_running[row]:
                        unbinds.append(jid)
                    if inc._submit_prio[row] != job.priority:
                        inc.set_priority(jid, job.priority)
            elif job.state in live:
                run = job.latest_run
                if run is None or run.pool != pool:
                    if row is not None:
                        removes.append(jid)
                    continue
                lease = (jid, run.node_id, run.scheduled_at_priority,
                         run.leased)
                if row is None:
                    adds.append(job.spec.with_(priority=job.priority))
                    binds.append(lease)
                elif not inc._is_running[row]:
                    binds.append(lease)
                else:
                    node_idx = inc._node_index.get(run.node_id, -1)
                    if (
                        inc._node[row] != node_idx
                        or inc._priority[row] != run.scheduled_at_priority
                    ):
                        # Re-leased elsewhere within one sync window.
                        unbinds.append(jid)
                        binds.append(lease)
            else:
                raise SnapshotRebuildRequired(
                    f"unhandled state {job.state} for {jid}"
                )
        # Order matters: unbinds release gang/alloc state, removals free
        # rows, adds must precede binds that reference them.
        inc.unbind(unbinds)
        inc.remove_jobs(removes)
        inc.add_jobs(adds)
        inc.bind(binds)
        st["serial"] = self.jobdb.serial

    def _remaining_budget(self) -> float | None:
        """Wall-clock left of this cycle's scheduling budget (None when no
        deadline is configured). Floored just above zero so a later pool's
        round still starts — the solvers' forward-progress floor then runs
        one loop and truncates, committing evicted rebinds instead of
        skipping the pool silently."""
        if self._round_deadline is None:
            return None
        return max(1e-9, self._round_deadline - _time.monotonic())

    def _maybe_check_resident_drift(self, pool: str) -> None:
        """Periodic integrity sweep of the pool's device-resident round
        buffers: byte-compare every device leaf against the host mirror
        (a d2h pull of the whole tree — cheap relative to cadence). On
        drift the resident state is reset so the next cycle re-uploads
        from scratch; the already-committed round is safe either way
        because the admission firewall validated it against the host
        mirror, which is authoritative. Advisory: a check failure must
        never fail the round."""
        resident = self._resident.get(pool)
        if resident is None or not resident.last_sync:
            return
        every = int(getattr(self.config, "resident_drift_check_every", 0) or 0)
        if every <= 0 or self.cycle_count % every != 0:
            return
        try:
            drifted = resident.check_drift()
        except Exception as e:  # noqa: BLE001 - advisory path
            self.log_.with_fields(pool=pool).error(
                "resident drift check failed: %r", e
            )
            return
        if not drifted:
            return
        self.log_.with_fields(
            pool=pool, cycle=self.cycle_count, fields=",".join(drifted),
        ).error("device-resident round drifted from host mirror; resetting")
        resident.reset()

    def _solve(self, snap, inc=None):
        """Solve one round, guarded by the self-healing solve path:
        every attempt's output passes the admission firewall
        (solver/validate.py) before anything commits, and a
        raising/hanging/rejected attempt retries down the failover
        ladder (solver/failover.py) within the same cycle. Returns the
        round's result dict, or None when every usable rung failed —
        the caller then commits NOTHING and the work stays queued.
        (The JAX package's unguarded, ledger-free solve serves the
        market's idealised-value pass, which waits for ROADMAP A7.4.)"""
        from ..services.chaos import SolverHangError
        from ..solver.validate import RoundRejected

        validate = bool(self.config.solver_validate)
        ladder = self.failover
        if ladder is None:
            try:
                result = self._attempt_round(
                    snap, self._rungs[0], inc=inc, validate=validate,
                )
            except RoundRejected as rj:
                self._note_rejection(snap, self._rungs[0], rj)
                return None
            result["rung"] = self._rungs[0].label
            return result
        live, probes = ladder.plan(self.cycle_count)
        result = None
        chosen = None
        first_failed = None
        last_cause = None
        for i, rung in enumerate(live):
            if i > 0 and self._round_deadline is not None and (
                self._round_deadline - _time.monotonic() <= 0.0
            ):
                # Budget-bounded retries: no wall clock left for another
                # rung this cycle — give up, requeue everything.
                self.log_.with_fields(
                    cycle=self.cycle_count, pool=snap.pool
                ).warning(
                    "failover ladder out of round budget before rung %s;"
                    " round rejected", rung.label,
                )
                break
            cause = None
            try:
                result = self._attempt_round(
                    snap, rung, inc=inc, validate=validate,
                )
            except RoundRejected as rj:
                self._note_rejection(snap, rung, rj)
                cause = "validation"
            except SolverHangError as e:
                cause = "hang"
                self.log_.with_fields(
                    cycle=self.cycle_count, pool=snap.pool, rung=rung.label
                ).error("solver rung hung past budget: %r", e)
            except Exception as e:  # noqa: BLE001 - any solve fault fails over
                cause = "raise"
                self.log_.with_fields(
                    cycle=self.cycle_count, pool=snap.pool, rung=rung.label
                ).error("solver rung raised: %r", e)
            if cause is None:
                chosen = rung
                ladder.record_success(rung.label, self.cycle_count)
                break
            ladder.record_failure(rung.label, self.cycle_count)
            last_cause = cause
            if first_failed is None:
                first_failed = rung
            nxt = live[i + 1] if i + 1 < len(live) else None
            self._note_failover(snap.pool, rung, nxt, cause)
        if result is not None:
            # Half-open rungs earn their way back via a shadow solve:
            # validated, then DISCARDED — never committed.
            for rung in probes:
                if self._round_deadline is not None and (
                    self._round_deadline - _time.monotonic() <= 0.0
                ):
                    break
                try:
                    self._attempt_round(
                        snap, rung, inc=inc, fairness=False,
                        validate=True, shadow=True,
                    )
                except Exception:  # noqa: BLE001 - probe failure re-opens
                    ladder.record_failure(rung.label, self.cycle_count)
                else:
                    ladder.record_success(rung.label, self.cycle_count)
                    self.log_.with_fields(
                        cycle=self.cycle_count, rung=rung.label
                    ).info("solver rung restored after clean shadow probe")
        if result is None:
            return None
        # The rung that produced the committed placement (read by
        # last_cycle_stats; the JAX package's result has no such key).
        result["rung"] = chosen.label
        if first_failed is not None and chosen is not None:
            result["failover"] = {
                "from": first_failed.label,
                "to": chosen.label,
                "cause": last_cause,
            }
        return result

    def _note_rejection(self, snap, rung, rj):
        """Book a firewall rejection: doctor ledger, log line."""
        v = rj.violation
        self.recent_rejections.append(
            {
                "cycle": self.cycle_count,
                "pool": snap.pool,
                "rung": rung.label,
                "invariant": v.invariant,
                "detail": v.detail,
                "bundle": rj.bundle or "",
            }
        )
        self.log_.with_fields(
            cycle=self.cycle_count, pool=snap.pool, rung=rung.label,
            invariant=v.invariant,
        ).error(
            "round admission firewall rejected the round: %s (postmortem: %s)",
            v.detail, rj.bundle or "not captured",
        )

    def _note_failover(self, pool, from_rung, to_rung, cause):
        """Book one ladder step: doctor ledger, log line.
        to_rung None means the ladder was exhausted (round rejected)."""
        to_label = to_rung.label if to_rung is not None else "rejected"
        self.recent_failovers.append(
            {
                "cycle": self.cycle_count,
                "pool": pool,
                "from": from_rung.label,
                "to": to_label,
                "cause": cause,
            }
        )
        self.log_.with_fields(cycle=self.cycle_count, pool=pool).warning(
            "solver failover %s -> %s (%s)", from_rung.label, to_label, cause
        )

    def _attempt_round(self, snap, rung, *, inc=None, fairness=True,
                       validate=True, shadow=False):
        """One solve attempt on a single ladder rung. Raises the
        solver's own faults (the ladder catches them) and RoundRejected
        when the admission firewall refuses the output. `shadow=True`
        is the half-open probe mode: the solve runs and validates, but
        no advisory round seam (the round spans) observes it and no fault
        is injected into it; its output is discarded either way."""
        budget_s = self._remaining_budget()
        chaos = self.solver_chaos if not shadow else None
        if chaos is not None:
            chaos.before_solve(rung.label)
        if rung.kind != "oracle":
            import dataclasses as _dcls
            import time as _t

            import numpy as np

            from ..observe import ledger as _tledger
            from ..solver.kernel import solve_round
            from ..solver.kernel_prep import pad_device_round, prep_device_round

            # Device-resident path (snapshot/residency.py): the pool's
            # persistent device buffers are delta-synced inside the round
            # ledger below so the (delta-sized) upload books against this
            # round; every host-side consumer downstream — admission
            # firewall, fairness ledger — reads the host mirror
            # (dev_host) so nothing pulls the resident tree back to host.
            # The mesh rung re-pads and re-places the node axis per
            # round, so it always takes the fresh prep.
            resident = (
                self._resident.get(snap.pool)
                if inc is not None and rung.kind != "mesh"
                else None
            )
            if resident is not None:
                dev = dev_host = None  # synced inside the round ledger
            elif inc is not None:
                dev = dev_host = pad_device_round(inc.device_round())
            else:
                dev = dev_host = pad_device_round(prep_device_round(snap))
            t_solve = _t.monotonic()
            # Round observatory (observe/ledger.py): one ledger spans the
            # whole solve — the resident sync or the upload, the result
            # readback — so every round reports its host<->device cost
            # end to end.
            sync_s = 0.0
            with _tledger.round_ledger() as _led:
                if resident is not None:
                    t_sync = _t.monotonic()
                    dev = resident.device_round(inc)
                    dev_host = resident.host_round()
                    sync_s = _t.monotonic() - t_sync
                if rung.kind == "mesh":
                    # The sharded solve takes no budget: it is enforced
                    # between pools only (chunked pass 1 is single-device).
                    import torch

                    from ..parallel.mesh import pad_nodes

                    run = self._resolve_sharded_run(
                        str(getattr(snap.config, "solve_kernel_path", "lax")
                            or "lax")
                    )
                    out = run(pad_nodes(dev, self._mesh_size))
                    # CUDA launches are asynchronous: wait for the shards'
                    # cards so the histogram records solve wall clock.
                    for d in dict.fromkeys(run.devices):
                        if d.type == "cuda":
                            torch.cuda.synchronize(d)
                    out = {k: np.asarray(v) for k, v in out.items()}
                    _tledger.note_down(out, site="mesh.d2h")
                    out["truncated"] = False
                    shape = run.mesh_shape
                    hosts, chips = shape if len(shape) == 2 else (1, shape[0])
                    solver_info = {
                        "backend": "kernel",
                        "mesh": f"{hosts}x{chips}",
                        "kernel": getattr(dev, "kernel_path", "lax"),
                    }
                else:
                    if rung.kind == "hotwindow":
                        # Degraded retry on a different solve program: the
                        # forced small window runs pass 1 on the "lax"
                        # path over a compacted round.
                        window = int(rung.param or 64)
                        window_min_slots = 0
                        chunk_loops = 1
                    else:
                        window = snap.config.hot_window_slots or None
                        window_min_slots = snap.config.hot_window_min_slots
                        chunk_loops = 1
                    # Solve-kernel selection (ops/kernels.py): the RUNG
                    # decides the path — a "local:cuda" rung runs the
                    # hand-written kernels while plain LOCAL and
                    # hotwindow rungs (on the CPU's ladder only) take
                    # the "lax" path.
                    want = (
                        str(rung.param)
                        if rung.kind == "local" and rung.param
                        else "lax"
                    )
                    host = dev_host if resident is not None else None
                    if getattr(dev, "kernel_path", "lax") != want:
                        dev = _dcls.replace(dev, kernel_path=want)
                        if host is not None:
                            host = _dcls.replace(host, kernel_path=want)
                    out = solve_round(
                        dev,
                        budget_s=budget_s,
                        chunk_loops=chunk_loops,
                        window=window,
                        window_min_slots=window_min_slots,
                        readback_rows=snap.num_jobs,
                        device=self.device,
                        host=host,
                    )
                    solver_info = {
                        "backend": "kernel",
                        "mesh": None,
                        "rung": rung.label,
                        "kernel": want,
                        "window": int(window or 0),
                        "budget": bool(budget_s),
                        "resident": resident is not None,
                    }
            truncated = bool(out.get("truncated", False))
            # Materialize the decisions on host: the admission firewall,
            # fault injection, and every downstream consumer read numpy
            # views.
            out = {
                k: (v if k in ("profile", "truncated") else np.asarray(v))
                for k, v in out.items()
            }
            if chaos is not None:
                chaos.corrupt(rung.label, out)
            # Fold the round's cost accounting into one profile view:
            # the scheduler-round ledger (covers the resident sync or
            # upload AND the solve's own books). The same numbers land
            # on the round span (_emit_solve_spans).
            transfer = _led.as_dict()
            cost_profile = dict(out.get("profile") or {})
            cost_profile["transfer"] = transfer
            # Fairness observatory (observe/fairness.py): the canonical
            # per-round share ledger + preemption attribution, computed
            # host-side from the EXACT padded DeviceRound the kernel
            # consumed and its decision stream. Advisory: a ledger
            # failure must never fail the round.
            fairness_block = None
            if fairness:
                try:
                    from ..observe.fairness import ledger_from_device_round

                    fairness_block = ledger_from_device_round(
                        dev_host, out, snap.num_jobs, snap.num_queues
                    )
                except Exception as e:  # noqa: BLE001 - advisory path
                    self.log_.with_fields(pool=snap.pool).error(
                        "fairness ledger failed: %r", e
                    )
            if validate:
                # Round admission firewall (solver/validate.py): cheap
                # host-side invariants against the same padded
                # DeviceRound the solve consumed. A violation rejects
                # the round BEFORE the round span observes it —
                # nothing downstream ever sees a poisoned decision
                # stream. (The JAX package also quarantines the round
                # as a postmortem bundle; the flight recorder that
                # writes one waits for ROADMAP A7.7.)
                from ..solver.validate import RoundRejected, validate_round

                t_v = _t.monotonic()
                violation = validate_round(
                    out, dev=dev_host, fairness=fairness_block
                )
                cost_profile["validate_s"] = round(_t.monotonic() - t_v, 6)
                if violation is not None:
                    raise RoundRejected(violation, None)
            if "profile" in out:
                out["profile"] = cost_profile
            if not shadow:
                self._emit_solve_spans(
                    snap.pool, out.get("profile"), _t.monotonic() - t_solve,
                    transfer=transfer,
                )
            J, Q = snap.num_jobs, snap.num_queues
            return {
                "assigned_node": out["assigned_node"][:J],
                "scheduled_priority": out["scheduled_priority"][:J],
                "scheduled_mask": out["scheduled_mask"][:J],
                "preempted_mask": out["preempted_mask"][:J],
                "fair_share": out["fair_share"][:Q],
                "demand_capped_fair_share": out["demand_capped_fair_share"][:Q],
                "uncapped_fair_share": out["uncapped_fair_share"][:Q],
                "fairness": fairness_block,
                "unschedulable_reason": None,
                "termination_reason": "round_truncated" if truncated else "",
                "truncated": truncated,
                "num_loops": int(out["num_loops"]),
                "spot_price": (
                    None
                    if np.isnan(float(out["spot_price"]))
                    else float(out["spot_price"])
                ),
                # The port's addition: the resident sync's share of the
                # attempt (read by last_cycle_stats).
                "sync_s": sync_s,
            }
        import time as _t

        from ..solver.reference import ReferenceSolver

        t_solve = _t.monotonic()
        res = ReferenceSolver(snap).solve(budget_s=budget_s)
        result = {
            "spot_price": res.spot_price,
            "assigned_node": res.assigned_node,
            "scheduled_priority": res.scheduled_priority,
            "scheduled_mask": res.scheduled_mask,
            "preempted_mask": res.preempted_mask,
            "fair_share": res.fair_share,
            "demand_capped_fair_share": res.demand_capped_fair_share,
            "uncapped_fair_share": res.uncapped_fair_share,
            "fairness": None,
            "unschedulable_reason": res.unschedulable_reason,
            "termination_reason": res.termination_reason,
            "truncated": res.truncated,
            "num_loops": res.num_loops,
        }
        if chaos is not None:
            chaos.corrupt(rung.label, result)
        if validate:
            # No DeviceRound in hand on the oracle path: validate the
            # decision-intrinsic invariants (NaN/inf, node bounds,
            # double-bind, preemption victims) straight off the
            # snapshot; capacity/gang checks need the padded arrays and
            # run only on kernel rungs.
            from ..solver.validate import RoundRejected, validate_round

            violation = validate_round(
                result,
                num_jobs=snap.num_jobs,
                num_nodes=len(snap.node_ids),
                job_is_running=snap.job_is_running,
            )
            if violation is not None:
                raise RoundRejected(violation, None)
        # Oracle rounds leave result["fairness"] None: _record_round
        # computes the host-unit ledger_from_snapshot fallback for the
        # live surfaces.
        if not shadow:
            self._emit_solve_spans(snap.pool, None, _t.monotonic() - t_solve)
        return result

    def _decorate_fairness(self, snap, fairness: dict) -> dict:
        """Copy of the canonical (index-based) fairness block with names
        attached for the live surfaces: queue/node/job ids, the
        aggressor's gang identity, and the rendered preemption reason
        that JobRunPreempted events and job timelines carry."""
        from ..observe.fairness import mechanism_phrase, resolve_names

        resolved = resolve_names(
            fairness, queue_names=snap.queue_names, job_ids=snap.job_ids
        )
        active_policy = str(
            (fairness.get("ledger") or {}).get("policy") or "drf"
        )
        preemptions = []
        for p in resolved["preemptions"]:
            # Indices resolve_names could not map (e.g. aggressor_queue
            # -1 on a headroom vacation) normalize to "".
            if not isinstance(p.get("queue"), str):
                p["queue"] = ""
            if not isinstance(p.get("aggressor_queue"), str):
                p["aggressor_queue"] = ""
            p.setdefault("job_id", "")
            node = int(p.get("node", -1))
            p["node_id"] = (
                snap.node_ids[node] if 0 <= node < len(snap.node_ids) else ""
            )
            agg = int(p.get("aggressor_job", -1))
            p["aggressor_job_id"] = (
                snap.job_ids[agg] if 0 <= agg < len(snap.job_ids) else ""
            )
            p["aggressor_gang"] = (
                snap.job_gang_id[agg]
                if 0 <= agg < len(snap.job_gang_id)
                else ""
            )
            phrase = mechanism_phrase(p.get("mechanism", ""), active_policy)
            if p["aggressor_queue"]:
                who = f"queue {p['aggressor_queue']}"
                if p["aggressor_gang"]:
                    who += f" gang {p['aggressor_gang']}"
                p["reason"] = f"preempted by {who} {phrase}".strip()
            else:
                p["reason"] = (
                    f"preempted by scheduler round {phrase} "
                    "(node vacated for headroom)"
                ).strip()
            preemptions.append(p)
        return {"ledger": resolved["ledger"], "preemptions": preemptions}

    def _record_round(self, pool, snap, result, started, now=None):
        import numpy as np

        from ..solver.drf import unweighted_cost
        from .reports import QueueReport, RoundReport

        finished = _time.time()
        fairness = result.get("fairness")
        if fairness is None:
            # Defensive fallback (a ledger failure inside _solve): the
            # live surfaces still get a host-unit ledger.
            try:
                from ..observe.fairness import ledger_from_snapshot
                from ..solver import policy as fp

                fairness = ledger_from_snapshot(
                    snap, result,
                    policy_spec=fp.spec_from_config(self.config, pool),
                )
            except Exception as e:  # noqa: BLE001 - advisory path
                self.log_.with_fields(pool=pool).error(
                    "fairness ledger fallback failed: %r", e
                )
        decorated = (
            self._decorate_fairness(snap, fairness) if fairness else None
        )
        result["fairness_decorated"] = decorated
        fair_rows = (decorated or {}).get("ledger", {}).get("queues", [])
        mult = snap.drf_multipliers()
        total = snap.total_resources.astype(float)
        report = RoundReport(
            pool=pool,
            started=started,
            finished=finished,
            num_jobs=snap.num_jobs,
            num_nodes=snap.num_nodes,
            termination_reason=result.get("termination_reason", ""),
            fairness_policy=self.fairness_policy(pool),
            spot_price=result.get("spot_price"),
        )
        sched_by_q = {}
        preempt_by_q = {}
        alloc_by_q = np.zeros((snap.num_queues, snap.factory.num_resources))
        for j in range(snap.num_jobs):
            q = int(snap.job_queue[j])
            if q < 0:
                continue
            if result["scheduled_mask"][j]:
                sched_by_q[q] = sched_by_q.get(q, 0) + 1
            if result["preempted_mask"][j]:
                preempt_by_q[q] = preempt_by_q.get(q, 0) + 1
            if result["assigned_node"][j] >= 0:
                alloc_by_q[q] += snap.job_req[j]
        actual = unweighted_cost(alloc_by_q, total, mult) if snap.num_queues else []
        for q, name in enumerate(snap.queue_names):
            fr = fair_rows[q] if q < len(fair_rows) else {}
            report.queues[name] = QueueReport(
                queue=name,
                fair_share=float(result["fair_share"][q]),
                adjusted_fair_share=float(result["demand_capped_fair_share"][q]),
                actual_share=float(actual[q]),
                uncapped_fair_share=float(fr.get("uncapped", 0.0)),
                demand_share=float(fr.get("demand_share", 0.0)),
                delivered_share=float(fr.get("delivered_share", 0.0)),
                fairness_regret=float(fr.get("regret", 0.0)),
                starved=bool(fr.get("starved", False)),
                scheduled_jobs=sched_by_q.get(q, 0),
                preempted_jobs=preempt_by_q.get(q, 0),
            )
        reasons = result.get("unschedulable_reason")
        if reasons is not None:
            report.job_reasons = {
                snap.job_ids[j]: reasons[j]
                for j in range(snap.num_jobs)
                if reasons[j]
            }
            # Job-journey ledger: fold this round's verdicts into each
            # job's bounded reason aggregates (the history reports.py
            # used to discard every round), and count them by reason.
            # Stamped with the CYCLE clock (virtual in the simulator),
            # the same time base as the transition entries — wall clock
            # here would misorder sim journeys.
            self.timeline.note_round_reasons(
                pool, now if now is not None else finished,
                report.job_reasons,
            )
            # Per-queue unschedulable-reason histogram (queue report depth).
            for j in range(snap.num_jobs):
                if not reasons[j]:
                    continue
                q = int(snap.job_queue[j])
                if q < 0:
                    continue
                qr = report.queues.get(snap.queue_names[q])
                if qr is not None:
                    qr.top_reasons[reasons[j]] = (
                        qr.top_reasons.get(reasons[j], 0) + 1
                    )
        # Per-gang contexts (GangSchedulingContext detail, context/gang.go):
        # multi-member gangs get an all-or-nothing outcome line. Singletons
        # occupy the leading gang indices (snapshot/round.py), so select
        # multi-member gangs by size, bounded to 1000 — report strings,
        # not a query surface.
        offsets = snap.gang_member_offsets
        sizes = np.diff(offsets)
        for g in np.flatnonzero(sizes >= 2)[:1000]:
            members = snap.gang_members[offsets[g] : offsets[g + 1]]
            j0 = int(members[0])
            gang_id = snap.job_gang_id[j0]
            q0 = int(snap.job_queue[j0])
            if q0 < 0:
                continue
            queue = snap.queue_names[q0]
            placed = int(result["scheduled_mask"][members].sum())
            if placed == len(members):
                nodes = {
                    snap.node_ids[int(result["assigned_node"][int(m)])]
                    for m in members
                }
                ctx = (
                    f"scheduled {placed}/{len(members)} "
                    f"across {len(nodes)} nodes"
                )
            elif placed == 0:
                reason = ""
                reasons = result.get("unschedulable_reason")
                if reasons is not None:
                    reason = reasons[j0] or ""
                ctx = "not scheduled" + (f": {reason}" if reason else "")
            else:  # pragma: no cover - atomicity violation surfaced loudly
                ctx = f"PARTIAL {placed}/{len(members)} (gang atomicity bug)"
            report.gang_contexts[(queue, gang_id)] = ctx
        # Per-job success contexts: bounded by the burst cap, so this stays
        # cheap even in 1M-job rounds (the reference's jctx detail,
        # reports/repository.go job reports).
        for j in np.flatnonzero(result["scheduled_mask"]):
            report.job_contexts[snap.job_ids[int(j)]] = (
                f"scheduled: pool={pool} "
                f"node={snap.node_ids[int(result['assigned_node'][int(j)])]} "
                f"priority={int(result['scheduled_priority'][int(j)])}"
            )
        self.reports.record(report)

        if decorated is not None:
            # Fairness observatory: starvation streaks + multiwindow
            # alert, the scheduler_fairness_* families, attribution
            # counters, and the /api/fairness document — all on the
            # cycle clock (virtual in sims).
            self.fairness.observe_round(
                pool,
                decorated,
                now=now if now is not None else finished,
            )


def from_reference_checkpoint(cursor: int, state: dict):
    """A JAX-package `SchedulerService.checkpoint_state()` as the
    `checkpoint=` this service loads: the job database's `Job`,
    `JobRun` and `JobSpec` records, the enums and the event-sourced
    settings, rebuilt as the port's (utils/carry.py). The cursor is the
    reference log's offset; pair it with that log's entries carried by
    `events.log.from_reference_events`, at the same offsets."""
    from ..utils.carry import to_port

    return cursor, to_port(state)
