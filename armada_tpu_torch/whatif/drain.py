"""Staged executor drain through the real control-plane event path.

A drain is: cordon the executor (event-sourced, no new placements) ->
wait for voluntary completion -> preempt stragglers once the deadline
passes, gang-aware (every live member of a touched gang is preempted
fleet-wide, so partial gangs are never stranded) -> done when the
executor holds no live runs. Preemptions publish
`JobRunPreempted(requeue=True, reason="drain ...")` — the run dies with
a preemption the job-trace timeline shows, the job returns to QUEUED
and reschedules off the cordoned executor on the next round.

The SAME `DrainController` runs in two places:

  - live: registered on `SchedulerService.drains` (DrainCoordinator),
    stepped once per scheduling cycle inside `_cycle_body`, its events
    published with the cycle's sequences (leader-gated);
  - shadow: attached to the what-if planner's fork rollout
    (`planner.ForkRollout`), stepped by the rollout's virtual cycles.

One code path for dry-run and execution is what makes plan/apply
parity a structural property instead of a modeling claim
(tests/test_whatif.py::test_drain_plan_apply_parity_*).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..events import EventSequence, JobRunPreempted
from ..jobdb import JobState

_LIVE = (JobState.LEASED, JobState.PENDING, JobState.RUNNING)


@dataclass
class DrainOutcome:
    """What a drain did (or is predicted to do). The parity contract:
    a dry-run's outcome must equal execution's, field for field, in a
    deterministic sim."""

    executor: str
    initial_jobs: tuple = ()
    completed: tuple = ()  # finished voluntarily before the deadline
    preempted: tuple = ()  # preempt-requeued at the deadline
    blocked: tuple = ()  # non-preemptible stragglers the drain cannot move
    landings: dict = field(default_factory=dict)  # job_id -> node re-leased to
    rounds_to_drain: int | None = None  # cycles until the executor emptied
    done: bool = False

    def to_dict(self) -> dict:
        return {
            "executor": self.executor,
            "initial_jobs": sorted(self.initial_jobs),
            "completed": sorted(self.completed),
            "preempted": sorted(self.preempted),
            "blocked": sorted(self.blocked),
            "landings": dict(sorted(self.landings.items())),
            "rounds_to_drain": self.rounds_to_drain,
            "done": self.done,
        }


class DrainController:
    """One executor's staged drain; step once per scheduling cycle."""

    def __init__(
        self,
        scheduler,
        executor: str,
        *,
        deadline_s: float | None = None,
        metrics=None,
    ):
        self.scheduler = scheduler
        self.executor = executor
        cfg = getattr(scheduler, "config", None)
        self.deadline_s = (
            float(deadline_s)
            if deadline_s is not None
            else float(getattr(cfg, "drain_deadline_s", 0.0))
        )
        self.metrics = metrics
        self.started: float | None = None
        self.rounds = 0
        self.state = "pending"  # pending -> draining -> done
        self._initial: set[str] | None = None
        self._completed: set[str] = set()
        self._preempted: set[str] = set()
        self._blocked: set[str] = set()
        self._landings: dict[str, str] = {}
        self._rounds_to_drain: int | None = None

    # -- stepping -------------------------------------------------------

    def _live_on_executor(self, txn) -> dict:
        return {
            job.id: job
            for job in txn.jobs_for_executor(self.executor)
            if job.latest_run is not None and job.state in _LIVE
        }

    def step(self, now: float) -> list[EventSequence]:
        """Advance the drain one cycle; returns event sequences for the
        cycle to publish (leader-gated with everything else)."""
        if self.state == "done":
            return []
        txn = self.scheduler.jobdb.read_txn()
        if self.started is None:
            self.started = now
            self.state = "draining"
            # Cordon first (event-sourced; idempotent no-op if already
            # cordoned): this cycle's round already skips the executor.
            self.scheduler.set_executor_cordon(self.executor, True)
        self.rounds += 1
        live = self._live_on_executor(txn)
        if self._initial is None:
            self._initial = set(live)
        # Voluntary completions: initial jobs that reached a terminal
        # success since the drain started.
        for jid in self._initial:
            if jid in self._completed or jid in self._preempted:
                continue
            job = txn.get(jid)
            if job is not None and job.state == JobState.SUCCEEDED:
                self._completed.add(jid)
                if self._metric_ok():
                    self.metrics.drain_jobs_completed.labels(
                        executor=self.executor
                    ).inc()
        # Requeue landings: preempted jobs re-leased elsewhere.
        for jid in self._preempted:
            if jid in self._landings:
                continue
            job = txn.get(jid)
            run = job.latest_run if job is not None else None
            if (
                job is not None
                and run is not None
                and job.state in _LIVE
                and run.executor != self.executor
            ):
                self._landings[jid] = run.node_id
        if not live:
            if self._rounds_to_drain is None:
                self._rounds_to_drain = self.rounds
            # Done only once every preempted job has landed (or cannot:
            # nothing queued-live left of it) — the outcome then carries
            # the full displacement map.
            pending_landing = [
                jid
                for jid in self._preempted
                if jid not in self._landings
                and (txn.get(jid) is not None
                     and not txn.get(jid).state.terminal)
            ]
            if not pending_landing:
                self.state = "done"
            return []
        if now - self.started < self.deadline_s:
            return []  # still inside the voluntary-completion window
        # Deadline passed: preempt-requeue the stragglers, gang-aware.
        return self._preempt_stragglers(txn, live, now)

    def _preempt_stragglers(self, txn, live: dict, now: float):
        by_jobset: dict[tuple, list] = {}
        handled: set[str] = set()
        for jid, job in sorted(live.items()):
            if jid in handled or jid in self._preempted:
                continue
            members = [job]
            if job.spec.gang is not None:
                # Never strand a partial gang: every live member goes,
                # wherever it runs — the whole gang reschedules together.
                members = [
                    m
                    for m in txn.gang_jobs(job.queue, job.spec.gang.id)
                    if m.state in _LIVE
                ]
            preemptible = all(
                self.scheduler.config.priority_class(
                    m.spec.priority_class
                ).preemptible
                for m in members
            )
            if not preemptible:
                for m in members:
                    handled.add(m.id)
                    self._blocked.add(m.id)
                continue
            for m in members:
                if m.id in handled or m.id in self._preempted:
                    continue
                handled.add(m.id)
                run = m.latest_run
                if run is None:
                    continue
                self._preempted.add(m.id)
                reason = f"drain {self.executor}: deadline reached"
                if run.executor != self.executor:
                    reason = (
                        f"drain {self.executor}: gang member of a "
                        "drained job"
                    )
                by_jobset.setdefault((m.queue, m.jobset), []).append(
                    JobRunPreempted(
                        created=now,
                        job_id=m.id,
                        run_id=run.id,
                        reason=reason,
                        requeue=True,
                    )
                )
                if self._metric_ok():
                    self.metrics.drain_jobs_preempted.labels(
                        executor=self.executor
                    ).inc()
        return [
            EventSequence.of(queue, jobset, *events)
            for (queue, jobset), events in sorted(by_jobset.items())
        ]

    def _metric_ok(self) -> bool:
        return (
            self.metrics is not None
            and getattr(self.metrics, "registry", None) is not None
        )

    # -- reads ----------------------------------------------------------

    def outcome(self) -> DrainOutcome:
        return DrainOutcome(
            executor=self.executor,
            initial_jobs=tuple(sorted(self._initial or ())),
            completed=tuple(sorted(self._completed)),
            preempted=tuple(sorted(self._preempted)),
            blocked=tuple(sorted(self._blocked)),
            landings=dict(self._landings),
            rounds_to_drain=self._rounds_to_drain,
            done=self.state == "done",
        )

    def status(self) -> dict:
        doc = self.outcome().to_dict()
        doc.update(
            state=self.state,
            started=self.started,
            rounds=self.rounds,
            deadline_s=self.deadline_s,
        )
        return doc


class DrainCoordinator:
    """Active drains on one scheduler; stepped by the cycle loop."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self._drains: dict[str, DrainController] = {}

    def start(
        self, executor: str, *, deadline_s: float | None = None, metrics=None
    ) -> DrainController:
        """Begin (or return the already-active) drain for an executor.
        Idempotent: repeated ExecuteDrain calls poll the same drain."""
        existing = self._drains.get(executor)
        if existing is not None and existing.state != "done":
            if deadline_s is not None:
                # An explicit new deadline re-arms the active drain (an
                # operator escalating `--deadline-s 0` must not have the
                # request silently dropped in favor of the old window).
                existing.deadline_s = float(deadline_s)
            return existing
        ctl = DrainController(
            self.scheduler,
            executor,
            deadline_s=deadline_s,
            metrics=metrics
            if metrics is not None
            else getattr(self.scheduler, "metrics", None),
        )
        self._drains[executor] = ctl
        return ctl

    def step(self, now: float) -> list[EventSequence]:
        sequences: list[EventSequence] = []
        for ctl in self._drains.values():
            sequences += ctl.step(now)
        return sequences

    def status(self, executor: str | None = None):
        if executor is not None:
            ctl = self._drains.get(executor)
            return ctl.status() if ctl is not None else None
        return {name: ctl.status() for name, ctl in self._drains.items()}

    @property
    def active(self) -> list[str]:
        return [n for n, c in self._drains.items() if c.state != "done"]
