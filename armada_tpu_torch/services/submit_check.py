"""SubmitChecker: answers "could this job ever be scheduled?".

Mirrors the reference's internal/scheduler/submitcheck.go:73-289: per-executor
node snapshots refreshed each cycle; a submitted gang is checked against
every executor's empty-cluster state (static feasibility + capacity at the
job's priority), gang-aware; results cached by scheduling key. Rejecting
never-schedulable jobs at submission keeps them out of the queues.

Here the check runs the real snapshot + oracle node-selection on an
empty-of-queued copy of each executor's nodes, so checker semantics can
never drift from scheduler semantics.

This is the port's copy of the JAX package's services/submit_check.py,
over the port's snapshot (snapshot/round.py) and host oracle
(solver/reference.py): a host-side check, no device work.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

from ..core.config import SchedulingConfig
from ..core.types import JobSpec, QueueSpec
from ..snapshot.round import build_round_snapshot
from ..solver.reference import ReferenceSolver


@dataclass
class CheckResult:
    schedulable: bool
    reason: str = ""


def feasibility_snapshot(config, pool, nodes, jobs):
    """Empty-of-queued feasibility snapshot for "could this gang EVER
    fit" checks: the jobs alone against an executor's empty nodes. The
    ONE builder both the SubmitChecker and the what-if planner's gang
    injection use (whatif/planner._injection_feasibility),
    so checker and planner semantics cannot drift."""
    jobs = [j.with_(queue=j.queue or "check") for j in jobs]
    queues = sorted({j.queue for j in jobs})
    snap = build_round_snapshot(
        config, pool, nodes, [QueueSpec(q) for q in queues], [], jobs
    )
    return snap


def static_check(config, pool, nodes, jobs) -> CheckResult:
    """Solve the feasibility snapshot with the oracle; all-or-nothing
    (gang-aware: either every job fits together or the check fails with
    the per-job reasons)."""
    snap = feasibility_snapshot(config, pool, nodes, jobs)
    res = ReferenceSolver(snap).solve()
    if res.scheduled_mask.all():
        return CheckResult(True)
    failed = [
        snap.job_ids[i]
        for i in range(snap.num_jobs)
        if not res.scheduled_mask[i]
    ]
    reasons = {
        res.unschedulable_reason[i]
        for i in range(snap.num_jobs)
        if not res.scheduled_mask[i] and res.unschedulable_reason[i]
    }
    return CheckResult(
        False,
        f"{len(failed)} job(s) unschedulable: "
        f"{'; '.join(sorted(reasons)) or 'no fit'}",
    )


class SubmitChecker:
    def __init__(
        self,
        config: SchedulingConfig,
        scheduler=None,
        cache_size: int = 4096,
        cache_ttl_s: float = 60.0,
    ):
        self.config = config
        self.scheduler = scheduler  # source of executor heartbeats
        self._cache: dict = {}
        self._cache_size = cache_size
        self._cache_ttl = cache_ttl_s
        self._cache_epoch: frozenset = frozenset()

    def _executors(self):
        if self.scheduler is None:
            return {}
        return self.scheduler.executors

    def _cordoned(self) -> frozenset:
        if self.scheduler is None:
            return frozenset()
        return frozenset(getattr(self.scheduler, "cordoned_executors", ()))

    def check(self, jobs: list[JobSpec]) -> CheckResult:
        """Gang-aware: all jobs must fit together on some single executor
        (submitcheck.go:212-289). Cordoned executors take no new work
        and are not feasibility candidates."""
        cordoned = self._cordoned()
        executors = {
            name: hb
            for name, hb in self._executors().items()
            if name not in cordoned
        }
        if not executors:
            # No (uncordoned) clusters known: accept; scheduling will wait
            # (the reference treats an empty nodeDb set the same way, and
            # a fully-cordoned fleet is transient by construction).
            return CheckResult(True)
        key = tuple(
            (
                j.queue,
                tuple(sorted(j.requests.items())),
                tuple(sorted(j.node_selector.items())),
                j.tolerations,
                j.priority_class,
            )
            for j in jobs
        )
        # Cache validity: entries expire on TTL and whenever the fleet
        # epoch changes — the executor set, its node counts, OR the
        # cordon set (the reference refreshes its snapshots every cycle,
        # submitcheck.go:100; a cordon that did not invalidate the cache
        # would keep serving verdicts for capacity that just left the
        # fleet, tests/test_torch_whatif.py runs the cordon-epoch case).
        epoch = frozenset(
            (name, len(hb.nodes)) for name, hb in executors.items()
        ) | frozenset(("cordoned", name) for name in sorted(cordoned))
        now = _time.time()
        if epoch != self._cache_epoch:
            self._cache.clear()
            self._cache_epoch = epoch
        hit = self._cache.get(key)
        if hit is not None:
            result, stamp = hit
            if now - stamp <= self._cache_ttl:
                return result
            del self._cache[key]

        reasons = []
        ok = False
        for name, hb in executors.items():
            result = self._check_on_executor(hb, jobs)
            if result.schedulable:
                ok = True
                break
            reasons.append(f"{name}: {result.reason}")
        result = CheckResult(ok, "" if ok else "; ".join(reasons))
        if len(self._cache) >= self._cache_size:
            self._cache.clear()
        self._cache[key] = (result, now)
        return result

    def _check_on_executor(self, hb, jobs: list[JobSpec]) -> CheckResult:
        return static_check(self.config, hb.pool, hb.nodes, jobs)
