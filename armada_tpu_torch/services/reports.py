"""Scheduling reports: the most recent round context per queue and job.

Equivalent of internal/scheduler/reports/: the scheduler
stores each round's outcome (per-queue shares/allocations, per-job
unschedulable reasons), and armadactl-equivalent tooling renders them. The
leader-proxying of the reference is unnecessary in-process; the gRPC layer
can forward to the leader when multi-replica deployments arrive.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field


@dataclass
class QueueReport:
    queue: str
    fair_share: float = 0.0
    adjusted_fair_share: float = 0.0
    actual_share: float = 0.0
    # Fairness observatory (armada_tpu/observe/fairness.py): the full
    # fair-share triple plus the round's outcome — demand share,
    # delivered dominant share, regret (entitlement - delivered, >= 0)
    # and whether the queue is starved (below entitlement with
    # unsatisfied demand).
    uncapped_fair_share: float = 0.0
    demand_share: float = 0.0
    delivered_share: float = 0.0
    fairness_regret: float = 0.0
    starved: bool = False
    scheduled_jobs: int = 0
    preempted_jobs: int = 0
    # Market pools: value placed this round vs the single-mega-node
    # theoretical maximum (idealised_value.go:23 — the expectation gap).
    idealised_value: float = 0.0
    realised_value: float = 0.0
    # Unschedulable-reason histogram for this queue's jobs in the round
    # (the reference's queue report surfaces per-job context samples;
    # an aggregated view scales to 1M-job rounds).
    top_reasons: dict = field(default_factory=dict)  # reason -> count


@dataclass
class RoundReport:
    pool: str
    started: float
    finished: float
    num_jobs: int
    num_nodes: int
    termination_reason: str = ""
    # Active fairness policy the round solved under (solver/policy.py) —
    # the objective every share/regret figure below is measured against.
    fairness_policy: str = "drf"
    spot_price: float | None = None  # market mode
    queues: dict = field(default_factory=dict)  # queue -> QueueReport
    job_reasons: dict = field(default_factory=dict)  # job_id -> reason
    # Per-job success context (jctx detail: node + priority), bounded by
    # the round's scheduling burst.
    job_contexts: dict = field(default_factory=dict)  # job_id -> context str
    # Market mode: indicative gang prices by configured shape name
    # (solver.pricer.GangPricingResult per shape).
    indicative_prices: dict = field(default_factory=dict)
    # Per-gang outcomes (the reference's GangSchedulingContext detail:
    # context/gang.go): (queue, gang_id) -> context string. Bounded.
    gang_contexts: dict = field(default_factory=dict)

    def report_string(self) -> str:
        lines = [
            f"pool: {self.pool}",
            f"duration: {self.finished - self.started:.3f}s",
            f"jobs considered: {self.num_jobs}, nodes: {self.num_nodes}",
            f"termination: {self.termination_reason}",
            f"fairness policy: {self.fairness_policy or 'drf'}",
        ]
        if self.spot_price is not None:
            lines.append(f"spot price: {self.spot_price}")
        for name in sorted(self.indicative_prices):
            r = self.indicative_prices[name]
            if not r.evaluated:
                detail = "not evaluated (pricing deadline)"
            elif r.schedulable:
                detail = f"price={r.price}"
            else:
                detail = f"unschedulable: {r.unschedulable_reason}"
            lines.append(f"  indicative gang {name}: {detail}")
        for (queue, gang_id), ctx in sorted(self.gang_contexts.items())[:20]:
            lines.append(f"  gang {gang_id} (queue {queue}): {ctx}")
        for q in sorted(self.queues):
            r = self.queues[q]
            value = (
                f" idealisedValue={r.idealised_value:.4f}"
                f" realisedValue={r.realised_value:.4f}"
                if r.idealised_value or r.realised_value
                else ""
            )
            lines.append(
                f"  queue {q}: fairShare={r.fair_share:.4f} "
                f"adjustedFairShare={r.adjusted_fair_share:.4f} "
                f"uncappedFairShare={r.uncapped_fair_share:.4f} "
                f"demandShare={r.demand_share:.4f} "
                f"actualShare={r.actual_share:.4f} "
                f"regret={r.fairness_regret:.4f}"
                + (" STARVED" if r.starved else "")
                + f" scheduled={r.scheduled_jobs} preempted={r.preempted_jobs}"
                + value
            )
        return "\n".join(lines)


class SchedulingReportsRepository:
    """Most-recent report per pool, per queue, per job
    (reports/repository.go:18)."""

    def __init__(self, retained_jobs: int = 10_000):
        import threading

        self.by_pool: dict[str, RoundReport] = {}
        self._job_reports: dict[str, tuple[float, str]] = {}
        self._retained = retained_jobs
        # Written by the scheduler thread, read from gRPC worker threads.
        self._lock = threading.Lock()

    def record(self, report: RoundReport):
        with self._lock:
            self.by_pool[report.pool] = report
            for job_id, reason in report.job_reasons.items():
                self._job_reports[job_id] = (report.finished, reason)
            for job_id, context in report.job_contexts.items():
                self._job_reports[job_id] = (report.finished, context)
            if len(self._job_reports) > self._retained:
                oldest = sorted(self._job_reports.items(), key=lambda kv: kv[1][0])
                for job_id, _ in oldest[: len(oldest) // 2]:
                    del self._job_reports[job_id]

    def latest_reports(self) -> dict:
        """Locked snapshot of the per-pool reports for external readers
        (the HTTP/gRPC threads must never iterate by_pool unlocked)."""
        with self._lock:
            return dict(self.by_pool)

    def queue_report(self, queue: str) -> str:
        with self._lock:
            pools = dict(self.by_pool)
        parts = []
        for pool, report in sorted(pools.items()):
            if queue in report.queues:
                r = report.queues[queue]
                parts.append(
                    f"pool {pool}: fairShare={r.fair_share:.4f} "
                    f"adjustedFairShare={r.adjusted_fair_share:.4f} "
                    f"actualShare={r.actual_share:.4f} "
                    f"scheduled={r.scheduled_jobs} preempted={r.preempted_jobs}"
                )
                for reason, count in sorted(
                    r.top_reasons.items(), key=lambda kv: -kv[1]
                )[:5]:
                    parts.append(f"  {count} jobs: {reason}")
                for (gq, gang_id), ctx in sorted(
                    report.gang_contexts.items()
                ):
                    if gq == queue:
                        parts.append(f"  gang {gang_id}: {ctx}")
        return "\n".join(parts) or f"no reports for queue {queue}"

    def job_report(self, job_id: str) -> str:
        with self._lock:
            hit = self._job_reports.get(job_id)
        if hit is None:
            return f"no report for job {job_id}"
        _, reason = hit
        return reason or "scheduled"

    def scheduling_report(self) -> str:
        with self._lock:
            pools = dict(self.by_pool)
        return "\n\n".join(
            pools[pool].report_string() for pool in sorted(pools)
        ) or "no scheduling rounds recorded"
