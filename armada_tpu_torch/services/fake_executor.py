"""Fake executor: simulated worker cluster with zero Kubernetes.

The reference's fakeexecutor (internal/executor/fake,
cmd/fakeexecutor/main.go:31) runs the full executor wiring against a
simulated cluster context where pods "run" as timed sleeps — enabling whole
control-plane runs with no kube-api. Same here: a FakeExecutor owns N
synthetic nodes, consumes leases from the scheduler, walks each run through
leased -> running -> succeeded on a (virtual or real) clock, and reports
state back through the event log.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace

from ..core.types import NodeSpec
from ..events import (
    EventSequence,
    JobRunErrors,
    JobRunPending,
    JobRunRunning,
    JobRunSucceeded,
    JobSucceeded,
)
from .podchecks import Action, PodChecker, PodIssueHandler
from .scheduler import ExecutorHeartbeat
from .utilisation import ALL_PRIORITIES, UtilisationReporter


def make_nodes(
    executor: str,
    count: int = 500,
    pool: str = "default",
    cpu: str = "8",
    memory: str = "128Gi",
    labels: dict | None = None,
    taints=(),
    extra_resources: dict | None = None,
) -> list[NodeSpec]:
    """Default shape mirrors the reference fake executor: 500 x 8 cpu /
    128Gi (internal/executor/fake/context/context.go:40-49);
    extra_resources adds e.g. {"nvidia.com/gpu": "8"} for GPU nodes."""
    return [
        NodeSpec(
            id=f"{executor}-node-{i:05d}",
            name=f"{executor}-node-{i:05d}",
            executor=executor,
            pool=pool,
            labels=dict(labels or {}),
            taints=tuple(taints),
            total_resources={
                "cpu": cpu,
                "memory": memory,
                **(extra_resources or {}),
            },
        )
        for i in range(count)
    ]


# Jobs annotated with this fail once they start, with the annotation value
# as the error message — the testsuite's categorization cases use it (the
# reference's testcases run containers that exit non-zero).
FAIL_SIMULATION_ANNOTATION = "armadaproject.io/fail-simulation"


@dataclass
class _ActiveRun:
    run_id: str
    job_id: str
    queue: str
    jobset: str
    started: float
    finishes_at: float
    running_reported: bool = False


class FakeExecutor:
    """One simulated cluster; drive with tick(now)."""

    def __init__(
        self,
        name: str,
        log,
        scheduler,
        nodes: list[NodeSpec] | None = None,
        pool: str = "default",
        runtime_for=lambda job_id: 30.0,
        startup_delay: float = 0.0,
        pod_checker: PodChecker | None = None,
        issue_for=None,
        non_framework_usage: dict | None = None,
        usage_fn=None,
        fault_plan=None,
    ):
        self.name = name
        self.log = log
        self.scheduler = scheduler
        self.pool = pool
        # Deterministic fault injection (services/chaos.py): crash/hang
        # windows silence the executor; lease faults defer lease pickup.
        self.fault_plan = fault_plan
        self._crashed = False
        self._partitioned = False
        # Anti-entropy resolution counts from healed partitions
        # (zombie/duplicate/orphaned), for soak observability.
        self.anti_entropy: dict[str, int] = {}
        self.nodes = nodes if nodes is not None else make_nodes(name, pool=pool)
        self.runtime_for = runtime_for
        self.startup_delay = startup_delay
        self.active: dict[str, _ActiveRun] = {}
        self._seen_runs: set[str] = set()
        # Pod-issue machinery (podchecks + pod_issue_handler.go):
        # `issue_for(job_id)` simulates a faulty pod, returning a record
        # like {"events": [{"type": "Warning", "message": ...}],
        # "blocked": True} — blocked pods never reach running and are
        # eventually actioned by the checker.
        self.issue_handler = PodIssueHandler(pod_checker)
        self.issue_for = issue_for or (lambda job_id: None)
        self._issues: dict[str, dict] = {}  # run_id -> pod record
        # Utilisation (executor/utilisation/): framework usage sampled per
        # running pod; non-framework usage reported as unallocatable at
        # every priority row.
        self.utilisation = UtilisationReporter(usage_fn=usage_fn)
        if non_framework_usage:
            self.nodes = [
                replace(
                    n,
                    unallocatable_by_priority={
                        **n.unallocatable_by_priority,
                        ALL_PRIORITIES: non_framework_usage[n.id],
                    },
                )
                if n.id in non_framework_usage
                else n
                for n in self.nodes
            ]

    def heartbeat(self, now: float):
        """Report node state (the LeaseRequest half of the lease loop)."""
        self.scheduler.report_executor(
            ExecutorHeartbeat(
                name=self.name, pool=self.pool, nodes=self.nodes, last_seen=now
            )
        )

    def accept_leases(self, now: float):
        """Pick up new runs assigned to this executor from the jobdb (the
        JobRunLease stream half; the scheduler wrote leases via events)."""
        txn = self.scheduler.jobdb.read_txn()
        for job in txn.leased_jobs():
            run = job.latest_run
            if run is None or run.executor != self.name:
                continue
            if run.id in self._seen_runs:
                continue
            self._seen_runs.add(run.id)
            # Pod created: leased -> pending (job-lifecycle-events.md).
            self.log.publish(
                EventSequence.of(
                    job.queue,
                    job.jobset,
                    JobRunPending(created=now, job_id=job.id, run_id=run.id),
                )
            )
            runtime = float(self.runtime_for(job.id))
            self.active[run.id] = _ActiveRun(
                run_id=run.id,
                job_id=job.id,
                queue=job.queue,
                jobset=job.jobset,
                started=now,
                finishes_at=now + self.startup_delay + runtime,
            )
            issue = self.issue_for(job.id)
            if issue:
                self._issues[run.id] = {
                    "phase": "pending",
                    "created": now,
                    "last_change": now,
                    "node": run.node_id,
                    "spec": {"requests": dict(job.spec.requests)},
                    **issue,
                }

    # ---- binoculars surface (logs + cordon) ----

    def get_logs(self, job_id: str, tail_lines: int = 100) -> list[str]:
        """Synthesized pod logs for runs this executor has seen."""
        for run in list(self.active.values()):
            if run.job_id == job_id:
                lines = [
                    f"[{self.name}] starting job {job_id} (run {run.run_id})",
                    f"[{self.name}] job {job_id} running since t={run.started:.1f}",
                ]
                return lines[-tail_lines:]
        return [f"[{self.name}] no active run for {job_id} (finished or pending)"]

    def cordon(self, node_id: str, cordoned: bool) -> bool:
        """Mark a node unschedulable; reflected in the next heartbeat."""
        from dataclasses import replace

        for i, node in enumerate(self.nodes):
            if node.id == node_id:
                self.nodes[i] = replace(node, unschedulable=cordoned)
                return True
        return False

    def _chaos_gate(self, now: float) -> bool:
        """Apply the fault plan; returns True when this tick is silenced
        (crash, hang, or partition window active)."""
        plan = self.fault_plan
        if plan is None:
            return False
        if plan.active("executor_crash", self.name, now) is not None:
            if not self._crashed:
                # Crash start: all local pod state is lost; leases must be
                # re-accepted (or re-leased) after recovery.
                self.active.clear()
                self._issues.clear()
                self._seen_runs.clear()
                self._crashed = True
            return True
        if plan.active("network_partition", self.name, now) is not None:
            # Severed wire, virtual-clock edition: no heartbeat, no lease
            # pickup, no reports — but unlike a crash, pods keep running
            # locally. Runs finishing inside the window hold their
            # terminal report until the heal (the simulator's clock never
            # pins on past-due finish times, so time still advances).
            self._partitioned = True
            return True
        if self._partitioned:
            # Heal: anti-entropy BEFORE any report leaves this executor —
            # the in-process image of the agent's ExecutorSync. Zombie
            # and duplicate pods (runs the scheduler expired/reassigned
            # while we were dark) are torn down silently; their outcomes
            # must never land. Server-live runs we no longer hold are
            # reported missing (the orphan side).
            self._partitioned = False
            self._anti_entropy(now)
        if self._crashed:
            # First tick after the crash window: the agent's missing-pod
            # reconciliation — runs the jobdb still shows on this executor
            # have no pod here; report them lost so the scheduler retries.
            self._crashed = False
            txn = self.scheduler.jobdb.read_txn()
            for job in txn.leased_jobs():
                run = job.latest_run
                if run is None or run.executor != self.name:
                    continue
                self._seen_runs.add(run.id)  # never re-adopt a dead run
                self.log.publish(
                    EventSequence.of(
                        job.queue,
                        job.jobset,
                        JobRunErrors(
                            created=now,
                            job_id=job.id,
                            run_id=run.id,
                            error=(
                                "pod missing on executor "
                                "(crash recovery reconciliation)"
                            ),
                            retryable=True,
                        ),
                    )
                )
        return plan.active("executor_hang", self.name, now) is not None

    def _anti_entropy(self, now: float):
        """Post-partition full-state reconciliation against the jobdb
        (services/grpc_api.py _executor_sync semantics, in-process):

          zombie     job terminal, or requeued after lease expiry — the
                     local pod dies silently; its outcome must not land
          duplicate  the run was superseded by a newer run (requeue +
                     re-lease won) — the old pod dies; one attempt lives
          orphaned   the jobdb holds a live run here that this executor
                     lost — reported failed-retryable (requeue path)
        """
        from ..jobdb import JobState

        txn = self.scheduler.jobdb.read_txn()
        for run in list(self.active.values()):
            job = txn.get(run.job_id)
            latest = job.latest_run if job is not None else None
            if job is None or job.state.terminal or job.state == JobState.QUEUED:
                kind = "zombie"
            elif (
                latest is None
                or latest.id != run.run_id
                or latest.executor != self.name
            ):
                kind = "duplicate"
            else:
                continue  # still ours: keep running, report late events
            self.active.pop(run.run_id, None)
            self._issues.pop(run.run_id, None)
            self.anti_entropy[kind] = self.anti_entropy.get(kind, 0) + 1
        for job in txn.jobs_for_executor(self.name):
            run = job.latest_run
            if (
                run is None
                or run.id in self.active
                or job.state not in (JobState.PENDING, JobState.RUNNING)
            ):
                # LEASED runs re-send through accept_leases; only runs
                # the server believes STARTED here and we lost are
                # orphans.
                continue
            self._seen_runs.add(run.id)  # never re-adopt a dead run
            self.anti_entropy["orphaned"] = (
                self.anti_entropy.get("orphaned", 0) + 1
            )
            self.log.publish(
                EventSequence.of(
                    job.queue,
                    job.jobset,
                    JobRunErrors(
                        created=now,
                        job_id=job.id,
                        run_id=run.id,
                        error=(
                            "pod missing on executor after partition "
                            "(anti-entropy reconciliation)"
                        ),
                        retryable=True,
                    ),
                )
            )

    def tick(self, now: float):
        """Advance pod lifecycle; emit state-transition events."""
        if self._chaos_gate(now):
            return
        self.heartbeat(now)
        lease_fault = self.fault_plan is not None and (
            self.fault_plan.active("lease_slow", self.name, now) is not None
            or self.fault_plan.active("lease_timeout", self.name, now)
            is not None
        )
        if not lease_fault:
            # Slow/timed-out lease exchanges defer pickup to a later tick
            # (leases stay unacked; the server re-sends — at-least-once).
            self.accept_leases(now)
        self._check_pod_issues(now)
        txn = self.scheduler.jobdb.read_txn()
        from ..jobdb.jobdb import RunState as _RS

        for run in list(self.active.values()):
            job = txn.get(run.job_id)
            latest = job.latest_run if job is not None else None
            if (
                job is None
                or job.state.terminal
                # Our run died while the JOB lives on: a drain's
                # preempt-requeue (run PREEMPTED, job back QUEUED) or a
                # supersession — the pod must be torn down here exactly
                # like the real agent kills cancelled pods, or a
                # requeued job would run twice.
                or latest is None
                or latest.id != run.run_id
                or latest.state
                not in (_RS.LEASED, _RS.PENDING, _RS.RUNNING)
            ):
                self.active.pop(run.run_id, None)
                self._issues.pop(run.run_id, None)
                continue
            if run.run_id in self._issues and self._issues[run.run_id].get(
                "blocked"
            ):
                continue  # faulty pod: never progresses
            if not run.running_reported and now >= run.started + self.startup_delay:
                fail_msg = job.spec.annotations.get(FAIL_SIMULATION_ANNOTATION)
                if fail_msg:
                    self.log.publish(
                        EventSequence.of(
                            run.queue,
                            run.jobset,
                            JobRunRunning(
                                created=now, job_id=run.job_id, run_id=run.run_id
                            ),
                            JobRunErrors(
                                created=now,
                                job_id=run.job_id,
                                run_id=run.run_id,
                                error=fail_msg,
                                retryable=False,
                            ),
                        )
                    )
                    self.active.pop(run.run_id, None)
                    continue
                self.log.publish(
                    EventSequence.of(
                        run.queue,
                        run.jobset,
                        JobRunRunning(created=now, job_id=run.job_id, run_id=run.run_id),
                    )
                )
                run.running_reported = True
            if now >= run.finishes_at:
                self.log.publish(
                    EventSequence.of(
                        run.queue,
                        run.jobset,
                        JobRunSucceeded(created=now, job_id=run.job_id, run_id=run.run_id),
                        JobSucceeded(created=now, job_id=run.job_id),
                    )
                )
                self.active.pop(run.run_id, None)
        self._sample_utilisation(now)

    def _check_pod_issues(self, now: float):
        """The pod-issue loop (service/pod_issue_handler.go): faulty pods
        are examined against the configured checks; RETRY reports a
        retryable run error, FAIL a fatal one; either way the pod dies."""
        if not self._issues:
            return
        for issue in self.issue_handler.examine(self._issues, now):
            run = self.active.get(issue["run_id"])
            if run is None:
                self._issues.pop(issue["run_id"], None)
                continue
            self.log.publish(
                EventSequence.of(
                    run.queue,
                    run.jobset,
                    JobRunErrors(
                        created=now,
                        job_id=run.job_id,
                        run_id=run.run_id,
                        error=f"pod issue: {issue['message']}",
                        retryable=issue["retryable"],
                        debug=json.dumps(
                            {
                                "running_reported": run.running_reported,
                                "started": run.started,
                                "age_s": round(now - run.started, 3),
                            },
                            sort_keys=True,
                        ),
                    ),
                )
            )
            self.active.pop(run.run_id, None)
            self._issues.pop(run.run_id, None)

    def _sample_utilisation(self, now: float):
        """Feed the utilisation reporter from running pods."""
        pods = {}
        txn = self.scheduler.jobdb.read_txn()
        for run in self.active.values():
            job = txn.get(run.job_id)
            if job is None:
                continue
            pods[run.run_id] = {
                "phase": "running" if run.running_reported else "pending",
                "node": job.latest_run.node_id if job.latest_run else "",
                "spec": {"requests": dict(job.spec.requests)},
            }
        self.utilisation.sample(pods)

    def usage_by_node(self) -> dict:
        return self.utilisation.by_node()
