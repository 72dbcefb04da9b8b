"""Host-side job store with batched transactions and maintained indexes.

The scheduler-facing equivalent of the reference's in-memory jobDb
(internal/scheduler/jobdb/jobdb.go:68): job and run records,
batched write transactions (read-your-writes overlay, atomic commit), and
the index set the scheduling loop needs — queued-by-queue, leased, live
runs by executor, failed-run jobs awaiting retry decisions, recently
finished (short-job penalty), gang membership, jobset membership
(jobdb.go:68-97 maintains the same families as memdb indexes).

Concurrency model: commits apply IN PLACE under a state lock — O(changes)
per commit, not O(jobs) — and every query MATERIALIZES its result under
the same lock, so callers never iterate live containers. This differs from
the reference's immutable-map MVCC: a read transaction here sees the
latest committed state at each query call rather than a frozen snapshot.
That is sufficient because the one long-lived concurrent reader (the async
scheduling runner) materializes all of its inputs up front
(services/scheduler.py _build_pool_inputs) before the background solve.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, replace


from ..core.types import JobSpec


class JobState(enum.Enum):
    QUEUED = "queued"
    LEASED = "leased"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    CANCELLED = "cancelled"
    PREEMPTED = "preempted"

    @property
    def terminal(self) -> bool:
        return self in (
            JobState.SUCCEEDED,
            JobState.FAILED,
            JobState.CANCELLED,
            JobState.PREEMPTED,
        )


_LIVE_RUN_STATES = (JobState.LEASED, JobState.PENDING, JobState.RUNNING)


class RunState(enum.Enum):
    LEASED = "leased"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    PREEMPTED = "preempted"


@dataclass(frozen=True)
class JobRun:
    """One attempt at executing a job (jobdb/job_run.go)."""

    id: str
    job_id: str
    executor: str = ""
    node_id: str = ""
    pool: str = ""
    scheduled_at_priority: int = 0
    state: RunState = RunState.LEASED
    attempt: int = 0
    leased: float = 0.0  # JobRunLeased time
    started: float = 0.0  # JobRunRunning time
    finished: float = 0.0  # terminal-event time
    # Whether a FAILED run may be retried (pod-issue checks can mark a
    # failure fatal: podchecks Action.FAIL -> retryable=False).
    retryable: bool = True


@dataclass(frozen=True)
class Job:
    """Immutable job record; updates produce new instances
    (jobdb/job.go:23-83)."""

    spec: JobSpec
    state: JobState = JobState.QUEUED
    priority: int = 0  # current (may be reprioritised)
    runs: tuple = ()
    serial: int = 0
    submitted: float = 0.0
    # Nodes where previous attempts failed (anti-affinity on retry,
    # scheduler.go:589-636).
    failed_nodes: tuple = ()
    error: str = ""
    error_category: str = ""

    @property
    def id(self) -> str:
        return self.spec.id

    @property
    def queue(self) -> str:
        return self.spec.queue

    @property
    def jobset(self) -> str:
        return self.spec.jobset

    @property
    def latest_run(self) -> JobRun | None:
        return self.runs[-1] if self.runs else None

    @property
    def num_attempts(self) -> int:
        return len(self.runs)

    def with_(self, **kw) -> "Job":
        return replace(self, **kw)


class JobDbTxn:
    """A read-your-writes overlay over the store. Commit is atomic;
    conflicting commits are prevented by the store's single-writer lock
    (the reference serializes write txns the same way, jobdb.go:362)."""

    def __init__(self, db: "JobDb", writable: bool):
        self._db = db
        self._writable = writable
        self._writes: dict[str, Job | None] = {}  # id -> job (None = delete)
        self._committed = False

    def get(self, job_id: str) -> Job | None:
        if job_id in self._writes:
            return self._writes[job_id]
        with self._db._state_lock:
            return self._db._jobs.get(job_id)

    def upsert(self, *jobs: Job):
        assert self._writable, "read-only transaction"
        for job in jobs:
            self._writes[job.id] = job

    def delete(self, job_id: str):
        assert self._writable, "read-only transaction"
        self._writes[job_id] = None

    def _merge(self, base: list[Job], pred) -> list[Job]:
        """Overlay-correct view: base minus overwritten ids, plus overlay
        jobs matching the predicate."""
        if not self._writes:
            return base
        out = [j for j in base if j.id not in self._writes]
        out.extend(j for j in self._writes.values() if j is not None and pred(j))
        return out

    def all_jobs(self) -> list[Job]:
        with self._db._state_lock:
            base = list(self._db._jobs.values())
        return self._merge(base, lambda j: True)

    def queued_jobs(self, queue: str | None = None, sort: bool = True) -> list[Job]:
        """Queued jobs, optionally in fair-share order: (priority,
        submitted, id) — jobdb.go:27-31 FairShareOrder. The snapshot
        builder re-derives the order vectorized, so it passes sort=False."""
        db = self._db
        with db._state_lock:
            if queue is None:
                base = [
                    j for d in db._queued_by_queue.values() for j in d.values()
                ]
            else:
                base = list(db._queued_by_queue.get(queue, {}).values())
        jobs = self._merge(
            base,
            lambda j: j.state == JobState.QUEUED
            and (queue is None or j.queue == queue),
        )
        if sort:
            jobs.sort(key=lambda j: (j.priority, j.submitted, j.id))
        return jobs

    def leased_jobs(self) -> list[Job]:
        with self._db._state_lock:
            base = list(self._db._leased.values())
        return self._merge(base, lambda j: j.state in _LIVE_RUN_STATES)

    def jobs_for_executor(self, executor: str) -> list[Job]:
        """Jobs whose latest run lives on this executor (live states)."""
        with self._db._state_lock:
            base = list(self._db._by_executor.get(executor, {}).values())
        return self._merge(
            base,
            lambda j: j.state in _LIVE_RUN_STATES
            and j.latest_run is not None
            and j.latest_run.executor == executor,
        )

    def jobs_for_jobset(self, queue: str, jobset: str) -> list[Job]:
        """Non-terminal members of one (queue, jobset)."""
        with self._db._state_lock:
            base = list(self._db._by_jobset.get((queue, jobset), {}).values())
        return self._merge(
            base,
            lambda j: not j.state.terminal
            and j.queue == queue
            and j.jobset == jobset,
        )

    def failed_run_jobs(self) -> list[Job]:
        """Live-state jobs whose latest run FAILED — awaiting the
        requeue-or-fail decision (scheduler.go:589-636)."""
        with self._db._state_lock:
            base = list(self._db._failed_pending.values())
        return self._merge(
            base,
            lambda j: j.state in _LIVE_RUN_STATES
            and j.latest_run is not None
            and j.latest_run.state == RunState.FAILED,
        )

    def finished_since(self, cutoff: float) -> list[Job]:
        """Terminal jobs with a run that finished at/after `cutoff` (the
        short-job-penalty candidate set). Older entries are pruned from the
        candidate index as a side effect — amortized O(changes)."""
        db = self._db
        with db._state_lock:
            drop = [
                jid
                for jid, j in db._finished_recent.items()
                if j.latest_run is None or j.latest_run.finished < cutoff
            ]
            for jid in drop:
                del db._finished_recent[jid]
            base = list(db._finished_recent.values())
        return self._merge(
            base,
            lambda j: j.state.terminal
            and j.latest_run is not None
            and j.latest_run.finished >= cutoff,
        )

    def job_for_any_run(self, run_id: str) -> Job | None:
        """The job owning this run id at ANY attempt (latest or
        superseded) — the anti-entropy sync classifies a healed
        executor's pods with it: a superseded run resolves to its job
        (duplicate) instead of reading as unknown (zombie)."""
        db = self._db
        for j in self._writes.values():
            if j is not None and any(r.id == run_id for r in j.runs):
                return j
        with db._state_lock:
            jid = db._by_any_run.get(run_id)
            base = db._jobs.get(jid) if jid is not None else None
        if base is not None and base.id in self._writes:
            return self._writes[base.id]
        return base

    def job_for_run(self, run_id: str) -> Job | None:
        """The job whose LATEST run has this id."""
        db = self._db
        with db._state_lock:
            jid = db._by_run.get(run_id)
            base = db._jobs.get(jid) if jid is not None else None
        for j in self._writes.values():
            if (
                j is not None
                and j.latest_run is not None
                and j.latest_run.id == run_id
            ):
                return j
        if base is not None and base.id in self._writes:
            return self._writes[base.id]
        return base

    def gang_jobs(self, queue: str, gang_id: str) -> list[Job]:
        with self._db._state_lock:
            base = list(self._db._gangs.get((queue, gang_id), {}).values())
        return self._merge(
            base,
            lambda j: j.spec.gang is not None
            and j.spec.gang.id == gang_id
            and j.queue == queue
            and not j.state.terminal,
        )

    def commit(self):
        assert self._writable and not self._committed
        self._db._commit(self._writes)
        self._committed = True

    def abort(self):
        self._writes.clear()

    def assert_valid(self):
        """Invariant checks, the jobdb.Assert equivalent (jobdb.go:475)."""
        _live = (RunState.LEASED, RunState.PENDING, RunState.RUNNING)
        seen_runs: dict[str, str] = {}
        for job in self.all_jobs():
            if job.state == JobState.QUEUED:
                assert not job.runs or job.runs[-1].state in (
                    RunState.FAILED,
                    RunState.PREEMPTED,
                ), f"queued job {job.id} has live run"
            if job.state in _LIVE_RUN_STATES:
                assert job.runs, f"{job.state} job {job.id} has no runs"
            # Split-brain invariant: at most ONE live run per job — every
            # superseded attempt must be terminal before a new lease (a
            # healed partition resurrecting a zombie run would trip this).
            live = [r for r in job.runs if r.state in _live]
            assert len(live) <= 1, (
                f"job {job.id} holds {len(live)} active runs: "
                f"{[r.id for r in live]}"
            )
            assert all(
                r.state not in _live for r in job.runs[:-1]
            ), f"job {job.id} has a live superseded run"
            for r in job.runs:
                assert r.id not in seen_runs, (
                    f"run {r.id} owned by both {seen_runs[r.id]} and {job.id}"
                )
                seen_runs[r.id] = job.id
        self._db._assert_indexes()


class JobDb:
    def __init__(self):
        self._jobs: dict[str, Job] = {}
        # Guards _jobs + all indexes (queries materialize under it).
        self._state_lock = threading.RLock()
        self._write_lock = threading.Lock()
        self.serial = 0
        # Maintained indexes (jobdb.go:68-97 index families).
        self._queued_by_queue: dict[str, dict[str, Job]] = {}
        self._leased: dict[str, Job] = {}
        self._by_executor: dict[str, dict[str, Job]] = {}
        self._by_jobset: dict[tuple, dict[str, Job]] = {}
        self._failed_pending: dict[str, Job] = {}
        self._finished_recent: dict[str, Job] = {}
        self._terminal: dict[str, Job] = {}
        self._gangs: dict[tuple, dict[str, Job]] = {}
        self._by_run: dict[str, str] = {}  # latest run id -> job id
        # EVERY run id (superseded attempts included) -> job id: the
        # anti-entropy sync resolves a healed executor's pods through it.
        # Bounded by max_retries attempts per job; entries die with the
        # job (terminal pruning).
        self._by_any_run: dict[str, str] = {}
        # Append-only (serial, job_id) changelog for delta consumers
        # (the incremental snapshot path; the reference delta-syncs by
        # serial, scheduler.go:441). Compacted when oversized; consumers
        # whose watermark predates the history get None and resync.
        self._changelog: list[tuple[int, str]] = []
        self._changelog_start = 0  # serials <= this may be missing

    # ---- txns ----

    def read_txn(self) -> JobDbTxn:
        return JobDbTxn(self, writable=False)

    def write_txn(self) -> JobDbTxn:
        self._write_lock.acquire()
        txn = JobDbTxn(self, writable=True)
        orig_commit, orig_abort = txn.commit, txn.abort

        def commit():
            try:
                orig_commit()
            finally:
                self._write_lock.release()

        def abort():
            try:
                orig_abort()
            finally:
                self._write_lock.release()

        txn.commit, txn.abort = commit, abort
        return txn

    # ---- index maintenance (all under _state_lock) ----

    @staticmethod
    def _pop2(outer: dict, key, jid: str):
        inner = outer.get(key)
        if inner is not None:
            inner.pop(jid, None)
            if not inner:
                del outer[key]

    def _index_remove(self, job: Job):
        jid = job.id
        run = job.latest_run
        if run is not None:
            self._by_run.pop(run.id, None)
        for r in job.runs:
            self._by_any_run.pop(r.id, None)
        if job.state == JobState.QUEUED:
            self._pop2(self._queued_by_queue, job.queue, jid)
        if job.state in _LIVE_RUN_STATES:
            self._leased.pop(jid, None)
            run = job.latest_run
            if run is not None and run.executor:
                self._pop2(self._by_executor, run.executor, jid)
            if run is not None and run.state == RunState.FAILED:
                self._failed_pending.pop(jid, None)
        if job.state.terminal:
            self._terminal.pop(jid, None)
            self._finished_recent.pop(jid, None)
        else:
            self._pop2(self._by_jobset, (job.queue, job.jobset), jid)
            if job.spec.gang is not None:
                self._pop2(self._gangs, (job.queue, job.spec.gang.id), jid)

    def _index_add(self, job: Job):
        jid = job.id
        if job.latest_run is not None:
            self._by_run[job.latest_run.id] = jid
        for r in job.runs:
            self._by_any_run[r.id] = jid
        if job.state == JobState.QUEUED:
            self._queued_by_queue.setdefault(job.queue, {})[jid] = job
        if job.state in _LIVE_RUN_STATES:
            self._leased[jid] = job
            run = job.latest_run
            if run is not None and run.executor:
                self._by_executor.setdefault(run.executor, {})[jid] = job
            if run is not None and run.state == RunState.FAILED:
                self._failed_pending[jid] = job
        if job.state.terminal:
            self._terminal[jid] = job
            run = job.latest_run
            if run is not None and run.finished:
                self._finished_recent[jid] = job
        else:
            self._by_jobset.setdefault((job.queue, job.jobset), {})[jid] = job
            if job.spec.gang is not None:
                self._gangs.setdefault((job.queue, job.spec.gang.id), {})[
                    jid
                ] = job

    def _commit(self, writes: dict):
        with self._state_lock:
            for jid, job in writes.items():
                old = self._jobs.get(jid)
                if old is not None:
                    self._index_remove(old)
                self.serial += 1
                self._changelog.append((self.serial, jid))
                if job is None:
                    self._jobs.pop(jid, None)
                    continue
                stamped = job.with_(serial=self.serial)
                self._jobs[jid] = stamped
                self._index_add(stamped)
            if len(self._changelog) > max(65536, 2 * len(self._jobs)):
                keep = len(self._changelog) // 2
                self._changelog_start = self._changelog[-keep - 1][0]
                self._changelog = self._changelog[-keep:]

    def changed_since(self, serial: int):
        """Ids of jobs written after `serial` (deletions included), oldest
        first, deduplicated. None when the changelog no longer reaches
        back that far — the consumer must resync from a full read."""
        import bisect

        with self._state_lock:
            if serial < self._changelog_start:
                return None
            idx = bisect.bisect(self._changelog, (serial, "￿"))
            seen: set = set()
            out: list[str] = []
            for _, jid in self._changelog[idx:]:
                if jid not in seen:
                    seen.add(jid)
                    out.append(jid)
            return out

    def _assert_indexes(self):
        """Index↔store consistency (the sanitizer part of jobdb.Assert)."""
        with self._state_lock:
            for jid, job in self._jobs.items():
                if job.state == JobState.QUEUED:
                    assert (
                        self._queued_by_queue.get(job.queue, {}).get(jid)
                        is job
                    ), f"queued index missing {jid}"
                if job.state in _LIVE_RUN_STATES:
                    assert self._leased.get(jid) is job, f"leased index missing {jid}"
            n_queued = sum(len(d) for d in self._queued_by_queue.values())
            real_queued = sum(
                1 for j in self._jobs.values() if j.state == JobState.QUEUED
            )
            assert n_queued == real_queued, "queued index drift"

    # ---- direct reads ----

    def get(self, job_id: str) -> Job | None:
        with self._state_lock:
            return self._jobs.get(job_id)

    # ---- checkpointing (services/checkpoint.py) ----

    def dump(self) -> dict:
        """Snapshot for a view checkpoint: jobs + the serial watermark."""
        with self._state_lock:
            return {"jobs": list(self._jobs.values()), "serial": self.serial}

    def load(self, state: dict) -> None:
        """Restore a dump into a fresh db (indexes rebuilt, serials kept)."""
        with self._state_lock:
            assert not self._jobs, "load() requires a fresh JobDb"
            self.serial = state["serial"]
            # No history before the checkpoint: delta consumers resync.
            self._changelog_start = self.serial
            for job in state["jobs"]:
                self._jobs[job.id] = job
                self._index_add(job)

    def prune_terminal(self, older_than: float) -> int:
        """Delete terminal jobs whose last activity predates `older_than`
        (the lookout/scheduler DB pruners of the reference). Returns count.
        O(terminal), not O(all jobs): walks the terminal index."""
        txn = self.write_txn()
        try:
            with self._state_lock:
                terminal = list(self._terminal.values())
            pruned = 0
            for job in terminal:
                run = job.latest_run
                last = max(
                    job.submitted,
                    run.finished if run else 0.0,
                    run.started if run else 0.0,
                )
                if last < older_than:
                    txn.delete(job.id)
                    pruned += 1
            txn.commit()
            return pruned
        except Exception:
            txn.abort()
            raise

    def __len__(self) -> int:
        with self._state_lock:
            return len(self._jobs)
