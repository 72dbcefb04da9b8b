"""Job query API: the Lookout data surface.

The reference materializes a denormalized lookout Postgres schema and
serves a REST API with rich filtering/grouping/aggregation
(internal/lookout/repository/{getjobs,groupjobs}.go and
internal/server/queryapi). Here the same query surface runs over the jobdb
materialization directly (the log is the source of truth either way); the
REST/gRPC transport wraps this object.

Supported: field filters (exact/any-of/prefix), ordering, pagination,
group-by with counts and aggregates — the operations the Lookout UI issues.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from ..jobdb import JobDb, JobState


@dataclass(frozen=True)
class JobFilter:
    """One predicate, mirroring the reference's model.Filter
    (lookout/model/model.go:8-16 match constants; querybuilder.go:616-650
    operator translation). With is_annotation the field names an
    annotation key instead of a column."""

    field: str  # queue | jobset | state | job_id | priority_class | ...
    value: object = None
    match: str = "exact"  # exact | anyOf | startsWith | contains |
    #  greaterThan | lessThan | greaterThanOrEqualTo | lessThanOrEqualTo |
    #  exists
    is_annotation: bool = False


@dataclass(frozen=True)
class Order:
    field: str = "submitted"  # submitted | job_id | priority | state | ...
    direction: str = "asc"


@dataclass
class JobRow:
    job_id: str
    queue: str
    jobset: str
    state: str
    priority: int
    priority_class: str
    submitted: float
    node: str
    executor: str
    attempts: int
    error: str
    error_category: str
    last_transition: float = 0.0
    runtime_s: float = 0.0  # latest run start -> finish (0 while running)
    run_id: str = ""  # latest run
    annotations: dict = field(default_factory=dict)

    @staticmethod
    def from_job(job) -> "JobRow":
        kw = {f: _value_job(job, f) for f in JobRow.__dataclass_fields__}
        # Own copy: the accessor returns the live spec dict by reference
        # (cheap on the filter hot path); a returned row must not alias
        # load-bearing scheduler state.
        kw["annotations"] = dict(kw["annotations"])
        return JobRow(**kw)

    @staticmethod
    def from_lookout(row) -> "JobRow":
        kw = {f: _value_lookout(row, f) for f in JobRow.__dataclass_fields__}
        kw["annotations"] = dict(kw["annotations"])
        return JobRow(**kw)

_JOB_FIELDS = frozenset(JobRow.__dataclass_fields__)


def _check_field(field: str) -> str:
    """Queryable fields are exactly the JobRow schema — identical on both
    backends. Unknown (or backend-private) fields are rejected loudly so
    GET /api/jobs?order=typo is a 400, not a silent None-sort."""
    if field not in _JOB_FIELDS:
        raise ValueError(f"unknown field {field!r}")
    return field


def _runtime_s(started, finished) -> float:
    return max(0.0, finished - started) if started and finished else 0.0


def _value_job(obj, field: str):
    """Field accessor over a raw jobdb Job. Queries filter/sort/aggregate
    through these accessors and materialize JobRow dataclasses only for
    the returned page (the reference pushes this down to SQL; building
    100k+ row objects per query was the Python equivalent of a full table
    scan with materialization). JobRow.from_job builds from the SAME
    accessor, so page values can never disagree with filter/sort values."""
    if field == "job_id":
        return obj.id
    if field == "state":
        return obj.state.value
    if field == "priority_class":
        return obj.spec.priority_class
    if field == "annotations":
        return obj.spec.annotations
    if field in ("node", "executor", "run_id", "attempts", "runtime_s",
                 "last_transition"):
        run = obj.latest_run
        if field == "node":
            return run.node_id if run else ""
        if field == "executor":
            return run.executor if run else ""
        if field == "run_id":
            return run.id if run else ""
        if field == "attempts":
            return obj.num_attempts
        if field == "runtime_s":
            return _runtime_s(run.started, run.finished) if run else 0.0
        return max(
            obj.submitted,
            run.finished if run else 0.0,
            run.started if run else 0.0,
            run.leased if run else 0.0,
        )
    return getattr(obj, _check_field(field))


def _value_lookout(obj, field: str):
    """Field accessor over a raw LookoutRow (see _value_job)."""
    if field in ("node", "executor", "run_id", "attempts", "runtime_s"):
        run = obj.latest_run
        if field == "attempts":
            return len(obj.runs)
        if field == "runtime_s":
            return _runtime_s(run.started, run.finished) if run else 0.0
        if run is None:
            return ""
        return {"node": run.node, "executor": run.executor,
                "run_id": run.run_id}[field]
    return getattr(obj, _check_field(field))


def _matches_raw(value, obj, f: JobFilter) -> bool:
    if f.is_annotation:
        annotations = value(obj, "annotations") or {}
        present = f.field in annotations
        if f.match == "exists":
            return present
        if not present:
            return False
        actual = annotations[f.field]
    else:
        actual = value(obj, f.field)
        if f.match == "exists":
            return actual not in (None, "")
    if f.match == "exact":
        return actual == f.value
    if f.match == "anyOf":
        return actual in f.value
    if f.match == "startsWith":
        return isinstance(actual, str) and actual.startswith(str(f.value))
    if f.match == "contains":
        return isinstance(actual, str) and str(f.value) in actual
    if f.match == "greaterThan":
        return actual is not None and actual > f.value
    if f.match == "lessThan":
        return actual is not None and actual < f.value
    if f.match == "greaterThanOrEqualTo":
        return actual is not None and actual >= f.value
    if f.match == "lessThanOrEqualTo":
        return actual is not None and actual <= f.value
    raise ValueError(f"unknown match {f.match!r}")


class QueryApi:
    """Query surface over either the live jobdb or the independently
    materialized lookout view (pass `lookout=LookoutStore`): the reference
    serves lookout queries from its own Postgres view, never the scheduler
    DB (internal/lookout/repository)."""

    def __init__(self, jobdb: JobDb | None = None, lookout=None,
                 timeline=None):
        assert jobdb is not None or lookout is not None
        self.jobdb = jobdb
        self.lookout = lookout
        # Optional job-journey ledger (services/job_timeline.py): the
        # per-job transition + unschedulable-round history behind
        # job_trace(); None on deployments without a scheduler in
        # process (pure lookout readers).
        self.timeline = timeline
        # One accessor bound per backend (no per-row type sniffing on the
        # query hot path).
        self._value = _value_lookout if lookout is not None else _value_job

    def _raw_rows(self) -> list:
        if self.lookout is not None:
            return self.lookout.all_rows()
        return self.jobdb.read_txn().all_jobs()

    def _to_rows(self, page) -> list[JobRow]:
        """Materialize the returned page. Lookout rows mutate in place
        under the ingester; converting under the store lock keeps each
        returned row internally consistent. (A row may have stopped
        matching the filters between scan and materialization — the view
        is eventually consistent, like any UI read of a live system.)"""
        if self.lookout is not None:
            return self.lookout.materialize(page, JobRow.from_lookout)
        return [JobRow.from_job(o) for o in page]

    def get_jobs(
        self,
        filters: list[JobFilter] = (),
        order: Order = Order(),
        skip: int = 0,
        take: int = 100,
    ) -> tuple[list[JobRow], int]:
        """Filtered, ordered, paginated rows + total match count. Filter
        and sort run on RAW rows; JobRow materialization happens for the
        returned page only (at 100k+ rows, per-query dataclass
        construction was seconds of latency)."""
        value = self._value
        _check_field(order.field)
        if self.lookout is not None and hasattr(self.lookout, "query_rows"):
            # Persistent stores translate filter/sort/page to SQL
            # (querybuilder.go); None = not expressible, fall through to
            # the generic scan.
            pushed = self.lookout.query_rows(filters, order, skip, take)
            if pushed is not None:
                page, total = pushed
                return self._to_rows(page), total
        rows = [
            obj
            for obj in self._raw_rows()
            if all(_matches_raw(value, obj, f) for f in filters)
        ]
        # Deterministic total order: job_id is the secondary key and
        # follows the primary direction — a persistent store can then
        # serve either direction with a single composite index scan
        # (reversing an index reverses every column together).
        keyf = lambda obj: (value(obj, order.field), value(obj, "job_id"))
        top = skip + take
        if 0 < top < len(rows) // 4:
            # Heap-select the page: O(N log K) beats a full O(N log N)
            # sort when the page is a sliver of the match set (the UI's
            # common shape: first pages of a 100k+ row table).
            sel = heapq.nlargest if order.direction == "desc" else heapq.nsmallest
            page = sel(top, rows, key=keyf)[skip:]
        else:
            rows.sort(key=keyf, reverse=(order.direction == "desc"))
            page = rows[skip : skip + take]
        return self._to_rows(page), len(rows)

    def group_jobs(
        self,
        group_by: str,
        filters: list[JobFilter] = (),
        aggregates: list = (),
        group_by_annotation: bool = False,
        order_by: str = "count",
        direction: str = "desc",
        skip: int = 0,
        take: int = 0,
    ) -> list[dict]:
        """Counts (+ aggregates) per group value (groupjobs.go).

        group_by names a column, or an annotation key with
        group_by_annotation (rows missing the key are excluded, matching
        the reference's implicit exists-filter, querybuilder.go:273).
        Aggregates: legacy strings ("submitted_min", "state_counts", ...)
        or reference-style dicts {"field": col, "type": "min|max|average"}
        (aggregates.go GetAggregatorsForColumn). Groups are ordered by
        order_by ("count", "name", or an aggregate name) and paginated
        when take > 0."""
        groups: dict = {}
        agg_specs = []
        for agg in aggregates:
            if isinstance(agg, dict):
                agg_specs.append((f"{agg['field']}_{agg['type']}",
                                  agg["field"], agg["type"]))
            else:
                agg_specs.append((agg, None, None))
        value = self._value
        if not group_by_annotation:
            _check_field(group_by)
        pushed = None
        if (
            not group_by_annotation
            and self.lookout is not None
            and hasattr(self.lookout, "group_rows")
        ):
            pushed = self.lookout.group_rows(group_by, filters, agg_specs)
        if pushed is not None:
            groups = pushed
        else:
            groups = self._group_scan(
                groups, agg_specs, group_by, group_by_annotation, filters
            )
        for g in groups.values():
            for name, v in list(g["aggregates"].items()):
                if isinstance(v, dict) and set(v) == {"sum", "n"}:
                    g["aggregates"][name] = v["sum"] / v["n"] if v["n"] else 0.0
        out = list(groups.values())
        if order_by == "count":
            key = lambda g: g["count"]
        elif order_by == "name":
            key = lambda g: g["name"]
        else:
            key = lambda g: g["aggregates"].get(order_by, 0)
        # Deterministic ties: group name is the secondary key, so the
        # scan path and a SQL GROUP BY pushdown order identically.
        out.sort(key=lambda g: str(g["name"]))
        out.sort(key=key, reverse=(direction == "desc"))
        if skip:
            out = out[skip:]
        if take:
            out = out[:take]
        return out

    def _group_scan(self, groups, agg_specs, group_by, group_by_annotation, filters):
        value = self._value
        for row in self._raw_rows():
            if not all(_matches_raw(value, row, f) for f in filters):
                continue
            if group_by_annotation:
                annotations = value(row, "annotations") or {}
                if group_by not in annotations:
                    continue
                key = annotations[group_by]
            else:
                key = value(row, group_by)
            g = groups.setdefault(
                key, {"name": key, "count": 0, "aggregates": {}}
            )
            g["count"] += 1
            state = value(row, "state")
            for agg, col, typ in agg_specs:
                if col is not None:
                    val = value(row, col)
                    if typ == "min":
                        cur = g["aggregates"].get(agg)
                        g["aggregates"][agg] = (
                            val if cur is None else min(cur, val)
                        )
                    elif typ == "max":
                        cur = g["aggregates"].get(agg)
                        g["aggregates"][agg] = (
                            val if cur is None else max(cur, val)
                        )
                    elif typ == "average":
                        bucket = g["aggregates"].setdefault(
                            agg, {"sum": 0.0, "n": 0}
                        )
                        bucket["sum"] += float(val or 0.0)
                        bucket["n"] += 1
                    elif typ == "state_counts":
                        sc = g["aggregates"].setdefault(agg, {})
                        sc[state] = sc.get(state, 0) + 1
                    else:
                        raise ValueError(f"unknown aggregate type {typ!r}")
                elif agg == "submitted_min":
                    cur = g["aggregates"].get(agg)
                    sub = value(row, "submitted")
                    g["aggregates"][agg] = (
                        sub if cur is None else min(cur, sub)
                    )
                elif agg == "submitted_max":
                    cur = g["aggregates"].get(agg)
                    sub = value(row, "submitted")
                    g["aggregates"][agg] = (
                        sub if cur is None else max(cur, sub)
                    )
                elif agg == "state_counts":
                    sc = g["aggregates"].setdefault(agg, {})
                    sc[state] = sc.get(state, 0) + 1
                elif agg == "error_category_counts":
                    sc = g["aggregates"].setdefault(agg, {})
                    cat = value(row, "error_category")
                    if cat:
                        sc[cat] = sc.get(cat, 0) + 1
                elif agg == "last_transition_max":
                    cur = g["aggregates"].get(agg)
                    lt = value(row, "last_transition")
                    g["aggregates"][agg] = (
                        lt if cur is None else max(cur, lt)
                    )
                elif agg == "runtime_avg":
                    bucket = g["aggregates"].setdefault(agg, {"sum": 0.0, "n": 0})
                    rt = value(row, "runtime_s")
                    if rt:
                        bucket["sum"] += rt
                        bucket["n"] += 1
        return groups

    def get_job_errors(
        self, filters: list[JobFilter] = (), take: int = 100
    ) -> list[dict]:
        """Error drilldown (lookout repository GetJobError + the UI's error
        surfacing): failed jobs with error text + category + run history."""
        value = self._value
        out = []
        for row in self._raw_rows():
            if not value(row, "error"):
                continue
            if not all(_matches_raw(value, row, f) for f in filters):
                continue
            out.append(
                {
                    name: value(row, name)
                    for name in (
                        "job_id", "queue", "jobset", "state", "error",
                        "error_category", "attempts", "node",
                    )
                }
            )
            if len(out) >= take:
                break
        return out

    def job_details(self, job_id: str) -> dict | None:
        """Job drill-down for the UI: spec + run history + error."""
        if self.lookout is not None:
            row = self.lookout.get(job_id)
            if row is None:
                return None
            return {
                "job_id": row.job_id,
                "queue": row.queue,
                "jobset": row.jobset,
                "state": row.state,
                "priority": row.priority,
                "priority_class": row.priority_class,
                "requests": dict(row.requests),
                "annotations": dict(row.annotations),
                "submitted": row.submitted,
                "error": row.error,
                "error_category": row.error_category,
                "runs": [
                    {
                        "run_id": r.run_id,
                        "executor": r.executor,
                        "node": r.node,
                        "state": r.state,
                        "leased": r.leased,
                        "started": r.started,
                        "finished": r.finished,
                        "error": r.error,
                        "debug": r.debug,
                        "termination_reason": r.termination_reason,
                    }
                    for r in row.runs
                ],
            }
        job = self.jobdb.get(job_id)
        if job is None:
            return None
        return {
            "job_id": job.id,
            "queue": job.queue,
            "jobset": job.jobset,
            "state": job.state.value,
            "priority": job.priority,
            "priority_class": job.spec.priority_class,
            "requests": dict(job.spec.requests),
            "annotations": dict(job.spec.annotations),
            "submitted": job.submitted,
            "error": job.error,
            "error_category": job.error_category,
            "runs": [
                {
                    "run_id": r.id,
                    "executor": r.executor,
                    "node": r.node_id,
                    "state": r.state.value,
                    "leased": r.leased,
                    "started": r.started,
                    "finished": r.finished,
                }
                for r in job.runs
            ],
        }

    def job_trace(self, job_id: str) -> dict | None:
        """The job's journey (timeline + rendered text), or None when no
        ledger is attached or the job was never observed."""
        if self.timeline is None:
            return None
        doc = self.timeline.get(job_id)
        if doc is None:
            return None
        return {
            "journey": doc,
            "rendered": self.timeline.render(job_id, doc=doc),
        }

    def get_job_spec(self, job_id: str):
        job = self.jobdb.get(job_id)
        return job.spec if job else None

    def get_job_runs(self, job_id: str):
        job = self.jobdb.get(job_id)
        return list(job.runs) if job else []

    def get_job_run_error(self, run_id: str) -> str:
        """Error text for one run (getjobrunerror.go)."""
        run = self._find_run(run_id)
        return getattr(run, "error", "") if run else ""

    def get_job_run_debug_message(self, run_id: str) -> str:
        """Executor-side diagnostic dump for one run
        (getjobrundebugmessage.go — job_run.debug)."""
        run = self._find_run(run_id)
        return getattr(run, "debug", "") if run else ""

    def get_job_run_termination_reason(self, run_id: str) -> str:
        """Why the scheduler ended the run (preemption reason;
        getjobrunschedulerterminationreason.go)."""
        run = self._find_run(run_id)
        return getattr(run, "termination_reason", "") if run else ""

    def _find_run(self, run_id: str):
        if self.lookout is not None:
            return self.lookout.get_run(run_id)
        txn = self.jobdb.read_txn()
        for job in txn.all_jobs():
            for r in job.runs:
                if r.id == run_id:
                    return r
        return None

    def active_job_sets(self) -> list[tuple[str, str]]:
        value = self._value
        seen = {}
        for row in self._raw_rows():
            if value(row, "state") in (
                "queued", "leased", "pending", "running"
            ):
                seen[
                    (value(row, "queue"), value(row, "jobset"))
                ] = True
        return sorted(seen)
