"""Persistent lookout store: the SQLite-backed materialized view.

The reference lookout keeps its denormalized job/run rows in Postgres
(internal/lookout/, lookoutingester/lookoutdb/insertion.go) with a
retention pruner (internal/lookout/pruner/pruner.go); restarts resume
from the rows already on disk. The in-memory view (lookout_ingester.py)
holds RAM-only dicts: at millions of jobs it exceeds memory, and a
restart replays everything.

`SqliteLookoutStore` is interface-compatible with the in-memory
`LookoutStore` (all_rows/get/get_run/materialize/prune/sync/lag_events),
so `QueryApi` and the UI run unchanged against either. Event application
REUSES `LookoutStore._apply` verbatim over a lazy row mapping: rows are
faulted in from SQLite per sync batch, mutated as plain `LookoutRow`
objects by the shared code, and upserted together with the ingest cursor
in ONE transaction — crash-consistent, and a reopened store resumes from
its cursor without replaying the log (meta table). WAL mode keeps UI
reads non-blocking under ingest.

Schema (denormalized like lookoutdb: one row per job, runs embedded,
plus a run_id -> job_id drilldown index):

  job(job_id PK, queue, jobset, state, priority, priority_class,
      requests JSON, annotations JSON, submitted, last_transition,
      cancelled, error, error_category, runs JSON)
  run_index(run_id PK, job_id)
  meta(key PK, value)           -- 'cursor'
"""

from __future__ import annotations

import json
import sqlite3
import threading
from dataclasses import asdict

from .lookout_ingester import LookoutRow, LookoutRun, LookoutStore

_TERMINAL = ("succeeded", "failed", "cancelled", "preempted")
_ACTIVE = ("queued", "leased", "pending", "running")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS job(
  job_id TEXT PRIMARY KEY, queue TEXT NOT NULL, jobset TEXT NOT NULL,
  state TEXT NOT NULL, priority INTEGER, priority_class TEXT,
  requests TEXT, annotations TEXT, submitted REAL, last_transition REAL,
  cancelled REAL, error TEXT, error_category TEXT, runs TEXT);
CREATE INDEX IF NOT EXISTS job_queue_submitted ON job(queue, submitted, job_id);
CREATE INDEX IF NOT EXISTS job_jobset ON job(queue, jobset);
CREATE INDEX IF NOT EXISTS job_state ON job(state);
CREATE INDEX IF NOT EXISTS job_submitted ON job(submitted, job_id);
CREATE INDEX IF NOT EXISTS job_last_transition ON job(last_transition, job_id);
CREATE TABLE IF NOT EXISTS run_index(run_id TEXT PRIMARY KEY, job_id TEXT);
CREATE INDEX IF NOT EXISTS run_job ON run_index(job_id);
CREATE TABLE IF NOT EXISTS meta(key TEXT PRIMARY KEY, value TEXT);
"""

_COLS = (
    "job_id queue jobset state priority priority_class requests annotations "
    "submitted last_transition cancelled error error_category runs"
).split()


def _row_to_record(row: LookoutRow) -> tuple:
    return (
        row.job_id,
        row.queue,
        row.jobset,
        row.state,
        row.priority,
        row.priority_class,
        json.dumps(row.requests),
        json.dumps(row.annotations),
        row.submitted,
        row.last_transition,
        row.cancelled,
        row.error,
        row.error_category,
        json.dumps([asdict(r) for r in row.runs]),
    )


def _record_to_row(rec) -> LookoutRow:
    return LookoutRow(
        job_id=rec[0],
        queue=rec[1],
        jobset=rec[2],
        state=rec[3],
        priority=rec[4],
        priority_class=rec[5],
        requests=json.loads(rec[6] or "{}"),
        annotations=json.loads(rec[7] or "{}"),
        submitted=rec[8],
        last_transition=rec[9],
        cancelled=rec[10],
        error=rec[11],
        error_category=rec[12],
        runs=[LookoutRun(**r) for r in json.loads(rec[13] or "[]")],
    )


class _LazyRowMap:
    """dict-ish view over the job table for LookoutStore._apply: rows
    fault in from SQLite, and everything touched within a sync batch is
    flushed back (mutations happen in place on the objects, so touched ==
    potentially dirty)."""

    def __init__(self, store: "SqliteLookoutStore"):
        self.store = store
        self.cache: dict[str, LookoutRow] = {}
        # Known-missing ids within the current sync batch (prefetch
        # misses + freshly submitted ids): membership checks answer from
        # memory instead of a per-event SELECT.
        self.absent: set[str] = set()

    def get(self, job_id, default=None):
        if job_id in self.cache:
            return self.cache[job_id]
        if job_id in self.absent:
            return default
        row = self.store._load_row(job_id)
        if row is not None:
            self.cache[job_id] = row
            return row
        self.absent.add(job_id)
        return default

    def __contains__(self, job_id):
        return self.get(job_id) is not None

    def __setitem__(self, job_id, row):
        self.cache[job_id] = row
        self.absent.discard(job_id)


class _LazyRunMap:
    """run_id -> job_id through run_index; writes buffer until flush."""

    def __init__(self, store: "SqliteLookoutStore"):
        self.store = store
        self.pending: dict[str, str | None] = {}  # None = delete

    def get(self, run_id, default=""):
        if run_id in self.pending:
            v = self.pending[run_id]
            return default if v is None else v
        cur = self.store._db.execute(
            "SELECT job_id FROM run_index WHERE run_id=?", (run_id,)
        ).fetchone()
        return cur[0] if cur else default

    def __setitem__(self, run_id, job_id):
        self.pending[run_id] = job_id

    def pop(self, run_id, default=None):
        self.pending[run_id] = None
        return default


class SqliteLookoutStore:
    """Drop-in persistent LookoutStore; see module docstring."""

    def __init__(self, log, path: str, error_rules=()):
        self.log = log
        self.error_rules = error_rules
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.executescript(_SCHEMA)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        # Separate read connection: WAL readers never block on the
        # ingester's write transactions, so UI queries don't queue behind
        # a busy sync loop (the reference gets this from Postgres MVCC).
        self._read_db = sqlite3.connect(path, check_same_thread=False)
        self._read_db.execute("PRAGMA query_only=1")
        # Match the scan path's case-SENSITIVE startsWith/contains.
        self._read_db.execute("PRAGMA case_sensitive_like=1")
        self._read_lock = threading.Lock()
        self._lock = threading.RLock()
        cur = self._db.execute(
            "SELECT value FROM meta WHERE key='cursor'"
        ).fetchone()
        self.cursor = int(cur[0]) if cur else 0
        self.cursor = max(self.cursor, log.start_offset)
        self.rows = _LazyRowMap(self)
        self.run_to_job = _LazyRunMap(self)

    # ---- ingestion (shared event semantics) ----

    # The single source of event->row semantics is the in-memory store.
    _apply_shared = LookoutStore._apply

    def _apply(self, seq, event):
        from .. import events as ev

        if isinstance(event, ev.CancelJobSet):
            # The shared path scans every row; here only the jobset's
            # active rows are faulted in and mutated.
            cur = self._db.execute(
                "SELECT job_id FROM job WHERE queue=? AND jobset=? AND "
                f"state IN ({','.join('?' * len(_ACTIVE))})",
                (seq.queue, seq.jobset, *_ACTIVE),
            )
            for (jid,) in cur.fetchall():
                row = self.rows.get(jid)
                if row is not None and row.state in _ACTIVE:
                    row.state = "cancelled"
                    row.cancelled = event.created
                    row.last_transition = event.created
            # Rows already cached (possibly not yet flushed) match too.
            for row in list(self.rows.cache.values()):
                if (
                    row.queue == seq.queue
                    and row.jobset == seq.jobset
                    and row.state in _ACTIVE
                ):
                    row.state = "cancelled"
                    row.cancelled = event.created
                    row.last_transition = event.created
            return
        self._apply_shared(seq, event)

    def sync(self, limit: int = 10_000) -> int:
        """Apply new log entries; one transaction per batch (rows + run
        index + cursor move together — crash-consistent resume)."""
        applied = 0
        while True:
            entries = self.log.read(self.cursor, limit)
            if not entries:
                return applied
            with self._lock:
                try:
                    self._prefetch(entries)
                    for entry in entries:
                        for event in entry.sequence.events:
                            self._apply(entry.sequence, event)
                    self.cursor = entries[-1].offset + 1
                    self._flush()
                except Exception:
                    # A mid-batch failure must not leave half-applied rows
                    # in the cache: the caller's retry would re-apply the
                    # same events on top and persist doubled state. Drop
                    # the batch's in-memory work; the cursor did not move.
                    self.rows.cache.clear()
                    self.rows.absent.clear()
                    self.run_to_job.pending.clear()
                    raise
            applied += len(entries)

    def _prefetch(self, entries):
        """Fault every job row a batch touches in chunked IN-queries
        instead of one SELECT per event — the difference between the sync
        loop holding the write path for milliseconds vs seconds."""
        cache = self.rows.cache
        want: list[str] = []
        seen: set[str] = set()
        for entry in entries:
            for event in entry.sequence.events:
                jid = getattr(event, "job_id", "") or getattr(
                    getattr(event, "job", None), "id", ""
                )
                if jid and jid not in cache and jid not in seen:
                    seen.add(jid)
                    want.append(jid)
        for i in range(0, len(want), 500):
            chunk = want[i : i + 500]
            cur = self._db.execute(
                f"SELECT {','.join(_COLS)} FROM job WHERE job_id IN "
                f"({','.join('?' * len(chunk))})",
                chunk,
            )
            found = set()
            for rec in cur.fetchall():
                cache[rec[0]] = _record_to_row(rec)
                found.add(rec[0])
            self.rows.absent.update(jid for jid in chunk if jid not in found)

    def _flush(self):
        cache = self.rows.cache
        if cache:
            self._db.executemany(
                f"INSERT OR REPLACE INTO job({','.join(_COLS)}) "
                f"VALUES ({','.join('?' * len(_COLS))})",
                [_row_to_record(r) for r in cache.values()],
            )
        pend = self.run_to_job.pending
        if pend:
            ins = [(rid, jid) for rid, jid in pend.items() if jid is not None]
            dels = [(rid,) for rid, jid in pend.items() if jid is None]
            if ins:
                self._db.executemany(
                    "INSERT OR REPLACE INTO run_index(run_id, job_id) "
                    "VALUES (?, ?)",
                    ins,
                )
            if dels:
                self._db.executemany(
                    "DELETE FROM run_index WHERE run_id=?", dels
                )
        self._db.execute(
            "INSERT OR REPLACE INTO meta(key, value) VALUES ('cursor', ?)",
            (str(self.cursor),),
        )
        self._db.commit()
        cache.clear()
        self.rows.absent.clear()
        pend.clear()

    @property
    def lag_events(self) -> int:
        return max(0, self.log.end_offset - self.cursor)

    def _load_row(self, job_id: str) -> LookoutRow | None:
        rec = self._db.execute(
            f"SELECT {','.join(_COLS)} FROM job WHERE job_id=?", (job_id,)
        ).fetchone()
        return _record_to_row(rec) if rec else None

    # ---- reads (QueryApi surface) ----

    def all_rows(self) -> list[LookoutRow]:
        with self._read_lock:
            cur = self._read_db.execute(f"SELECT {','.join(_COLS)} FROM job")
            return [_record_to_row(r) for r in cur.fetchall()]

    def get(self, job_id: str) -> LookoutRow | None:
        with self._read_lock:
            rec = self._read_db.execute(
                f"SELECT {','.join(_COLS)} FROM job WHERE job_id=?", (job_id,)
            ).fetchone()
            return _record_to_row(rec) if rec else None

    def materialize(self, rows, convert):
        # all_rows() returns detached copies — already consistent.
        return [convert(r) for r in rows]

    def get_run(self, run_id: str) -> LookoutRun | None:
        with self._read_lock:
            cur = self._read_db.execute(
                "SELECT job_id FROM run_index WHERE run_id=?", (run_id,)
            ).fetchone()
            jid = cur[0] if cur else ""
            rec = self._read_db.execute(
                f"SELECT {','.join(_COLS)} FROM job WHERE job_id=?", (jid,)
            ).fetchone() if jid else None
            row = _record_to_row(rec) if rec else None
            if row is None:
                return None
            for r in row.runs:
                if r.run_id == run_id:
                    return r
            return None

    def prune(self, older_than: float) -> int:
        """Retention pruner (internal/lookout/pruner): drop terminal rows
        whose last transition predates the window, plus their run index."""
        with self._lock:
            cur = self._db.execute(
                "SELECT job_id FROM job WHERE last_transition<? AND "
                f"state IN ({','.join('?' * len(_TERMINAL))})",
                (older_than, *_TERMINAL),
            )
            drop = [jid for (jid,) in cur.fetchall()]
            if drop:
                qs = ",".join("?" * len(drop))
                self._db.execute(
                    f"DELETE FROM run_index WHERE job_id IN ({qs})", drop
                )
                self._db.execute(
                    f"DELETE FROM job WHERE job_id IN ({qs})", drop
                )
                self._db.commit()
            return len(drop)

    # ---- SQL pushdown (QueryApi.get_jobs fast path) ----

    # Fields that are plain job-table columns; anything else (annotation
    # filters, run-level fields) falls back to the generic scan.
    _SQL_FIELDS = frozenset(
        "job_id queue jobset state priority priority_class submitted "
        "last_transition cancelled error error_category".split()
    )
    # startsWith/contains push down only for text columns: the scan path
    # requires isinstance(str), while SQL LIKE would coerce numerics.
    _TEXT_FIELDS = frozenset(
        "job_id queue jobset state priority_class error "
        "error_category".split()
    )

    @staticmethod
    def _like_escape(s: str) -> str:
        return s.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")

    def _filters_to_sql(self, filters, allowed=None):
        """JobFilter list -> (conds, params), or None when a predicate is
        not SQL-expressible (querybuilder.go's operator translation).
        `allowed` optionally restricts the match kinds (group pushdown
        supports the equality family only)."""
        conds: list[str] = []
        params: list = []
        for f in filters:
            if f.is_annotation or f.field not in self._SQL_FIELDS:
                return None
            if allowed is not None and f.match not in allowed:
                return None
            col = f.field
            if f.match == "exact":
                conds.append(f"{col}=?")
                params.append(f.value)
            elif f.match == "anyOf":
                vals = list(f.value or ())
                if not vals:
                    conds.append("0")
                else:
                    conds.append(f"{col} IN ({','.join('?' * len(vals))})")
                    params.extend(vals)
            elif f.match == "startsWith":
                if col not in self._TEXT_FIELDS:
                    return None
                conds.append(f"{col} LIKE ? ESCAPE '\\'")
                params.append(self._like_escape(str(f.value)) + "%")
            elif f.match == "contains":
                if col not in self._TEXT_FIELDS:
                    return None
                conds.append(f"{col} LIKE ? ESCAPE '\\'")
                params.append("%" + self._like_escape(str(f.value)) + "%")
            elif f.match == "greaterThan":
                conds.append(f"{col}>?")
                params.append(f.value)
            elif f.match == "lessThan":
                conds.append(f"{col}<?")
                params.append(f.value)
            elif f.match == "greaterThanOrEqualTo":
                conds.append(f"{col}>=?")
                params.append(f.value)
            elif f.match == "lessThanOrEqualTo":
                conds.append(f"{col}<=?")
                params.append(f.value)
            elif f.match == "exists":
                conds.append(f"({col} IS NOT NULL AND {col}!='')")
            else:
                return None
        return conds, params

    def query_rows(self, filters, order, skip: int, take: int):
        """Filter/sort/page in SQL (querybuilder.go's role). Returns
        (page LookoutRows, total) or None when a predicate isn't
        SQL-expressible — the caller then uses the all_rows() scan.
        Ties break on job_id for determinism."""
        translated = self._filters_to_sql(filters)
        if translated is None:
            return None
        conds, params = translated
        if order.field not in self._SQL_FIELDS:
            return None
        where = (" WHERE " + " AND ".join(conds)) if conds else ""
        direction = "DESC" if order.direction == "desc" else "ASC"
        with self._read_lock:
            total = self._read_db.execute(
                f"SELECT COUNT(*) FROM job{where}", params
            ).fetchone()[0]
            # job_id follows the primary direction (matching the scan
            # path's composite key), so a single (field, job_id) index
            # serves both directions as a pure (reverse) scan — no temp
            # b-tree sort on the UI's hot path.
            cur = self._read_db.execute(
                f"SELECT {','.join(_COLS)} FROM job{where} "
                f"ORDER BY {order.field} {direction}, job_id {direction} "
                "LIMIT ? OFFSET ?",
                (*params, take, skip),
            )
            return [_record_to_row(r) for r in cur.fetchall()], total

    def group_rows(self, group_by: str, filters, agg_specs):
        """GROUP BY pushdown for QueryApi.group_jobs: returns the groups
        dict in the scan path's intermediate format (averages as
        {'sum','n'} buckets), or None when the shape isn't SQL-expressible
        (annotation group-bys, computed columns like runtime)."""
        if group_by not in self._SQL_FIELDS:
            return None
        translated = self._filters_to_sql(filters, allowed=("exact", "anyOf"))
        if translated is None:
            return None
        conds, params = translated
        sel = [group_by, "COUNT(*)"]
        post: list = []  # (agg_name, kind) aligned with extra select cols
        counts_aggs: list = []  # (agg_name, column) via secondary queries
        for agg, col, typ in agg_specs:
            if col is not None and col in self._SQL_FIELDS:
                if typ == "min":
                    sel.append(f"MIN({col})")
                    post.append((agg, "plain"))
                elif typ == "max":
                    sel.append(f"MAX({col})")
                    post.append((agg, "plain"))
                elif typ == "average":
                    sel.append(f"SUM(COALESCE({col},0))")
                    post.append((agg, "avg"))
                else:
                    return None
            elif agg == "submitted_min":
                sel.append("MIN(submitted)")
                post.append((agg, "plain"))
            elif agg == "submitted_max":
                sel.append("MAX(submitted)")
                post.append((agg, "plain"))
            elif agg == "last_transition_max":
                sel.append("MAX(last_transition)")
                post.append((agg, "plain"))
            elif agg == "state_counts":
                counts_aggs.append((agg, "state"))
            elif agg == "error_category_counts":
                counts_aggs.append((agg, "error_category"))
            else:
                return None
        where = (" WHERE " + " AND ".join(conds)) if conds else ""
        with self._read_lock:
            cur = self._read_db.execute(
                f"SELECT {','.join(sel)} FROM job{where} GROUP BY {group_by}",
                params,
            )
            groups = {}
            for rec in cur.fetchall():
                g = {"name": rec[0], "count": rec[1], "aggregates": {}}
                for i, (agg, kind) in enumerate(post):
                    if kind == "avg":
                        g["aggregates"][agg] = {
                            "sum": float(rec[2 + i] or 0.0),
                            "n": rec[1],
                        }
                    else:
                        g["aggregates"][agg] = rec[2 + i]
                groups[rec[0]] = g
            for agg, col in counts_aggs:
                cur = self._read_db.execute(
                    f"SELECT {group_by}, {col}, COUNT(*) FROM job{where} "
                    f"GROUP BY {group_by}, {col}",
                    params,
                )
                for gval, cval, n in cur.fetchall():
                    g = groups.get(gval)
                    if g is None:
                        continue
                    if agg == "error_category_counts" and not cval:
                        continue  # the scan path skips empty categories
                    g["aggregates"].setdefault(agg, {})[cval] = n
        return groups

    def count(self) -> int:
        with self._read_lock:
            return self._read_db.execute(
                "SELECT COUNT(*) FROM job"
            ).fetchone()[0]

    def checkpoint_state(self):
        """The database file IS the checkpoint; nothing to serialize."""
        with self._lock:
            return self.cursor, {"rows": {}, "run_to_job": {}}

    def close(self):
        with self._lock:
            self._db.commit()
            self._db.close()
        with self._read_lock:
            self._read_db.close()
