"""Jobset-keyed sharded ingest: the front door's write path.

The reference survives submit floods by partitioning its event topic by
jobset key (Pulsar partitioned topics, jobset-keyed routing in
internal/common/pulsarutils/jobsetevents/) and running one ingester per
partition. Same shape here: a submission is acknowledged once it is
DURABLE in its jobset's shard WAL (a crash-recovering FileEventLog —
torn tails truncate, the append retries, the client's ack means the
bytes survived); per-shard ingesters then deliver WAL entries into the
main event log, where every existing view (scheduler jobdb, lookout,
event index, watch streams) consumes them unchanged.

Delivery is ordered and exactly-once across crash/restart:

  ordered       a jobset maps to exactly one shard (stable crc32 key),
                and a shard delivers its WAL in offset order — so every
                jobset sees its events in submission order.

  exactly-once  each delivered EventSequence is stamped with an
                idempotent-producer marker "fd<shard>:<wal offset>".
                The durable drain state (cursor + the main-log offset at
                the last save, tmp+fsync+rename) only advances AFTER the
                publish, so a crash between publish and save redelivers;
                recovery scans the main log's suffix from the saved
                offset for its own markers and skips what already
                landed. Lost-ack is impossible (the WAL is durable
                before the ack; the cursor never passes an undelivered
                entry); double-apply is impossible (the marker scan
                suppresses redelivery, and the jobdb's idempotent
                SubmitJob guard backstops it).

Chaos integration (services/chaos.py, existing FaultPlan kinds):

  torn_log_write  target "shard-<i>" (or "*") tears the shard WAL
                  append mid-record — recovery truncates, the append
                  retries, the ack is only ever sent for durable bytes.
  network_partition  target "shard-<i>" severs the shard ingester from
                  the store for the window: the WAL keeps acking, lag
                  grows, delivery resumes on heal (acked work is
                  delayed, never lost).
  executor_crash  target "shard-<i>" kills the shard ingester mid-batch
                  (ShardCrashed); FrontDoor.pump restarts it from its
                  durable state — the crash/restart path the
                  exactly-once machinery exists for.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
import zlib
from dataclasses import replace

from ..events import InMemoryEventLog
from ..events.model import EventSequence
from .admission import DeadlineExpired

# Marker prefix: "fd<shard>:<wal offset>".
_MARKER = "fd{shard}:{offset}"


def shard_of(queue: str, jobset: str, num_shards: int) -> int:
    """Stable jobset-keyed routing (crc32, not hash(): Python's string
    hash is salted per process — two processes must agree)."""
    return zlib.crc32(f"{queue}/{jobset}".encode()) % max(1, num_shards)


class ShardCrashed(RuntimeError):
    """Injected shard-ingester crash (chaos `executor_crash` on target
    "shard-<i>"): the delivery batch aborts wherever it was — published
    entries are in the main log, the cursor is NOT saved — and the owner
    restarts the shard from durable state."""

    def __init__(self, index: int):
        super().__init__(f"shard-{index} ingester crashed mid-batch")
        self.index = index


class IngestShard:
    """One shard: a durable WAL (the ack point) + a cursor-tracked
    ingester delivering into the main log with exactly-once markers."""

    def __init__(
        self,
        index: int,
        main_log,
        directory: str | None = None,
        fault_plan=None,
        clock=None,
        crash_hook=None,
        wal=None,
    ):
        self.index = index
        self.main_log = main_log
        self.directory = directory
        self.fault_plan = fault_plan
        self.clock = clock if clock is not None else _time.time
        # Test seam: called once per WAL entry before delivery; lets the
        # soak's --inject-loss deliberately drop an acked entry (the gate
        # must catch exactly this) and tests kill delivery mid-batch.
        self.crash_hook = crash_hook
        self.delivered_total = 0
        self.duplicates_suppressed = 0
        self.restarts = 0
        if wal is not None:
            # In-memory restart path: the WAL object survives (only the
            # ingester state is "lost"); recovery rebuilds the cursor
            # from the marker scan alone.
            self.wal = wal
        elif directory is not None:
            from ..services.chaos import CrashRecoveringLog

            os.makedirs(directory, exist_ok=True)
            self.wal = CrashRecoveringLog(
                directory, fault_plan, clock=self.clock,
                target=f"shard-{index}",
            )
        else:
            self.wal = InMemoryEventLog()
        self.cursor = 0
        self._saved_main_offset = 0
        self._delivered: set[int] = set()  # redelivery-window dedup
        self._recover()

    # ---- durable drain state ----

    def _state_path(self) -> str:
        return os.path.join(self.directory, "drain.json")

    def _save_state(self) -> None:
        if self.directory is None:
            self._saved_main_offset = self.main_log.end_offset
            return
        state = {
            "cursor": self.cursor,
            "main_offset": self.main_log.end_offset,
        }
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path())
        self._saved_main_offset = state["main_offset"]

    def _recover(self) -> None:
        """Load the durable cursor, then scan the main log's suffix for
        this shard's markers at or past it — entries published by a
        previous incarnation whose cursor save never landed. Those are
        skipped on redelivery: exactly-once across the crash."""
        if self.directory is not None:
            try:
                with open(self._state_path()) as f:
                    state = json.load(f)
                self.cursor = int(state.get("cursor", 0))
                self._saved_main_offset = int(state.get("main_offset", 0))
            except (FileNotFoundError, json.JSONDecodeError, ValueError):
                self.cursor = 0
                self._saved_main_offset = 0
        prefix = f"fd{self.index}:"
        cur = max(self._saved_main_offset, self.main_log.start_offset)
        self._delivered = set()
        while True:
            try:
                entries = self.main_log.read(cur, 5000)
            except Exception as e:  # CompactedLogError: a concurrent
                # compact() advanced start_offset past our saved cursor —
                # skip the compacted prefix (its entries are materialized
                # in every checkpointed view, below any live dedup window)
                # and keep scanning the surviving suffix.
                if type(e).__name__ != "CompactedLogError":
                    raise
                cur = self.main_log.start_offset
                continue
            if not entries:
                break
            for entry in entries:
                marker = getattr(entry.sequence, "ingest_marker", "")
                if marker.startswith(prefix):
                    off = int(marker[len(prefix):])
                    if off >= self.cursor:
                        self._delivered.add(off)
            cur = entries[-1].offset + 1

    # ---- the ack point ----

    def append(self, sequence: EventSequence) -> int:
        """Durable WAL append; returning IS the acknowledgement. Torn
        writes (chaos) recover-and-retry inside the crash-recovering
        WAL, so an ack always means the bytes are on disk."""
        return self.wal.publish(sequence)

    @property
    def lag(self) -> int:
        """Acked-but-undelivered entries (the ingest lag SLO input)."""
        return max(0, self.wal.end_offset - self.cursor)

    # ---- delivery ----

    def partitioned(self, now: float | None = None) -> bool:
        if self.fault_plan is None:
            return False
        now = self.clock() if now is None else now
        return (
            self.fault_plan.active(
                "network_partition", f"shard-{self.index}", now
            )
            is not None
        )

    def deliver(self, limit: int = 10_000, now: float | None = None) -> int:
        """Deliver up to `limit` WAL entries into the main log, in
        order. Returns entries processed (delivered + suppressed).
        Raises ShardCrashed mid-batch under an injected crash — durable
        state is then exactly as a killed process would leave it."""
        now = self.clock() if now is None else now
        if self.partitioned(now):
            return 0
        entries = self.wal.read(self.cursor, limit)
        if not entries:
            return 0
        processed = 0
        # NO state save on the crash path: a killed process never gets
        # to persist its cursor, so everything published in this batch
        # sits PAST the durable cursor — exactly the redelivery window
        # the restarted ingester's marker scan must dedup.
        for entry in entries:
            if (
                processed  # crash MID-batch: at least one entry is
                # already published past the durable cursor, so the
                # restart must dedup it — the exactly-once window
                and self.fault_plan is not None
                and self.fault_plan.fire(
                    "executor_crash", f"shard-{self.index}", now
                )
            ):
                raise ShardCrashed(self.index)
            dropped = False
            if self.crash_hook is not None:
                dropped = bool(self.crash_hook(self, entry))
            if entry.offset in self._delivered:
                self.duplicates_suppressed += 1
            elif not dropped:
                self.main_log.publish(
                    replace(
                        entry.sequence,
                        ingest_marker=_MARKER.format(
                            shard=self.index, offset=entry.offset
                        ),
                    )
                )
                self.delivered_total += 1
            self.cursor = entry.offset + 1
            processed += 1
        self._save_state()
        self._delivered = {o for o in self._delivered if o >= self.cursor}
        return processed


class FrontDoor:
    """N ingest shards + (optional) admission control, one object the
    transport and SubmitService share.

    `append` is the post-validation enqueue: it checks the propagated
    deadline (drop early — an expired submission must never be acked)
    then routes to the jobset's shard WAL. `pump` runs every shard's
    ingester; an injected shard crash is met with an in-place restart
    from durable state, the same recovery a supervised process performs.
    """

    def __init__(
        self,
        main_log,
        num_shards: int = 4,
        directory: str | None = None,
        admission=None,
        fault_plan=None,
        clock=None,
        metrics=None,
    ):
        self.main_log = main_log
        self.num_shards = max(1, int(num_shards))
        self.directory = directory
        self.admission = admission
        self.fault_plan = fault_plan
        self.clock = clock if clock is not None else _time.time
        self.metrics = metrics
        self.deadline_drops = {"gate": 0, "enqueue": 0}
        self._lock = threading.Lock()
        self.shards = [
            self._make_shard(i) for i in range(self.num_shards)
        ]

    def _make_shard(self, i: int, wal=None) -> IngestShard:
        return IngestShard(
            i,
            self.main_log,
            directory=(
                os.path.join(self.directory, f"shard-{i:02d}")
                if self.directory is not None
                else None
            ),
            fault_plan=self.fault_plan,
            clock=self.clock,
            wal=wal,
        )

    # ---- admission + deadline + enqueue (the submit path) ----

    def admit(self, tenant: str, n: int = 1, now: float | None = None) -> None:
        if self.admission is not None:
            self.admission.admit(tenant, n, now=now)

    def note_deadline_drop(self, stage: str) -> None:
        with self._lock:
            self.deadline_drops[stage] = self.deadline_drops.get(stage, 0) + 1
        m = self.metrics
        if m is not None and getattr(m, "registry", None) is not None:
            m.frontdoor_deadline_drops.labels(stage=stage).inc()

    def append(
        self,
        sequence: EventSequence,
        deadline_ts: float | None = None,
        now: float | None = None,
    ) -> int:
        """Durable enqueue (the ack). The deadline check sits immediately
        before the WAL append: expired work is dropped here, whole —
        after this point the submission is acked and ALWAYS applies."""
        now = self.clock() if now is None else now
        if deadline_ts is not None and now >= deadline_ts:
            self.note_deadline_drop("enqueue")
            raise DeadlineExpired(
                "enqueue",
                f"{now - deadline_ts:.3f}s past deadline at the shard WAL",
            )
        i = shard_of(sequence.queue, sequence.jobset, self.num_shards)
        return self.shards[i].append(sequence)

    # ---- the ingest loop ----

    def pump(self, limit: int = 10_000, now: float | None = None) -> int:
        """One delivery pass over every shard. Injected shard crashes
        restart the shard from its durable state (counted), exactly as a
        supervisor would; the pass then continues with the next shard —
        one crashing shard never wedges the others."""
        total = 0
        for i, shard in enumerate(self.shards):
            try:
                total += shard.deliver(limit, now=now)
            except ShardCrashed:
                # Restart from durable state only (the file-backed WAL
                # recovers itself; an in-memory WAL object survives the
                # "process" by construction). Counters carry over — they
                # describe the shard, not the incarnation.
                old_wal = (
                    shard.wal if self.directory is None else None
                )
                counters = (
                    shard.restarts + 1,
                    shard.delivered_total,
                    shard.duplicates_suppressed,
                )
                self.shards[i] = self._make_shard(i, wal=old_wal)
                (
                    self.shards[i].restarts,
                    self.shards[i].delivered_total,
                    self.shards[i].duplicates_suppressed,
                ) = counters
                # The metrics watermark too, or _observe_metrics would
                # re-count the whole pre-crash delivery history as a
                # fresh counter delta after every restart.
                self.shards[i]._metric_last = getattr(
                    shard, "_metric_last", (0, 0)
                )
        self._observe_metrics()
        return total

    def drain(self, now: float | None = None, max_passes: int = 1000) -> None:
        """Pump until every shard's lag is zero (or a partition window
        holds it open — callers on a virtual clock advance time and call
        again)."""
        for _ in range(max_passes):
            self.pump(now=now)
            if self.max_lag() == 0 or any(
                s.partitioned(now) for s in self.shards
            ):
                return

    def max_lag(self) -> int:
        return max((s.lag for s in self.shards), default=0)

    def _observe_metrics(self) -> None:
        m = self.metrics
        if m is None or getattr(m, "registry", None) is None:
            return
        for shard in self.shards:
            label = str(shard.index)
            m.frontdoor_shard_lag.labels(shard=label).set(shard.lag)
            # Counters need deltas; track last-observed per shard.
            last = getattr(shard, "_metric_last", (0, 0))
            d_pub = shard.delivered_total - last[0]
            d_dup = shard.duplicates_suppressed - last[1]
            if d_pub > 0:
                m.frontdoor_delivered.labels(
                    shard=label, outcome="published"
                ).inc(d_pub)
            if d_dup > 0:
                m.frontdoor_delivered.labels(
                    shard=label, outcome="duplicate"
                ).inc(d_dup)
            shard._metric_last = (
                shard.delivered_total,
                shard.duplicates_suppressed,
            )

    # ---- introspection / lifecycle ----

    def checkpoint_state(self):
        """CheckpointManager view contract: (cursor, state). The cursor
        is the lowest main-log offset any shard's recovery marker scan
        could need — compaction must never delete the redelivery-dedup
        window out from under a restarting shard. A fully drained shard
        (lag 0: cursor saved past every WAL entry, nothing left to
        redeliver) needs no window at all and reports the log's end, so
        idle shards never pin compaction at offset 0 forever."""
        cursors = [
            s._saved_main_offset if s.lag > 0 else self.main_log.end_offset
            for s in self.shards
        ]
        return (min(cursors) if cursors else 0, {})

    def snapshot(self) -> dict:
        doc = {
            "shards": [
                {
                    "shard": s.index,
                    "lag": s.lag,
                    "delivered": s.delivered_total,
                    "duplicates_suppressed": s.duplicates_suppressed,
                    "restarts": s.restarts,
                    "partitioned": s.partitioned(),
                }
                for s in self.shards
            ],
            "deadline_drops": dict(self.deadline_drops),
        }
        if self.admission is not None:
            doc.update(self.admission.snapshot())
        return doc

    def close(self) -> None:
        for shard in self.shards:
            close = getattr(shard.wal, "close", None)
            if close is not None:
                close()
