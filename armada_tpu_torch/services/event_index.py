"""Event-stream index: the per-jobset materialized view feeding watchers.

The reference's event ingester (internal/eventingester/
{ingester.go,store/eventstore.go:24-46}) converts the firehose into
per-jobset Redis streams with sequence ids and a retention policy, so
`armadactl watch` readers never scan unrelated traffic. Same role here:
an IngestPipeline consumer materializes {(queue, jobset): [offsets]} with
its own cursor, the watch RPC reads only its jobset's offsets, and
retention trims whole jobsets that have gone quiet.

O(log) work happens once in the indexer instead of once per watcher; a
watcher resuming from offset k binary-searches the jobset's offset list
instead of replaying the log from k.
"""

from __future__ import annotations

import bisect
import threading

from ..events.pipeline import IngestPipeline


class EventStreamIndex:
    def __init__(self, log, *, batch_size: int = 1000, checkpoint=None):
        self.log = log
        self._lock = threading.Lock()
        # (queue, jobset) -> sorted list of log offsets holding its events.
        self._streams: dict[tuple, list[int]] = {}
        # (queue, jobset) -> created ts of the jobset's last event, for
        # retention (eventstore retention policy).
        self._last_activity: dict[tuple, float] = {}
        # Log offset below which the index cannot prove completeness for
        # keys it (re-)created after a retention prune: set by prune(),
        # consulted by offsets_from. A key holding offsets from BEFORE the
        # watermark provably survived every prune, so it stays
        # authoritative from zero.
        self._pruned_through = 0
        start_cursor = 0
        if checkpoint is not None:
            # Bounded restart (services/checkpoint.py): seed the index,
            # replay only the suffix.
            start_cursor, state = checkpoint
            start_cursor = state.get("ingest_cursor", start_cursor)
            self._streams.update(state["streams"])
            self._last_activity.update(state["last_activity"])
            self._pruned_through = state["pruned_through"]
        self._pipeline = IngestPipeline(
            log,
            self._convert,
            self._sink,
            batch_size=batch_size,
            start_cursor=max(start_cursor, log.start_offset),
        )
        # Serializes concurrent sync() callers (every watcher thread pumps
        # the view); the sink stays idempotent regardless.
        self._sync_lock = threading.Lock()

    def checkpoint_state(self):
        with self._lock:
            # The index stores OFFSETS into the log; the bodies live in the
            # log itself. The checkpoint cursor must therefore pin
            # compaction at the oldest offset any live stream still
            # references (not the ingest cursor) — prune() drops quiet
            # jobsets after retention, releasing the pin, so compaction
            # trails retention for watched history.
            referenced = [b[0] for b in self._streams.values() if b]
            pin = min([self._pipeline.cursor] + referenced)
            return pin, {
                "streams": {k: list(v) for k, v in self._streams.items()},
                "last_activity": dict(self._last_activity),
                "pruned_through": self._pruned_through,
                # Restore resumes ingest here (the pin above only gates
                # compaction; re-ingesting from it would be wasted work).
                "ingest_cursor": self._pipeline.cursor,
            }

    # ---- pipeline stages ----

    @staticmethod
    def _convert(entries):
        ops: dict[tuple, list[int]] = {}
        activity: dict[tuple, float] = {}
        for entry in entries:
            seq = entry.sequence
            key = (seq.queue, seq.jobset)
            ops.setdefault(key, []).append(entry.offset)
            for event in seq.events:
                created = getattr(event, "created", 0.0)
                if created:
                    activity[key] = max(activity.get(key, 0.0), created)
        return (ops, activity)

    def _sink(self, ops):
        stream_ops, activity = ops
        with self._lock:
            for key, offsets in stream_ops.items():
                bucket = self._streams.setdefault(key, [])
                # Idempotent under at-least-once replay: offsets are
                # monotone per batch, so drop any already-indexed tail.
                start = 0
                if bucket:
                    while (
                        start < len(offsets) and offsets[start] <= bucket[-1]
                    ):
                        start += 1
                bucket.extend(offsets[start:])
            for key, ts in activity.items():
                if ts > self._last_activity.get(key, 0.0):
                    self._last_activity[key] = ts

    # ---- consumer API ----

    def sync(self) -> int:
        with self._sync_lock:
            return self._pipeline.sync()

    @property
    def lag_events(self) -> int:
        return self._pipeline.lag_events

    def offsets_from(self, queue: str, jobset: str, cursor: int, limit: int = 1000):
        """Offsets >= cursor for one jobset (the per-stream read that
        replaces scanning the whole log), or None when the jobset is not in
        the index (never seen, or pruned by retention) — callers must fall
        back to the log scan in that case, because the log may still hold
        the history the index dropped."""
        with self._lock:
            bucket = self._streams.get((queue, jobset))
            if bucket is None:
                return None
            if cursor < self._pruned_through and (
                not bucket or bucket[0] >= self._pruned_through
            ):
                # The key only has post-prune offsets, so it may be a
                # re-created jobset whose earlier history was pruned; the
                # log, not the index, must answer reads from before the
                # watermark. (A genuinely-new jobset pays one log scan
                # until its watcher advances past the watermark.)
                return None
            i = bisect.bisect_left(bucket, cursor)
            return list(bucket[i : i + limit])

    def read_from(self, queue: str, jobset: str, cursor: int, limit: int = 1000):
        """(offset, EventSequence) pairs for one jobset from cursor; None
        when the jobset is unknown to the index (see offsets_from)."""
        offsets = self.offsets_from(queue, jobset, cursor, limit)
        if offsets is None:
            return None
        # Offsets below the log's compaction point can linger when an
        # external compact() outran this index's checkpoint pin (a
        # mis-wired deployment): skip them instead of crashing the stream.
        start = getattr(self.log, "start_offset", 0)
        out = []
        for offset in offsets:
            if offset < start:
                continue
            entries = self.log.read(offset, 1)
            if entries and entries[0].offset == offset:
                out.append((offset, entries[0].sequence))
        return out

    def prune(self, older_than: float) -> int:
        """Drop jobsets whose last event predates `older_than` (the
        reference's per-jobset retention)."""
        with self._lock:
            # Keys with no recorded activity (events without created
            # timestamps, e.g. control-plane settings) age out too — they
            # would otherwise pin log compaction forever.
            stale = [
                key
                for key in self._streams
                if self._last_activity.get(key, 0.0) < older_than
            ]
            for key in stale:
                self._streams.pop(key, None)
                self._last_activity.pop(key, None)
            if stale:
                self._pruned_through = max(
                    self._pruned_through, self._pipeline.cursor
                )
            return len(stale)
