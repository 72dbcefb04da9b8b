"""Generic ingest pipeline: consume -> batch -> merge -> convert -> sink.

The reference funnels every materialized view through one pipeline shape
(internal/common/ingest/ingestion_pipeline.go:64,115):
consume from Pulsar, unmarshal, batch by size/time, merge operations that
commute, convert to the view's op type, write to the sink, ack — giving
at-least-once delivery with idempotent sinks, plus topic-lag monitoring
(topic_delay_monitor.go).

In-process redesign: the durable event log replaces the broker and a
monotone cursor replaces acks. `sync()` is pull-based like every other
consumer here (the scheduler ingester, the lookout store), so services
control when ingestion work happens relative to their cycles; a crash
before `commit_cursor` replays the batch on restart — the same
at-least-once contract, so sinks must stay idempotent.
"""

from __future__ import annotations

import time


class IngestPipeline:
    """One materialized view's ingestion loop.

    convert(entries) -> ops     pure: [LogEntry] to the view's op batch
    merge(ops, more) -> ops     optional: coalesce commuting op batches
                                (dbops.go:153 merge rules analogue)
    sink(ops)                   idempotent apply into the view
    """

    def __init__(
        self,
        log,
        convert,
        sink,
        *,
        merge=None,
        batch_size: int = 500,
        max_batch_delay_s: float = 0.0,
        start_cursor: int = 0,
    ):
        self.log = log
        self.convert = convert
        self.sink = sink
        self.merge = merge
        self.batch_size = batch_size
        self.max_batch_delay_s = max_batch_delay_s
        self.cursor = start_cursor
        self.batches_applied = 0
        self._pending_since: float | None = None

    @property
    def lag_events(self) -> int:
        """Entries behind the log end (topic_delay_monitor.go lag gauge)."""
        return max(0, self.log.end_offset - self.cursor)

    def sync(self, max_batches: int = 1_000_000) -> int:
        """Drain up to max_batches batches; returns entries applied.

        With max_batch_delay_s > 0, a partial batch is held back until the
        delay elapses (the reference's size-or-time batcher, batch.go) so
        high-frequency callers still write the sink in efficient batches.
        """
        applied = 0
        for _ in range(max_batches):
            entries = self.log.read(self.cursor, self.batch_size)
            if not entries:
                self._pending_since = None
                break
            if (
                len(entries) < self.batch_size
                and self.max_batch_delay_s > 0
            ):
                now = time.monotonic()
                if self._pending_since is None:
                    self._pending_since = now
                if now - self._pending_since < self.max_batch_delay_s:
                    break  # wait for the batch to fill or the delay to pass
            self._pending_since = None
            ops = self.convert(entries)
            if self.merge is not None:
                ops = self.merge(ops)
            self.sink(ops)
            # Cursor advances only after the sink returns: a crash replays
            # this batch (at-least-once; sinks are idempotent).
            self.cursor = entries[-1].offset + 1
            self.batches_applied += 1
            applied += len(entries)
            if len(entries) < self.batch_size:
                break
        return applied
