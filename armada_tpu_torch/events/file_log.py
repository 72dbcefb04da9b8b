"""Durable file-backed event log: the checkpoint/resume story.

In the reference "the event log IS the checkpoint": all state transitions
are EventSequences in Pulsar; databases are materialized views with serial
cursors, and a restarted scheduler replays from its cursor
(internal/scheduler/scheduler.go:1286,441; SURVEY §5).
FileEventLog gives the same durability in-process: append-only segmented
JSONL files with fsync batching, crc-checked records, offset-addressed
reads, and recovery that truncates a torn tail record. A restarted process
reconstructs every materialized view (jobdb, query API) by replaying.

Record format (one line per EventSequence):
  {"o": offset, "c": crc32-of-payload, "s": payload}

This is the port's copy of the JAX package's events/file_log.py. Its
codec writes the same records from the port's event classes (the same
names and fields), so either package reads the other's directory.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from dataclasses import asdict

from ..core.types import (
    Affinity,
    Gang,
    IngressConfig,
    JobSpec,
    MatchExpression,
    NodeSelectorTerm,
    ServiceConfig,
    Toleration,
)
from . import model
from .log import EventLog, LogEntry
from .model import EventSequence

# Derived from the model module so new event types can never go missing
# from the codec (a decode failure must mean corruption, not drift).
_EVENT_TYPES = {
    name: obj
    for name, obj in vars(model).items()
    if isinstance(obj, type) and issubclass(obj, model.Event) and obj is not model.Event
}


class CorruptLogError(RuntimeError):
    """Mid-log corruption: refuse to start rather than drop records."""


class InjectedFault(RuntimeError):
    """A fault-injection hook fired (services/chaos.py): the append was
    deliberately torn mid-record to simulate a crash. The partial bytes
    are on disk; recovery truncates them on the next open."""


class CompactedLogError(RuntimeError):
    """Read below the compaction point: the caller must bootstrap from a
    view checkpoint instead of replaying from offset 0 (the reference's
    equivalent: scheduler state lives in Postgres views with serials, and
    Pulsar retention drops acknowledged history; scheduler.go:441)."""


def _encode_event(event) -> dict:
    d = asdict(event)
    d["_t"] = type(event).__name__
    return d


def _decode_event(d: dict):
    cls = _EVENT_TYPES[d.pop("_t")]
    if cls is model.SubmitJob and d.get("job") is not None:
        j = d["job"]
        gang = j.get("gang")
        d["job"] = JobSpec(
            id=j["id"],
            queue=j["queue"],
            jobset=j.get("jobset", ""),
            priority=j.get("priority", 0),
            priority_class=j.get("priority_class", ""),
            requests=j.get("requests", {}),
            node_selector=j.get("node_selector", {}),
            tolerations=tuple(Toleration(**t) for t in j.get("tolerations", ())),
            affinity=(
                Affinity(
                    terms=tuple(
                        NodeSelectorTerm(
                            expressions=tuple(
                                MatchExpression(
                                    key=e["key"],
                                    operator=e["operator"],
                                    values=tuple(e.get("values", ())),
                                )
                                for e in term.get("expressions", ())
                            )
                        )
                        for term in j["affinity"].get("terms", ())
                    )
                )
                if j.get("affinity")
                else None
            ),
            gang=Gang(**gang) if gang else None,
            submitted_ts=j.get("submitted_ts", 0.0),
            annotations=j.get("annotations", {}),
            bid_prices=j.get("bid_prices", {}),
            command=tuple(j.get("command", ())),
            services=tuple(
                ServiceConfig.from_obj(s) for s in j.get("services", ())
            ),
            ingresses=tuple(
                IngressConfig.from_obj(i) for i in j.get("ingresses", ())
            ),
        )
    return cls(**d)


class FileEventLog(EventLog):
    """Append-only segmented log on local disk.

    fsync policy: every `sync_every` appends or on explicit flush();
    at-least-once consumers tolerate the tail loss window like the
    reference tolerates unacked Pulsar messages.
    """

    def __init__(
        self,
        directory: str,
        segment_size: int = 50_000,
        sync_every: int = 64,
        fault_injector=None,
    ):
        self.dir = directory
        self.segment_size = segment_size
        self.sync_every = sync_every
        # Chaos hook (services/chaos.py): called with the encoded record
        # length before each append; a non-None return is the number of
        # bytes to write before raising InjectedFault (a simulated crash
        # mid-write, leaving a torn tail for recovery to truncate). The
        # instance is poisoned afterwards — reopen to recover.
        self.fault_injector = fault_injector
        self._poisoned = False
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._watchers: list[threading.Condition] = []
        self._entries: list[LogEntry] = []  # in-memory suffix [base..end)
        self._base = 0  # offset of _entries[0]: advanced by compact()
        # (filename, first offset) per live segment, recovery order.
        self._seg_starts: list[tuple[str, int]] = []
        self._seg_count = 0  # records in the open segment (rollover)
        self._fh = None
        self._unsynced = 0
        self._recover()

    # ---- recovery ----

    def _segments(self) -> list[str]:
        # Numeric sort: offset-named segments (12-digit) and legacy
        # index-named ones (8-digit) interleave correctly only by value —
        # lexicographic order breaks across the width change.
        return sorted(
            (
                f
                for f in os.listdir(self.dir)
                if f.startswith("seg-") and f.endswith(".log")
            ),
            key=lambda f: int(f[4:-4]),
        )

    def _marker_path(self) -> str:
        return os.path.join(self.dir, "compacted")

    def _recover(self):
        # The compaction marker records where surviving history starts;
        # segments whose names (first offsets) sort below it were deleted
        # by compact(). A gap between the marker and the first record is
        # real corruption (manually deleted segments), not compaction.
        try:
            with open(self._marker_path()) as f:
                self._base = int(f.read().strip() or 0)
        except FileNotFoundError:
            pass
        segments = self._segments()
        for seg_idx, seg in enumerate(segments):
            path = os.path.join(self.dir, seg)
            with open(path, "rb") as f:
                lines = f.readlines()
            # A segment whose records lie below the marker is leftover from
            # a compact() killed between writing the marker and deleting
            # files: finish the deletion. (Segments never straddle the
            # marker — it is always some segment's first offset.)
            if lines and not self._entries:
                first_off = None
                try:
                    first_off = json.loads(lines[0])["o"]
                except (json.JSONDecodeError, KeyError, TypeError):
                    pass
                if first_off is not None and first_off < self._base:
                    os.remove(path)
                    continue
            good_bytes = 0
            self._seg_count = 0
            seg_start = self._base + len(self._entries)
            self._seg_starts.append((seg, seg_start))
            for line_idx, line in enumerate(lines):
                bad = None
                next_off = self._base + len(self._entries)
                if not line.endswith(b"\n"):
                    # Crash lost the newline: even if the record parses, the
                    # next append would concatenate onto this line.
                    bad = "no trailing newline"
                else:
                    try:
                        rec = json.loads(line)
                        payload = rec["s"]
                        if zlib.crc32(json.dumps(payload).encode()) != rec["c"]:
                            bad = "crc mismatch"
                        elif rec["o"] != next_off:
                            bad = f"offset gap: {rec['o']} != {next_off}"
                        else:
                            seq = EventSequence(
                                queue=payload["q"],
                                jobset=payload["j"],
                                events=tuple(
                                    _decode_event(e) for e in payload["e"]
                                ),
                                user=payload.get("u", ""),
                                traceparent=payload.get("tp", ""),
                                ingest_marker=payload.get("im", ""),
                            )
                    except (json.JSONDecodeError, KeyError, TypeError) as e:
                        bad = f"undecodable record: {e!r}"
                if bad is None:
                    self._entries.append(LogEntry(offset=next_off, sequence=seq))
                    good_bytes += len(line)
                    self._seg_count += 1
                    continue
                # A bad record is only a recoverable torn tail when it is
                # the final line of the final segment; anywhere else it is
                # corruption and truncating would destroy good records.
                is_tail = (
                    seg_idx == len(segments) - 1 and line_idx == len(lines) - 1
                )
                if not is_tail:
                    raise CorruptLogError(f"{path}:{line_idx}: {bad}")
                with open(path, "ab") as f:
                    f.truncate(good_bytes)
                return

    # ---- appends ----

    def _open_segment(self):
        # Segments are named by their first offset (not an index times a
        # size): recovery and compaction then never depend on segment_size
        # staying constant across restarts.
        first = self._base + len(self._entries)
        name = f"seg-{first:012d}.log"
        if self._fh is not None:
            # fsync before rollover: a later-fsynced successor segment must
            # never survive a tail loss in its predecessor (that would be a
            # mid-log gap, which recovery refuses to repair).
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._unsynced = 0
            self._fh.close()
            self._seg_starts.append((name, first))
            self._seg_count = 0
        elif not self._seg_starts:
            self._seg_starts.append((name, first))
        elif self._seg_count >= self.segment_size:
            # Re-opening after recovery with the last segment already at
            # the bound: start a fresh offset-named segment instead of
            # growing the full one by one record per restart.
            self._seg_starts.append((name, first))
            self._seg_count = 0
        else:
            # Re-opening after recovery: append to the last live segment.
            name = self._seg_starts[-1][0]
        self._fh = open(os.path.join(self.dir, name), "ab")

    def publish(self, sequence: EventSequence) -> int:
        with self._lock:
            if self._poisoned:
                # Before touching any file handle: a poisoned instance
                # must never reopen the torn segment in append mode.
                raise InjectedFault(
                    "log instance crashed on an injected torn write; "
                    "reopen the directory to recover"
                )
            offset = self._base + len(self._entries)
            if self._fh is None or self._seg_count >= self.segment_size:
                self._open_segment()
            payload = {
                "q": sequence.queue,
                "j": sequence.jobset,
                "u": sequence.user,
                "e": [_encode_event(e) for e in sequence.events],
            }
            if sequence.traceparent:
                # Written only when set: untraced publishers keep the
                # historical record shape (and crc) byte-for-byte.
                payload["tp"] = sequence.traceparent
            if getattr(sequence, "ingest_marker", ""):
                # Front-door delivery marker (same only-when-set rule).
                payload["im"] = sequence.ingest_marker
            rec = {
                "o": offset,
                "c": zlib.crc32(json.dumps(payload).encode()),
                "s": payload,
            }
            data = json.dumps(rec).encode() + b"\n"
            if self.fault_injector is not None:
                torn = self.fault_injector(len(data))
                if torn is not None:
                    # Simulated crash mid-write: the torn bytes STAY on
                    # disk (unlike the OSError rollback below) — exactly
                    # what a killed process leaves for recovery. The
                    # instance is dead from here (a real crash kills the
                    # process): further appends on it would concatenate
                    # onto the torn fragment and corrupt the log mid-file,
                    # so they fail loudly instead.
                    self._fh.write(data[:torn])
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._fh.close()
                    self._fh = None
                    self._poisoned = True
                    raise InjectedFault(
                        f"torn write: {torn}/{len(data)} bytes of record "
                        f"{offset}"
                    )
            # On a partial write (e.g. ENOSPC) roll the file back to the
            # record boundary so a later append can't concatenate onto torn
            # bytes mid-file.
            pos = self._fh.tell()
            try:
                self._fh.write(data)
            except OSError:
                self._fh.truncate(pos)
                raise
            self._unsynced += 1
            if self._unsynced >= self.sync_every:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._unsynced = 0
            else:
                self._fh.flush()
            self._entries.append(LogEntry(offset=offset, sequence=sequence))
            self._seg_count += 1
        for cond in list(self._watchers):
            with cond:
                cond.notify_all()
        return offset

    def flush(self):
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._unsynced = 0

    # ---- reads (same surface as InMemoryEventLog) ----

    def read(self, cursor: int, limit: int = 1000) -> list[LogEntry]:
        with self._lock:
            if cursor < self._base:
                raise CompactedLogError(
                    f"offset {cursor} is below the compaction point "
                    f"{self._base}; bootstrap this view from a checkpoint"
                )
            i = cursor - self._base
            return self._entries[i : i + limit]

    def read_jobset(self, queue: str, jobset: str, cursor: int = 0) -> list[LogEntry]:
        with self._lock:
            # History below the compaction point is gone; jobset watchers
            # see the surviving suffix (compaction trails view checkpoints
            # AND the terminal-retention window, so what is missing is
            # pruned-jobset history).
            i = max(cursor, self._base) - self._base
            return [
                e
                for e in self._entries[i:]
                if e.sequence.queue == queue and e.sequence.jobset == jobset
            ]

    @property
    def end_offset(self) -> int:
        with self._lock:
            return self._base + len(self._entries)

    @property
    def start_offset(self) -> int:
        """First readable offset (> 0 once compacted)."""
        with self._lock:
            return self._base

    def compact(self, up_to: int) -> int:
        """Delete whole segments that lie entirely below `up_to` (callers
        pass the min checkpointed cursor across all views — the analogue of
        the reference relying on Postgres views + Pulsar retention, and of
        the lookout pruner, internal/lookout/pruner/pruner.go). The active
        segment is never removed. Returns the number of segments deleted."""
        removed = 0
        with self._lock:
            # A segment is removable when its successor starts at or below
            # up_to (so every record in it is below up_to) and it is not
            # the active (last) segment.
            keep = 0
            while (
                keep + 1 < len(self._seg_starts)
                and self._seg_starts[keep + 1][1] <= up_to
            ):
                keep += 1
            if keep == 0:
                return 0
            new_base = self._seg_starts[keep][1]
            # Durable marker BEFORE deleting: recovery distinguishes
            # compaction from manually-deleted segments by it.
            tmp = self._marker_path() + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(new_base))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._marker_path())
            for name, _ in self._seg_starts[:keep]:
                os.remove(os.path.join(self.dir, name))
                removed += 1
            self._seg_starts = self._seg_starts[keep:]
            self._entries = self._entries[new_base - self._base :]
            self._base = new_base
        return removed

    def watcher(self) -> threading.Condition:
        cond = threading.Condition()
        self._watchers.append(cond)
        return cond

    def remove_watcher(self, cond: threading.Condition):
        try:
            self._watchers.remove(cond)
        except ValueError:
            pass

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None
