"""Tracing hooks.

Plays the role of internal/common/observability/ (OTel init, wired at
schedulerapp.go:63-70): lightweight in-process spans with structured-log
export (the span API is OTel-shaped).

Cross-process propagation is W3C Trace Context: `Span.traceparent`
formats the header and `Tracer.span(remote_parent=...)` adopts one, so
one trace id follows a job submit -> ingest -> round -> lease ->
run-report. Span export to a file (the JAX package's
OtlpJsonFileExporter) and the CPU profile capture wait for the flight
recorder slice (ROADMAP A7.7).
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from dataclasses import dataclass, field

# W3C Trace Context (https://www.w3.org/TR/trace-context/): the header
# key and the version-00 `traceparent` shape. Stamped onto
# EventSequences, so one trace id spans submit -> ingest -> round ->
# lease -> run-report.
TRACEPARENT_HEADER = "traceparent"
_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def format_traceparent(trace_id: str, span_id: str) -> str:
    """version 00, sampled flag set (we record everything we trace)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: str | None) -> tuple[str, str] | None:
    """(trace_id, parent_span_id) from a traceparent header, or None on
    anything malformed — a bad header must start a fresh trace, never
    crash the RPC carrying it."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    # All-zero ids are explicitly invalid per the spec.
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id


# Per-thread registry of OPEN spans across every Tracer instance: the
# logging layer (utils/logging.py) stamps the current trace id on every
# record, and a process may run several tracers at once (the process
# default plus any a caller makes) — log
# correlation must not care which instance opened the active span.
_ACTIVE_SPANS = threading.local()


def _active_stack() -> list:
    stack = getattr(_ACTIVE_SPANS, "stack", None)
    if stack is None:
        stack = _ACTIVE_SPANS.stack = []
    return stack


def current_trace_id() -> str:
    """Trace id of this thread's innermost open span, whichever Tracer
    opened it ("" outside any span) — what the JSON log formatter
    stamps on every record so log lines join the job-journey trace."""
    stack = _active_stack()
    return stack[-1].trace_id if stack else ""


def current_span_id() -> str:
    """Span id of this thread's innermost open span ("" outside)."""
    stack = _active_stack()
    return stack[-1].span_id if stack else ""


@dataclass
class Span:
    name: str
    start: float
    attrs: dict = field(default_factory=dict)
    end: float | None = None
    parent: str = ""
    # Wall-clock epoch ns at start (exporters need absolute time; the
    # monotonic pair above is for durations).
    start_unix_ns: int = 0
    span_id: str = ""
    parent_id: str = ""
    trace_id: str = ""

    @property
    def duration_s(self) -> float:
        return (self.end or time.monotonic()) - self.start

    @property
    def traceparent(self) -> str:
        """This span's context as a W3C traceparent header value."""
        return format_traceparent(self.trace_id, self.span_id)


class Tracer:
    """Per-process tracer: span stack per thread, ring buffer of finished
    spans, optional logger export."""

    def __init__(self, logger=None, keep: int = 1024):
        self.logger = logger
        self.keep = keep
        self.finished: list[Span] = []
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def current_span(self) -> Span | None:
        """This thread's innermost open span, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    def current_traceparent(self) -> str:
        """W3C traceparent of the current span ("" outside any span) —
        what gRPC clients inject into call metadata."""
        s = self.current_span()
        return s.traceparent if s is not None else ""

    @contextlib.contextmanager
    def span(self, name: str, remote_parent: str | None = None, **attrs):
        """Open a span. `remote_parent` is a W3C traceparent header value
        from the wire: when there is no local parent span, the new span
        joins that remote trace instead of opening a fresh one (the
        server-side half of context propagation). A local parent always
        wins — nesting inside this process is already one trace."""
        import secrets

        stack = self._stack()
        parent = stack[-1] if stack else None
        trace_id = parent.trace_id if parent else ""
        parent_id = parent.span_id if parent else ""
        if parent is None:
            remote = parse_traceparent(remote_parent)
            if remote is not None:
                trace_id, parent_id = remote
        s = Span(
            name=name,
            start=time.monotonic(),
            attrs=attrs,
            parent=parent.name if parent else "",
            start_unix_ns=time.time_ns(),
            span_id=secrets.token_hex(8),
            parent_id=parent_id,
            # Root spans open a new trace; children inherit it.
            trace_id=trace_id or secrets.token_hex(16),
        )
        stack.append(s)
        _active_stack().append(s)
        try:
            yield s
        finally:
            s.end = time.monotonic()
            stack.pop()
            _active_stack().pop()
            self._finish(s)
            if self.logger is not None:
                self.logger.with_fields(
                    span=name, parent=s.parent,
                    duration_ms=round(s.duration_s * 1e3, 2),
                    **attrs,
                ).debug("span finished")

    def add_span(
        self,
        name: str,
        *,
        start_unix_ns: int,
        duration_s: float,
        parent: Span | None = None,
        **attrs,
    ) -> Span:
        """Record an already-finished span post hoc (e.g. the solve
        profile's setup/pass1/gather/finish segments, measured inside the
        kernel driver and emitted as children of the round span after the
        solve returns). Timestamps are the caller's; the span lands in
        the ring buffer like any other."""
        import secrets

        now = time.monotonic()
        s = Span(
            name=name,
            start=now - duration_s,
            end=now,
            attrs=attrs,
            parent=parent.name if parent else "",
            start_unix_ns=int(start_unix_ns),
            span_id=secrets.token_hex(8),
            parent_id=parent.span_id if parent else "",
            trace_id=parent.trace_id if parent else secrets.token_hex(16),
        )
        self._finish(s)
        return s

    def _finish(self, s: Span) -> None:
        with self._lock:
            self.finished.append(s)
            if len(self.finished) > self.keep:
                del self.finished[: len(self.finished) - self.keep]

    def summary(self) -> dict:
        """Aggregate durations by span name (count, total, max)."""
        with self._lock:
            spans = list(self.finished)
        out: dict[str, dict] = {}
        for s in spans:
            bucket = out.setdefault(
                s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            bucket["count"] += 1
            bucket["total_s"] += s.duration_s
            bucket["max_s"] = max(bucket["max_s"], s.duration_s)
        return out


# Process-wide default tracer (observability.Init analogue).
TRACER = Tracer()

# The solve profile's segment order (solver/kernel.solve_round's
# `profile` block keys, minus the `_s` suffix).
SOLVE_SEGMENTS = ("setup", "pass1", "gather", "finish")


def add_segment_spans(tracer: Tracer, parent, start_unix_ns: int,
                      profile: dict, prefix: str = "solve",
                      segments=SOLVE_SEGMENTS, **attrs) -> int:
    """Sequential child spans from a `{seg}_s` duration dict: each
    segment starts where the previous ended (the scheduler's round
    spans). Returns the ns cursor after the last
    segment."""
    at = int(start_unix_ns)
    for seg in segments:
        dur = float(profile.get(f"{seg}_s", 0.0))
        tracer.add_span(f"{prefix}.{seg}", start_unix_ns=at,
                        duration_s=dur, parent=parent, **attrs)
        at += int(dur * 1e9)
    return at
