"""Structured logging for the control plane.

The reference threads cycleNumber/stage fields through its contexts
(armadacontext, scheduler.go:175, preempting_queue_scheduler.go:93). Here a
stdlib-logging adapter carries the same structured fields, and the default
handler renders each record as ONE JSON object stamped with the current
trace id (utils/tracing.current_trace_id — whichever tracer opened the
active span): a scheduler-cycle log line carries the same trace id as the
round span and any job journeys it produced, so logs join the PR-7
job-journey correlation instead of being a disconnected text stream.

ARMADA_LOG_FORMAT=kv switches back to the human-first key=value rendering
(same fields, no JSON) for interactive runs.
"""

from __future__ import annotations

import json
import logging
import os
import sys


class _KvFormatter(logging.Formatter):
    def format(self, record):
        base = super().format(record)
        extras = getattr(record, "kv", None)
        from .tracing import current_trace_id

        trace_id = current_trace_id()
        if trace_id:
            base = f"{base} trace_id={trace_id}"
        if extras:
            kv = " ".join(f"{k}={v}" for k, v in extras.items())
            return f"{base} {kv}"
        return base


class _JsonFormatter(logging.Formatter):
    """One JSON object per record: timestamp, level, logger, rendered
    message, bound structured fields, and the active trace id. The
    trace id is resolved at EMIT time from the cross-tracer registry —
    a log line inside scheduler.cycle/scheduler.round (or any gRPC
    server span) lands in the same trace as the spans around it."""

    def format(self, record):
        from .tracing import current_trace_id

        doc = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        trace_id = current_trace_id()
        if trace_id:
            doc["trace_id"] = trace_id
        extras = getattr(record, "kv", None)
        if extras:
            for key, value in extras.items():
                if key not in doc:
                    doc[key] = value
        if record.exc_info and record.exc_info[0] is not None:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


def _make_formatter() -> logging.Formatter:
    if os.environ.get("ARMADA_LOG_FORMAT", "json").lower() == "kv":
        return _KvFormatter("%(asctime)s %(levelname)s %(name)s %(message)s")
    return _JsonFormatter()


def get_logger(name: str = "armada_tpu_torch", **fields) -> "StructuredLogger":
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_make_formatter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return StructuredLogger(logger, fields)


class StructuredLogger:
    """Logger with bound fields (the WithLogField pattern)."""

    def __init__(self, logger: logging.Logger, fields: dict):
        self._logger = logger
        self._fields = dict(fields)

    def with_fields(self, **fields) -> "StructuredLogger":
        merged = {**self._fields, **fields}
        return StructuredLogger(self._logger, merged)

    def _log(self, level, msg, *args):
        self._logger.log(level, msg, *args, extra={"kv": self._fields})

    def info(self, msg, *args):
        self._log(logging.INFO, msg, *args)

    def warning(self, msg, *args):
        self._log(logging.WARNING, msg, *args)

    def error(self, msg, *args):
        self._log(logging.ERROR, msg, *args)

    def debug(self, msg, *args):
        self._log(logging.DEBUG, msg, *args)
