"""Convert span exports and flight-recorder bundles to Perfetto.

Two input kinds, one output: the Chrome trace-event JSON format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
that ui.perfetto.dev and chrome://tracing load directly.

  - OTLP-JSON span files (`utils/tracing.OtlpJsonFileExporter` output:
    one resourceSpans batch per line) — scheduler cycle/round/solve
    spans, simulator runs (Simulator(span_path=...)). Spans become complete ("X") events,
    one track per trace id, so a whole run's rounds and their
    setup/pass1/gather/finish segments render as a timeline.

  - `.atrace` flight-recorder bundles (armada_tpu_torch/trace, or the
    JAX package's, which the port's codec reads): each recorded
    round becomes a slice on its pool's track (solve wall clock wide,
    laid out sequentially when the bundle carries no timestamps), with
    the per-segment solve profile as child slices and counter tracks
    for jobs considered and pass-1 loops.

The port's counterpart of the JAX package's `tools/trace2perfetto.py`.
Usage:
  python -m armada_tpu_torch.tools.trace2perfetto run.otlp.jsonl -o run.perfetto.json
  python -m armada_tpu_torch.tools.trace2perfetto sim.atrace spans.otlp.jsonl -o all.json
  python -m armada_tpu_torch.tools.trace2perfetto --check   # fixture round-trip gate

--check converts the committed tests/fixtures/sim_steady.atrace and
validates the output is well-formed trace-event JSON with one slice per
recorded round — the guard that keeps this converter from rotting
against the .atrace codec.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIXTURE = os.path.join(REPO, "tests", "fixtures", "sim_steady.atrace")

# Required keys of every emitted duration event; --check and the tier-1
# test validate each event against this.
REQUIRED_X_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


def _meta(pid: int, name: str, tid: int | None = None,
          thread_name: str | None = None) -> list[dict]:
    """Metadata events naming the process/thread tracks."""
    out = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": name},
    }]
    if tid is not None:
        out.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": thread_name or str(tid)},
        })
    return out


def convert_otlp(path: str) -> list[dict]:
    """OTLP-JSON lines -> trace events: one complete event per span,
    tracks keyed by trace id (a submit->lease trace reads as one lane)."""
    events: list[dict] = []
    tids: dict[str, int] = {}
    service = "spans"
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                batch = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln + 1}: not OTLP-JSON: {e}") from e
            for resource in batch.get("resourceSpans", ()):
                for attr in resource.get("resource", {}).get("attributes", ()):
                    if attr.get("key") == "service.name":
                        service = attr["value"].get("stringValue", service)
                for scope in resource.get("scopeSpans", ()):
                    for span in scope.get("spans", ()):
                        trace_id = span.get("traceId", "")
                        tid = tids.setdefault(trace_id, len(tids) + 1)
                        start = int(span["startTimeUnixNano"])
                        end = int(span["endTimeUnixNano"])
                        events.append({
                            "name": span.get("name", "span"),
                            "cat": "span",
                            "ph": "X",
                            "ts": start / 1e3,  # trace-event time is µs
                            "dur": max(end - start, 0) / 1e3,
                            "pid": 1,
                            "tid": tid,
                            "args": {
                                a["key"]: a["value"].get("stringValue", "")
                                for a in span.get("attributes", ())
                            } | {"trace_id": trace_id,
                                 "span_id": span.get("spanId", "")},
                        })
    meta = _meta(1, f"{service} (OTLP spans)")
    for trace_id, tid in tids.items():
        meta += _meta(1, service, tid, f"trace {trace_id[:8]}")
    return meta + events


def convert_atrace(path: str) -> list[dict]:
    """Flight-recorder bundle -> trace events: one slice per recorded
    round on its pool's track. Rounds carry durations (solve_s) but not
    always wall-clock instants, so slices lay out sequentially per pool
    — the timeline shows relative cost, which is what the bundle
    records."""
    from ..trace import load_trace

    trace = load_trace(path)
    source = trace.header.get("source", "atrace")
    pool_tids: dict[str, int] = {}
    events: list[dict] = []
    cursor_us: dict[str, float] = {}
    for r in trace.rounds:
        raw = r.raw
        pool = r.pool or "default"
        tid = pool_tids.setdefault(pool, len(pool_tids) + 1)
        solve_s = float(raw.get("solve_s") or 0.0) or 1e-3
        now = raw.get("now")
        ts_us = (
            float(now) * 1e6 if now is not None
            else cursor_us.get(pool, 0.0)
        )
        dur_us = solve_s * 1e6
        cursor_us[pool] = ts_us + dur_us
        solver = raw.get("solver") or {}
        events.append({
            "name": f"round[{raw.get('i', 0)}]",
            "cat": "round",
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": 2,
            "tid": tid,
            "args": {
                "pool": pool,
                "cycle": raw.get("cycle"),
                "num_jobs": r.num_jobs,
                "num_queues": r.num_queues,
                "backend": solver.get("backend", ""),
                "truncated": r.truncated,
            },
        })
        profile = raw.get("profile") or {}
        seg_ts = ts_us
        for seg in ("setup", "pass1", "gather", "finish"):
            seg_dur = float(profile.get(f"{seg}_s", 0.0)) * 1e6
            if seg_dur <= 0:
                continue
            events.append({
                "name": f"solve.{seg}",
                "cat": "solve",
                "ph": "X",
                "ts": seg_ts,
                "dur": seg_dur,
                "pid": 2,
                "tid": tid,
                "args": {"pool": pool},
            })
            seg_ts += seg_dur
        loops = None
        if profile:
            loops = sum(
                int(profile.get(f"{kind}_loops", 0))
                for kind in ("gang", "fill", "merged_fill")
            )
        for counter, value in (
            ("jobs considered", r.num_jobs),
            ("pass-1 loops", loops),
        ):
            if value is None:
                continue
            events.append({
                "name": counter,
                "ph": "C",
                "ts": ts_us,
                "pid": 2,
                "tid": tid,
                "args": {pool: value},
            })
    meta = _meta(2, f"flight recorder ({source})")
    for pool, tid in pool_tids.items():
        meta += _meta(2, "rounds", tid, f"pool {pool}")
    return meta + events


def sniff_kind(path: str) -> str:
    """'otlp' or 'atrace', from the first non-empty line."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}: not a JSON-lines file: {e}") from e
            if isinstance(doc, dict) and "resourceSpans" in doc:
                return "otlp"
            return "atrace"
    raise ValueError(f"{path}: empty file")


def convert(paths: list[str]) -> dict:
    events: list[dict] = []
    for path in paths:
        kind = sniff_kind(path)
        events += convert_otlp(path) if kind == "otlp" else convert_atrace(path)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate(doc: dict) -> list[str]:
    """Structural validation of the produced trace-event JSON; returns
    problems (empty = loadable)."""
    problems = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["no traceEvents"]
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in ("X", "M", "C"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph == "X":
            missing = [k for k in REQUIRED_X_KEYS if k not in e]
            if missing:
                problems.append(f"event {i}: missing {missing}")
            elif e["dur"] < 0 or e["ts"] < 0:
                problems.append(f"event {i}: negative time")
    return problems


def check(fixture: str = FIXTURE) -> int:
    """Round-trip the committed fixture bundle; exit 0 only when the
    output is well-formed and covers every recorded round."""
    from ..trace import load_trace

    doc = convert([fixture])
    problems = validate(doc)
    rounds = len(load_trace(fixture).rounds)
    slices = [
        e for e in doc["traceEvents"]
        if e.get("ph") == "X" and e.get("cat") == "round"
    ]
    if len(slices) != rounds:
        problems.append(
            f"{len(slices)} round slices for {rounds} recorded rounds"
        )
    # The JSON must survive an encode/decode round trip (what Perfetto's
    # loader does with the file).
    json.loads(json.dumps(doc))
    if problems:
        for p in problems:
            print(f"check: {p}", file=sys.stderr)
        return 1
    print(
        f"ok: {os.path.basename(fixture)} -> {len(doc['traceEvents'])} "
        f"events covering {rounds} rounds"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("inputs", nargs="*",
                    help="OTLP-JSON span files and/or .atrace bundles")
    ap.add_argument("-o", "--output", default="",
                    help="output path (default: stdout)")
    ap.add_argument("--check", action="store_true",
                    help="round-trip the committed fixture bundle and "
                    "validate the output; exit 1 on problems")
    args = ap.parse_args(argv)
    if args.check:
        return check(args.inputs[0] if args.inputs else FIXTURE)
    if not args.inputs:
        ap.error("no inputs (or pass --check)")
    doc = convert(args.inputs)
    problems = validate(doc)
    if problems:
        for p in problems:
            print(f"invalid output: {p}", file=sys.stderr)
        return 1
    payload = json.dumps(doc)
    if args.output:
        with open(args.output, "w") as f:
            f.write(payload)
        print(
            f"wrote {len(doc['traceEvents'])} events to {args.output} "
            "(load at ui.perfetto.dev)"
        )
    else:
        print(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
