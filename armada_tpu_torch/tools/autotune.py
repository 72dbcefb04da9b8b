"""Offline solver-parameter tuner over a flight-recorder corpus.

The port's counterpart of the JAX package's `tools/autotune.py`, with
the same flags plus `--device`. The tooling analogue of the replay
gate, but instead of gating one
kernel it SEARCHES: every candidate parameter vector (hot-window slots,
engagement floor, budgeted chunk stride) re-solves every recorded round
and must reproduce the recorded decision stream bit-for-bit; qualifying
candidates are timed warm over the whole corpus and the fastest one is
emitted as a tuned profile the scheduler loads at boot
(`autotuneProfile` in the scheduling config, or merged into the
persisted tuning store).

    # tiny smoke grid over the committed fixture corpus, on the CPU
    python -m armada_tpu_torch.tools.autotune tests/fixtures/sim_steady.atrace \
        --windows 2,4 --min-slots 0 --allow-foreign --device cpu --out tuned.json

    # production search on the card: record a corpus first
    # (Simulator(trace_path=...), or scheduler.attach_trace_recorder)
    python -m armada_tpu_torch.tools.autotune burst.atrace --repeats 5 --out tuned.json

Candidates solve on the "cuda" kernel path (the hand-written fill
kernels) on --device (default: the CUDA card).

A bundle recorded on a different target refuses to tune (parameters
timed under different arithmetic/toolchain say nothing about this
host); pass --allow-foreign only for x64-recorded bundles, whose exact
decisions are host-independent — the TIMINGS still describe this host,
which is the point. Exit codes: 0 profile written/printed, 1 any
candidate diverged (a solver bug, not a tuning outcome), 2 unusable
corpus (no rounds, undecodable bundle, target mismatch).
"""

from __future__ import annotations

import argparse
import json
import sys


def _int_list(raw: str) -> list[int]:
    return [int(tok) for tok in raw.split(",") if tok.strip() != ""]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("traces", nargs="+", help=".atrace bundles to tune over")
    ap.add_argument("--windows", default=None,
                    help="comma-separated hot-window sizes to try "
                    "(default: the pow2 buckets around the shipped 4096)")
    ap.add_argument("--min-slots", default=None,
                    help="comma-separated engagement floors to try "
                    "(default: the shipped hotWindowMinSlots floor)")
    ap.add_argument("--chunks", default="1",
                    help="comma-separated budgeted chunk strides to try")
    ap.add_argument("--max-rounds", type=int, default=0,
                    help="tune over at most N rounds (0 = all)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="warm timing repetitions per candidate (median)")
    ap.add_argument("--pool", default=None,
                    help="pool the tuned entry applies to (default: the "
                    "corpus's single pool, else '*')")
    ap.add_argument("--allow-foreign", action="store_true",
                    help="tune a bundle recorded on a different host "
                    "(sound only for x64-recorded traces)")
    ap.add_argument("--out", default=None,
                    help="write the selected entry as a tuning-store "
                    "profile JSON here")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON line")
    ap.add_argument("--device", default=None,
                    help="the device every solve runs on (default: the CUDA "
                    "card; 'cpu' for the plain versions on the host)")
    args = ap.parse_args(argv)

    from ..autotune import TuningStore, default_grid, tune_corpus
    from ..autotune.offline import DEFAULT_WINDOWS
    from ..core.config import HOT_WINDOW_MIN_SLOTS_DEFAULT
    from ..device import resolve_device
    from ..trace import TraceFormatError, TraceTargetMismatch, load_trace

    device = resolve_device(args.device)

    traces = []
    for path in args.traces:
        try:
            traces.append(load_trace(path))
        except (OSError, TraceFormatError) as e:
            print(f"autotune: cannot load {path}: {e}")
            return 2

    candidates = default_grid(
        windows=_int_list(args.windows) if args.windows else DEFAULT_WINDOWS,
        min_slots=(
            _int_list(args.min_slots)
            if args.min_slots is not None
            else (HOT_WINDOW_MIN_SLOTS_DEFAULT,)
        ),
        chunks=_int_list(args.chunks) or [1],
    )

    try:
        report = tune_corpus(
            traces,
            candidates,
            max_rounds=args.max_rounds or None,
            repeats=args.repeats,
            allow_foreign=args.allow_foreign,
            pool=args.pool,
            log=None if args.json else print,
            device=device,
        )
    except TraceTargetMismatch as e:
        print(f"autotune: {e}")
        return 2
    except ValueError as e:
        print(f"autotune: {e}")
        return 2

    selected = report["selected"]
    # A run with ANY diverging candidate is a solver bug (exit 1): it
    # must not mint a profile file something could later adopt.
    if args.out and selected is not None and report["ok"]:
        store = TuningStore()
        store.put(selected)
        store.to_json(args.out)
    if args.json:
        print(json.dumps(report))
    else:
        print(f"corpus: {report['rounds']} round(s), "
              f"workload {report['workload']}")
        for r in report["results"]:
            status = (
                f"{r['wall_s']:.4f}s" if r["bit_exact"]
                else f"DIVERGED x{len(r['divergences'])}"
            )
            print(f"  {r['label']:<24} {status}")
        if selected is not None:
            p = selected["params"]
            print(
                f"selected: {selected['meta']['label']} "
                f"(window={p['hot_window_slots']} "
                f"min_slots={p['hot_window_min_slots']} "
                f"chunk={p['chunk_loops']}) "
                f"baseline {report['baseline']['wall_s']}s -> "
                f"{selected['tuned_s']}s"
                + (f" -> wrote {args.out}"
                   if args.out and report["ok"] else "")
            )
    if not report["ok"]:
        # stderr: with --json the LAST stdout line must stay the
        # machine-readable report (the bench.py artifact convention).
        print(
            "autotune: candidate(s) diverged from the recorded decision "
            "stream — investigate with python -m "
            "armada_tpu_torch.tools.replay_gate",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
