"""Shadow-solve divergence gate: replay recorded traces, fail on drift.

The counterpart of the JAX package's `tools/replay_gate.py`, with the
same flags plus `--device`: run a candidate kernel over a
flight-recorder corpus (one or more `.atrace` bundles, recorded by
either package; armada_tpu_torch/trace) and exit non-zero when any
replayed round's decision stream diverges from the recorded one.

    python -m armada_tpu_torch.tools.replay_gate tests/fixtures/sim_steady.atrace --allow-foreign
    python -m armada_tpu_torch.tools.replay_gate trace.atrace --solver LOCAL \
        --solver lax --solver hotwindow:64 --solver 2x2
    python -m armada_tpu_torch.tools.replay_gate trace.atrace --device cpu --perturb tiebreak  # must fail

Solver specs: LOCAL (the hand-written kernels, "cuda"), cuda, lax,
hotwindow[:W] (on "cuda"), a mesh spelling ("2x2", "4"; every shard on
--device), and <path>:<mesh> or <path>:hotwindow[:W]. The JAX package's "blocked", "pallas" and "native"
are refused by name.

Divergences classify as `placement` (any decision array differs —
placements, evictions, priorities, fair shares, spot price),
`loop_stream` (same decisions, different pass-1 loop count),
`fairness_ledger`, `profile_regression` (replay wall clock beyond
--profile-threshold x the recorded solve time; off by default — wall
clocks only compare on one host), and `retrace` (a kernel library built
or loaded during a round whose shape signature was already replayed
under that solver; disable with --no-retrace-check). `--perturb
tiebreak` injects a deliberately-buggy candidate (reversed node
tie-break ranking) to prove the gate trips.

A bundle recorded on a different target (host CPU features / toolchain
and card / x64 mode) REFUSES to replay with a clear error; pass
--allow-foreign for x64-recorded traces, whose exact decisions are
host-independent. The port runs x64 only. Exit codes: 0 clean, 1
divergences, 2 unusable (no rounds, undecodable bundle, target
mismatch, a solver spec the port does not take).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("traces", nargs="+", help=".atrace bundles to replay")
    ap.add_argument(
        "--solver",
        action="append",
        default=None,
        help="solver spec to replay under: LOCAL, cuda, lax, hotwindow[:W], "
        'a mesh spelling like "2x2" / "4", or either behind a kernel path '
        '("lax:2x2", "lax:hotwindow:64"; repeatable; default LOCAL)',
    )
    ap.add_argument("--device", default=None,
                    help="the device every solve runs on (default: the CUDA "
                    "card; 'cpu' for the plain versions on the host)")
    ap.add_argument("--max-rounds", type=int, default=0,
                    help="replay at most N rounds per bundle (0 = all)")
    ap.add_argument(
        "--profile-threshold", type=float, default=0.0,
        help="flag profile_regression when replay wall clock exceeds this "
        "factor of the recorded solve time (0 = off; same-host runs only)",
    )
    ap.add_argument("--perturb", choices=("tiebreak",), default=None,
                    help="inject a deliberately-buggy candidate kernel")
    ap.add_argument("--allow-foreign", action="store_true",
                    help="replay a bundle recorded on a different host "
                    "(sound only for x64-recorded traces)")
    ap.add_argument("--no-retrace-check", action="store_true",
                    help="skip the warm-shape rebuild audit")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON line")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..trace import (
        TraceFormatError,
        TraceTargetMismatch,
        load_trace,
        replay_trace,
    )

    device = resolve_device(args.device)
    solvers = args.solver or ["LOCAL"]
    reports = []
    total_rounds = 0
    by_kind: dict[str, int] = {}
    for path in args.traces:
        try:
            trace = load_trace(path)
        except (OSError, TraceFormatError) as e:
            print(f"replay_gate: cannot load {path}: {e}")
            return 2
        try:
            report = replay_trace(
                trace,
                solvers=solvers,
                max_rounds=args.max_rounds or None,
                profile_threshold=args.profile_threshold or None,
                perturb=args.perturb,
                allow_foreign=args.allow_foreign,
                flag_retraces=not args.no_retrace_check,
                log=lambda msg: print(f"{os.path.basename(path)}: {msg}"),
                device=device,
            )
        except (TraceTargetMismatch, TraceFormatError, ValueError) as e:
            print(f"replay_gate: {path}: {e}")
            return 2
        reports.append(report)
        total_rounds += report["rounds"]
        for kind, n in report["divergences"].items():
            by_kind[kind] = by_kind.get(kind, 0) + n

    if total_rounds == 0:
        print("replay_gate: no replayable rounds in the given bundles "
              "(all truncated or empty)")
        return 2
    summary = {
        "bundles": len(reports),
        "rounds": total_rounds,
        "solvers": solvers,
        "divergences": by_kind,
        "ok": not by_kind,
    }
    if args.json:
        print(json.dumps({"summary": summary, "reports": reports}))
    else:
        verdict = "OK" if summary["ok"] else f"DIVERGED {by_kind}"
        print(
            f"replay_gate: {total_rounds} round(s) x {len(solvers)} "
            f"solver(s) across {len(reports)} bundle(s): {verdict}"
        )
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
