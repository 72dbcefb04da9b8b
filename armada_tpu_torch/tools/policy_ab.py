"""Fairness-policy A/B: replay a corpus under candidate policies.

    python -m armada_tpu_torch.tools.policy_ab trace.atrace
    python -m armada_tpu_torch.tools.policy_ab trace.atrace --policy drf --policy priority
    python -m armada_tpu_torch.tools.policy_ab trace.atrace --json --rounds 20

Every non-truncated round in the bundle(s) is re-solved under each
candidate fairness policy (solver/policy.py) — the spec is swapped into
the recorded DeviceRound's static meta, so each candidate sees the
exact round inputs production saw — and scored with the live fairness
observatory's ledger + scorecard math (observe/fairness.py). The
rendered table puts the candidates side by side: Jain trajectory,
per-queue delivered share vs regret, starvation totals, preemptions.

This is the evidence the rollout runbook (docs/operations.md, "Rolling
out a fairness policy") asks for before a live flip: `armadactl policy
set` refuses a non-DRF flip without a registered shadow scorecard
unless forced. `armadactl policy ab` is the same harness behind the
CLI.

Exit codes: 0 ok, 2 unusable input (no rounds / undecodable bundle /
foreign target without --allow-foreign / unknown policy).

This is the port's counterpart of the repo's tools/policy_ab.py, over
the port's trace/policy_ab.py: the replays run on the CUDA card unless
asked for another device (`--device cpu`).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("traces", nargs="+", help=".atrace bundles to replay")
    ap.add_argument(
        "--policy",
        action="append",
        metavar="POLICY",
        help="candidate policy (repeatable); default: all four kinds",
    )
    ap.add_argument(
        "--solver",
        default="LOCAL",
        help="replay solver spec: LOCAL | hotwindow[:W] | 2x4 (default LOCAL)",
    )
    ap.add_argument(
        "--rounds", type=int, default=None,
        help="cap the number of rounds scored per bundle",
    )
    ap.add_argument(
        "--allow-foreign", action="store_true",
        help="accept bundles recorded on a different host/toolchain",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit the A/B document as one JSON line")
    ap.add_argument("--device", default="",
                    help="torch device of the replays (default: the CUDA card)")
    args = ap.parse_args(argv)

    # The replays' device, resolved first: with no card present the
    # default raises before any bundle is read.
    from ..device import resolve_device

    device = resolve_device(args.device or None)

    from ..trace import TraceFormatError
    from ..trace.policy_ab import (
        DEFAULT_CANDIDATES,
        ab_compare,
        render_ab,
    )
    from ..trace.replayer import TraceTargetMismatch

    try:
        result = ab_compare(
            args.traces,
            args.policy or DEFAULT_CANDIDATES,
            solver=args.solver,
            allow_foreign=args.allow_foreign,
            max_rounds=args.rounds,
            device=device,
        )
    except (OSError, TraceFormatError, TraceTargetMismatch, ValueError) as e:
        print(f"policy_ab: {e}")
        return 2
    if args.json:
        print(json.dumps(result))
    else:
        print(render_ab(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
