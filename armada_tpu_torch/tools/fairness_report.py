"""Offline fairness scorecard: Jain/regret trajectory + per-queue ledger
aggregates from flight-recorder bundles or a built-in contention sim.

The port's counterpart of the JAX package's `tools/fairness_report.py`:

    python -m armada_tpu_torch.tools.fairness_report trace.atrace [trace2.atrace ...]
    python -m armada_tpu_torch.tools.fairness_report trace.atrace --json
    python -m armada_tpu_torch.tools.fairness_report --sim   # canned 3-queue sim

Bundles recorded by either package score the same way. The built-in sim
solves on the kernel backend on the CUDA card unless the caller asks for
another device (`--device cpu`).

Per round the report uses the bundle's recorded `fairness` block (the
canonical index-based ledger + preemption attribution the scheduler
stamped at solve time, observe/fairness.py); rounds from bundles
recorded before the fairness round are recomputed from their own
DeviceRound + decision stream with the same function — identical math,
so old corpora still get a scorecard. Queue indices resolve to names
through the bundle's id vocabularies when recorded.

This is the offline face of the fairness observatory: the same
scorecard the live surfaces serve (`GET /api/fairness`), computable
over any recorded corpus.

Exit codes: 0 ok, 2 unusable input (no rounds / undecodable bundle).
"""

from __future__ import annotations

import argparse
import json


def blocks_from_trace(path: str):
    """(blocks, meta) — one decorated fairness block per non-truncated
    round (queue indices resolved to names when the bundle recorded id
    vocabularies)."""
    from ..observe.fairness import resolve_names
    from ..trace import load_trace

    trace = load_trace(path)
    blocks = []
    recomputed = 0
    for rec in trace.rounds:
        if rec.truncated:
            continue
        block = rec.raw.get("fairness")
        if not block:
            from ..observe.fairness import ledger_from_device_round

            block = ledger_from_device_round(
                rec.device_round(), rec.decisions(), rec.num_jobs,
                rec.num_queues,
            )
            recomputed += 1
        ids = rec.raw.get("ids") or {}
        blocks.append(
            resolve_names(
                block,
                queue_names=ids.get("queues"),
                job_ids=ids.get("jobs"),
            )
        )
    return blocks, {
        "path": path,
        "rounds": len(blocks),
        "recomputed": recomputed,
    }


def blocks_from_sim(device=None):
    """A deterministic 3-queue starvation sim on the REAL service path:
    two equal-weight queues holding the fleet with non-preemptible
    work, plus a weight-starved victim (priority factor 20 → weight
    0.05) whose demand can never be delivered — the starvation-alert
    scenario from the "Diagnosing an unfair pool" runbook. Solved on
    the kernel backend on `device` (the card by default)."""
    from ..core.config import PriorityClass, SchedulingConfig
    from ..sim.simulator import (
        ClusterSpec,
        JobTemplate,
        NodeTemplate,
        QueueSpecSim,
        ShiftedExponential,
        Simulator,
        WorkloadSpec,
    )

    cfg = SchedulingConfig(
        priority_classes={
            "low": PriorityClass("low", 1000, preemptible=True),
            "pinned": PriorityClass("pinned", 30000, preemptible=False),
        },
        default_priority_class="low",
        protected_fraction_of_fair_share=0.5,
    )
    long = ShiftedExponential(minimum=500.0)
    sim = Simulator(
        [ClusterSpec(name="c", node_templates=(NodeTemplate(count=2, cpu="8"),))],
        WorkloadSpec(
            queues=(
                QueueSpecSim(
                    name="qa",
                    job_templates=(
                        JobTemplate(id="a", number=4, cpu="4",
                                    priority_class="pinned", runtime=long),
                    ),
                ),
                QueueSpecSim(
                    name="qb",
                    job_templates=(
                        JobTemplate(id="b", number=4, cpu="4",
                                    submit_time=30.0,
                                    priority_class="pinned", runtime=long),
                    ),
                ),
                QueueSpecSim(
                    name="qc",
                    priority_factor=20.0,  # weight 0.05: the victim
                    job_templates=(
                        JobTemplate(id="c", number=4, cpu="4",
                                    submit_time=60.0, runtime=long),
                    ),
                ),
            )
        ),
        config=cfg,
        backend="kernel",
        cycle_interval=10.0,
        max_time=300.0,
        device=device,
    )
    blocks = []
    orig = sim.scheduler.fairness.observe_round

    def tap(pool, fairness, **kw):
        doc = orig(pool, fairness, **kw)
        blocks.append(
            {"ledger": doc["ledger"], "preemptions": doc["preemptions"]}
        )
        return doc

    sim.scheduler.fairness.observe_round = tap
    sim.run()
    return blocks, {"path": "<sim>", "rounds": len(blocks), "recomputed": 0}


def render(scorecard: dict, metas: list) -> str:
    lines = []
    for meta in metas:
        extra = (
            f" ({meta['recomputed']} recomputed pre-fairness rounds)"
            if meta.get("recomputed")
            else ""
        )
        lines.append(f"{meta['path']}: {meta['rounds']} round(s){extra}")
    lines.append(
        f"jain mean {scorecard['jain_mean']:.4f} min "
        f"{scorecard['jain_min']:.4f} · max regret "
        f"{scorecard['max_regret']:.4f} over {scorecard['rounds']} rounds"
    )
    header = (
        f"{'queue':<16} {'rounds':>6} {'entitled':>9} {'delivered':>9} "
        f"{'demand':>8} {'regretΣ':>9} {'regret^':>8} {'starved':>8} "
        f"{'streak^':>8}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for name, q in scorecard["queues"].items():
        lines.append(
            f"{name:<16} {q['rounds']:>6} {q['mean_entitlement']:>9.4f} "
            f"{q['mean_delivered']:>9.4f} {q['mean_demand']:>8.4f} "
            f"{q['regret_total']:>9.4f} {q['max_regret']:>8.4f} "
            f"{q['starved_rounds']:>8} {q['max_starved_streak']:>8}"
        )
    attributed = scorecard.get("preemptions_attributed") or {}
    if attributed:
        lines.append("preemptions attributed (aggressor/mechanism):")
        for key, n in attributed.items():
            lines.append(f"  {key}: {n}")
    tail = scorecard.get("trajectory", [])[-10:]
    if tail:
        lines.append("trajectory (last 10 rounds):")
        for t in tail:
            lines.append(
                f"  round {t['round']:>4}: jain {t['jain']:.4f}  "
                f"max regret {t['max_regret']:.4f}"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("traces", nargs="*", help=".atrace bundles to score")
    ap.add_argument("--sim", action="store_true",
                    help="score the built-in 3-queue contention sim "
                    "instead of bundles")
    ap.add_argument("--json", action="store_true",
                    help="emit the scorecard document as one JSON line")
    ap.add_argument("--device", default=None,
                    help="device of the --sim run's kernel solves (default: "
                    "the CUDA card; `cpu` for a run without one)")
    args = ap.parse_args(argv)
    if not args.traces and not args.sim:
        ap.error("give .atrace bundle(s) or --sim")

    from ..observe.fairness import aggregate_scorecard
    from ..trace import TraceFormatError

    blocks: list = []
    metas: list = []
    if args.sim:
        b, meta = blocks_from_sim(args.device)
        blocks += b
        metas.append(meta)
    for path in args.traces:
        try:
            b, meta = blocks_from_trace(path)
        except (OSError, TraceFormatError) as e:
            print(f"fairness_report: cannot load {path}: {e}")
            return 2
        blocks += b
        metas.append(meta)
    if not blocks:
        print("fairness_report: no scoreable rounds in the given input "
              "(all truncated or empty)")
        return 2
    scorecard = aggregate_scorecard(blocks)
    if args.json:
        print(json.dumps({"scorecard": scorecard, "inputs": metas}))
    else:
        print(render(scorecard, metas))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
