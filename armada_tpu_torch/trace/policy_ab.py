"""Policy A/B harness: replay a corpus under candidate fairness policies.

The rollout path for a fairness-policy flip (docs/operations.md,
"Rolling out a fairness policy"): every non-truncated round of a
flight-recorder bundle is RE-SOLVED under each candidate spec
(solver/policy.py) — the policy is swapped into the recorded
DeviceRound's static meta, so each candidate runs the exact round
inputs production saw — and the resulting decision streams are scored
with the same per-round ledger + scorecard aggregation the live
fairness observatory uses (observe/fairness.py). The output is one
scorecard per policy, side by side: Jain trajectory, per-queue
delivered share vs regret, starvation streaks, preemption counts.

This is the port's copy of the JAX package's trace/policy_ab.py; its
solves run on `device` (the CUDA card unless the caller asks for the
CPU).

This is the EXPLICIT cross-policy comparison: bit-exact differentials
between bundles recorded under different policies are refused
(`trace.replayer.CrossPolicyMismatch`), because shares legitimately
diverge; the A/B harness compares scorecards, not bits. Its scorecard
is also the evidence the control-plane divergence gate wants before a
live flip (SchedulerService.note_policy_shadow / set_fairness_policy).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .replayer import check_target, load_trace, replay_solver

# The default candidate slate: every known policy kind at its default
# parameters.
DEFAULT_CANDIDATES = ("drf", "proportional", "priority", "deadline")


def _policy_blocks(trace, spec, solve, max_rounds=None):
    """One name-resolved fairness block per non-truncated round,
    re-solved under `spec`."""
    from ..observe.fairness import ledger_from_device_round, resolve_names
    from ..solver import policy as fp

    spec = fp.normalize_spec(spec)
    blocks = []
    for rec in trace.rounds:
        if rec.truncated:
            continue
        if max_rounds is not None and len(blocks) >= max_rounds:
            break
        dev = rec.device_round()
        if spec[0] == "deadline" and dev.queue_deadline is None:
            # Pre-policy bundles carry no deadline vector: every queue
            # reads +inf (factor 1.0) and the candidate degrades to its
            # DRF waterfill instead of refusing the corpus.
            dev = dataclasses.replace(
                dev,
                queue_deadline=np.full(dev.queue_weight.shape[0], np.inf),
            )
        dev = dataclasses.replace(dev, fairness_policy=spec)
        out = solve(dev)
        block = ledger_from_device_round(
            dev, out, rec.num_jobs, rec.num_queues
        )
        ids = rec.raw.get("ids") or {}
        blocks.append(
            resolve_names(
                block,
                queue_names=ids.get("queues"),
                job_ids=ids.get("jobs"),
            )
        )
    return blocks


def ab_compare(
    paths,
    policies=DEFAULT_CANDIDATES,
    *,
    solver="LOCAL",
    allow_foreign: bool = False,
    max_rounds: int | None = None,
    device=None,
) -> dict:
    """Score every candidate policy over the given bundles.

    Returns {"solver": label, "inputs": [...], "policies":
    {policy_str: scorecard}} — scorecards are observe.fairness
    aggregate_scorecard documents, directly comparable across
    candidates because every one replays the same recorded rounds.
    """
    from ..observe.fairness import aggregate_scorecard
    from ..solver import policy as fp

    specs = [fp.normalize_spec(p) for p in policies]
    if not specs:
        raise ValueError("policy A/B needs at least one candidate policy")
    traces = []
    for path in paths:
        trace = load_trace(path)
        check_target(trace.header, allow_foreign=allow_foreign)
        traces.append(trace)
    label = None
    out: dict = {"inputs": [], "policies": {}}
    for spec in specs:
        blocks = []
        for trace in traces:
            label, solve = replay_solver(solver, trace.header, device=device)
            blocks += _policy_blocks(trace, spec, solve, max_rounds=max_rounds)
        if not blocks:
            raise ValueError(
                "no scoreable rounds in the given bundles (all truncated "
                "or empty)"
            )
        out["policies"][fp.spec_to_str(spec)] = aggregate_scorecard(blocks)
    out["solver"] = label
    out["inputs"] = [
        {
            "path": t.path,
            "rounds": sum(1 for r in t.rounds if not r.truncated),
            "recorded_policy": _recorded_policy(t),
        }
        for t in traces
    ]
    return out


def _recorded_policy(trace) -> str:
    from .replayer import trace_policies

    pol = trace_policies(trace)
    pools = set(pol["pools"].values())
    if not pools:
        return pol["default"]
    return "/".join(sorted(pools | {pol["default"]}))


def render_ab(result: dict) -> str:
    """The side-by-side operator view of an ab_compare document."""
    lines = []
    for meta in result.get("inputs", []):
        lines.append(
            f"{meta['path']}: {meta['rounds']} round(s), recorded under "
            f"{meta['recorded_policy']} (solver {result.get('solver')})"
        )
    header = (
        f"{'policy':<28} {'jain~':>8} {'jain_min':>9} {'regret^':>8} "
        f"{'starvedΣ':>9} {'preempt':>8}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    cards = result.get("policies", {})
    for name, card in cards.items():
        starved = sum(
            q.get("starved_rounds", 0) for q in card.get("queues", {}).values()
        )
        preempt = sum((card.get("preemptions_attributed") or {}).values())
        lines.append(
            f"{name:<28} {card['jain_mean']:>8.4f} {card['jain_min']:>9.4f} "
            f"{card['max_regret']:>8.4f} {starved:>9} {preempt:>8}"
        )
    queues = sorted(
        {q for card in cards.values() for q in card.get("queues", {})}
    )
    if queues and cards:
        lines.append("")
        lines.append("per-queue delivered share (max regret):")
        names = list(cards)
        head = f"{'queue':<16}" + "".join(f" {n:>24}" for n in names)
        lines.append(head)
        lines.append("-" * len(head))
        for q in queues:
            row = f"{q:<16}"
            for n in names:
                stat = cards[n].get("queues", {}).get(q) or {}
                cell = (
                    f"{stat.get('mean_delivered', 0.0):.4f} "
                    f"({stat.get('max_regret', 0.0):.4f})"
                )
                row += f" {cell:>24}"
            lines.append(row)
    return "\n".join(lines)
