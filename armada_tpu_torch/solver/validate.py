"""Round admission firewall: host-side invariants over a solved round.

Every robustness layer so far hardens the edges of the control plane;
the solve itself was trusted blindly — a device fault, a NaN-poisoned
tensor, or a miscompiled kernel would commit a corrupt placement
straight into the jobdb and the event log. Before `_record_round`
commits anything, the scheduler validates the round's decision arrays
against cheap host-side invariants computed from the SAME padded
DeviceRound the solve consumed:

  nan_inf            no NaN/inf in any output tensor (spot_price may be
                     NaN — that is the recorded sentinel for "no price")
  invalid_node       every scheduled job's assigned_node is a real node
                     index (a garbage gather index would either crash
                     the commit or silently wrap to the wrong node)
  double_bound       no job is scheduled while already running, or both
                     scheduled and preempted in one round
  preemption_victim  every preemption names a job that actually holds a
                     running run
  gang_atomicity     gang slots place and evict all-or-nothing
  node_over_capacity post-round per-node allocation (running − evicted
                     + newly placed, node-fit requests) fits node_total
  fairness_ledger    the round's share ledger is finite and its
                     delivered shares sum to at most the pool

A violation REJECTS the round: nothing commits, jobs stay queued for
the next cycle, `scheduler_round_rejected_total{pool,invariant}` ticks,
and the scheduler captures a single-round `.atrace` postmortem bundle
so `tools/replay_gate.py` reproduces the poisoned round offline.

The checks are a handful of vectorized numpy passes over arrays the
round already produced — O(J·R + S·M) with tiny constants, gated to
stay under 5% of solve time on a warm flagship cycle
(tools/bench_gate.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# Decision arrays every backend emits; float arrays are NaN/inf-checked,
# int arrays are range-checked by the structural invariants below.
_FLOAT_KEYS = ("fair_share", "demand_capped_fair_share", "uncapped_fair_share")
_REQUIRED_KEYS = (
    "assigned_node",
    "scheduled_mask",
    "preempted_mask",
) + _FLOAT_KEYS

INVARIANTS = (
    "nan_inf",
    "invalid_node",
    "double_bound",
    "preemption_victim",
    "gang_atomicity",
    "node_over_capacity",
    "fairness_ledger",
)


@dataclass(frozen=True)
class RoundViolation:
    """First failed invariant of a rejected round."""

    invariant: str
    detail: str


class RoundRejected(Exception):
    """Raised at the solve seam when the admission firewall rejects a
    round; carries the violation and (when captured) the postmortem
    bundle path."""

    def __init__(self, violation: RoundViolation, bundle: str | None = None):
        super().__init__(f"{violation.invariant}: {violation.detail}")
        self.violation = violation
        self.bundle = bundle


def _bool(a) -> np.ndarray:
    return np.asarray(a, dtype=bool)


def validate_round(
    decisions,
    *,
    dev=None,
    num_jobs: int | None = None,
    num_nodes: int | None = None,
    job_is_running=None,
    fairness=None,
) -> RoundViolation | None:
    """First violated invariant of a solved round, or None (admitted).

    `decisions` is the solver's output dict (padded kernel output or the
    oracle's sliced result — both spell the same keys). With `dev` (the
    padded DeviceRound the solve consumed) the full invariant set runs;
    without it (oracle rounds, which never touched a device) the checks
    degrade to the decision-intrinsic subset — NaN/inf, node range,
    double binding, victimless preemptions — using `num_jobs`/`num_nodes`
    and the caller-supplied `job_is_running` vector.
    """
    # -- nan_inf: scan every float output tensor first so a poisoned
    # array classifies as corruption, not as whatever structural check
    # its garbage values happen to trip.
    for key in _FLOAT_KEYS:
        if key not in decisions or decisions[key] is None:
            continue
        arr = np.asarray(decisions[key], dtype=np.float64)
        bad = ~np.isfinite(arr)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            return RoundViolation(
                "nan_inf", f"{key}[{i}] = {arr.flat[i]!r} is not finite"
            )
    sp = decisions.get("spot_price")
    if sp is not None:
        spf = float(np.asarray(sp))
        if np.isinf(spf):  # NaN is the legitimate "no price" sentinel
            return RoundViolation("nan_inf", f"spot_price = {spf!r}")

    for key in _REQUIRED_KEYS:
        if key not in decisions:
            return RoundViolation("nan_inf", f"decision array {key!r} missing")

    assigned = np.asarray(decisions["assigned_node"])
    scheduled = _bool(decisions["scheduled_mask"])
    preempted = _bool(decisions["preempted_mask"])
    J = int(num_jobs) if num_jobs is not None else len(scheduled)
    assigned = assigned[:J]
    scheduled = scheduled[:J]
    preempted = preempted[:J]

    running = None
    if dev is not None:
        running = _bool(dev.job_is_running)[:J]
        num_nodes = int(np.asarray(dev.node_total).shape[0])
    elif job_is_running is not None:
        running = _bool(job_is_running)[:J]

    # -- invalid_node: a scheduled job must point at a real node row.
    if num_nodes is not None:
        bad = scheduled & ((assigned < 0) | (assigned >= int(num_nodes)))
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            return RoundViolation(
                "invalid_node",
                f"scheduled job {i} assigned to node index "
                f"{int(assigned[i])} outside [0, {int(num_nodes)})",
            )

    # -- double_bound: one job, one binding per round.
    both = scheduled & preempted
    if both.any():
        i = int(np.flatnonzero(both)[0])
        return RoundViolation(
            "double_bound", f"job {i} both scheduled and preempted"
        )
    if running is not None:
        rebind = scheduled & running
        if rebind.any():
            i = int(np.flatnonzero(rebind)[0])
            return RoundViolation(
                "double_bound",
                f"job {i} scheduled while already holding a running run",
            )
        # -- preemption_victim: evictions name actual running jobs.
        orphan = preempted & ~running
        if orphan.any():
            i = int(np.flatnonzero(orphan)[0])
            return RoundViolation(
                "preemption_victim", f"preempted job {i} has no running run"
            )

    if dev is not None:
        v = _validate_gangs(dev, scheduled, preempted, J)
        if v is not None:
            return v
        v = _validate_capacity(dev, assigned, scheduled, preempted, J)
        if v is not None:
            return v

    if fairness is not None:
        v = _validate_fairness(fairness)
        if v is not None:
            return v
    return None


def _validate_gangs(dev, scheduled, preempted, J) -> RoundViolation | None:
    """gang_atomicity: slots with >1 member place / evict all-or-nothing."""
    members = np.asarray(dev.slot_members)
    count = np.asarray(dev.slot_count)
    if members.size == 0:
        return None
    multi = count > 1
    if not multi.any():
        return None
    real = (members >= 0) & (members < J)
    safe = np.clip(members, 0, max(J - 1, 0))
    for mask, verb in ((scheduled, "scheduled"), (preempted, "preempted")):
        hits = np.where(real, mask[safe], False).sum(axis=1)
        torn = multi & (hits > 0) & (hits < count)
        if torn.any():
            s = int(np.flatnonzero(torn)[0])
            return RoundViolation(
                "gang_atomicity",
                f"slot {s}: {int(hits[s])}/{int(count[s])} gang members "
                f"{verb} (all-or-nothing)",
            )
    return None


def _validate_capacity(dev, assigned, scheduled, preempted, J):
    """node_over_capacity: post-round per-node allocation fits totals.

    Occupancy is rebuilt from the round's own job rows (node-fit
    requests: floating columns zeroed), so allocations outside this
    round's visibility can only make the check conservative — a clean
    round never false-positives.
    """
    req = np.asarray(dev.job_req_fit)[:J]
    total = np.asarray(dev.node_total)
    N, R = total.shape
    node = np.asarray(dev.job_node)[:J]
    running = _bool(dev.job_is_running)[:J]
    stay = running & ~preempted & (node >= 0) & (node < N)
    used = np.zeros((N, R), dtype=np.int64)
    for src_mask, src_node in ((stay, node), (scheduled, assigned)):
        if not src_mask.any():
            continue
        idx = src_node[src_mask].astype(np.int64)
        rows = req[src_mask]
        for r in range(R):
            used[:, r] += np.bincount(idx, weights=rows[:, r], minlength=N)[
                :N
            ].astype(np.int64)
    over = used > total.astype(np.int64)
    if over.any():
        n, r = (int(x) for x in np.argwhere(over)[0])
        return RoundViolation(
            "node_over_capacity",
            f"node {n} resource {r}: post-round allocation {int(used[n, r])} "
            f"> capacity {int(total[n, r])}",
        )
    return None


def _validate_fairness(fairness) -> RoundViolation | None:
    """fairness_ledger: the share ledger is finite and deliveries sum to
    at most the policy's cost ceiling. Under max-fraction costs (drf /
    priority / deadline) each queue's delivered share is a fraction of
    total resources, so the sum cannot exceed 1; under the proportional
    policy the cost is the SUM of resource fractions, so the pool-wide
    ceiling is the resource count instead."""
    ledger = (fairness or {}).get("ledger") or {}
    rows = ledger.get("queues") or ()
    policy_kind = str(ledger.get("policy") or "drf").split("(", 1)[0]
    bound = 1.0
    if policy_kind == "proportional":
        bound = float(max(1, len(ledger.get("delivered_total") or ())))
    delivered = []
    for q, row in enumerate(rows):
        for key in ("fair_share", "delivered_share", "regret"):
            val = row.get(key)
            if val is None:
                continue
            if not np.isfinite(float(val)):
                return RoundViolation(
                    "fairness_ledger", f"queue[{q}].{key} = {val!r}"
                )
        if row.get("delivered_share") is not None:
            delivered.append(float(row["delivered_share"]))
    if delivered:
        tot = float(np.sum(delivered))
        if tot > bound + 1e-6:
            return RoundViolation(
                "fairness_ledger",
                f"delivered shares sum to {tot:.6f} > {bound:g} "
                f"(deliveries under the {policy_kind} policy must sum "
                "to at most the pool's cost ceiling)",
            )
        if min(delivered) < -1e-9:
            return RoundViolation(
                "fairness_ledger",
                f"negative delivered share {min(delivered):.6g}",
            )
    return None


# ---- debug finite mode -------------------------------------------------

DEBUG_FINITE_ENV = "ARMADA_DEBUG_FINITE"


def debug_finite_enabled() -> bool:
    return os.environ.get(DEBUG_FINITE_ENV, "") not in ("", "0", "false")


def assert_finite(arrays, where: str) -> None:
    """Raise naming the FIRST non-finite float array — the debug net for
    unguarded divisions anywhere in the solve path. `arrays` is a
    mapping of name -> array-like; non-float entries are skipped."""
    for name, value in arrays.items():
        arr = np.asarray(value)
        if arr.dtype.kind != "f":
            continue
        bad = ~np.isfinite(arr)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise FloatingPointError(
                f"{where}: array {name!r} is not finite at flat index {i} "
                f"(value {arr.flat[i]!r}); set {DEBUG_FINITE_ENV}=0 to "
                "disable this check"
            )


def maybe_assert_finite(arrays, where: str) -> None:
    """assert_finite gated on ARMADA_DEBUG_FINITE=1 (spot_price is
    excluded: NaN is its documented 'no price' sentinel)."""
    if not debug_finite_enabled():
        return
    assert_finite(
        {k: v for k, v in arrays.items() if k != "spot_price"}, where
    )
