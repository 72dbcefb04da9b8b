"""Pluggable fairness policies: the objective factored out of the solve.

Each policy supplies the three hooks the round solve consumes:

  (a) a share/entitlement function — what each queue is ENTITLED to this
      round (the waterfill's seat in ``_round_setup``),
  (b) a cost measure — how a queue's allocation is priced when candidate
      order is decided (the ``_drf_cost`` seat in the kernel's lex keys),
  (c) a candidate/preemption rank key — an optional leading lex key that
      orders queues ahead of cost (and, via ``_assign_evict_ranks``,
      decides who is preempted first under fair preemption).

A policy is a plain hashable SPEC TUPLE so it can ride in DeviceRound's
static meta:

    ("drf",)                        dominant-resource fairness (default)
    ("proportional",)               weighted proportional fairness:
                                    cost = sum of resource fractions
                                    instead of the max (1404.2266)
    ("priority",)                   strict priority: queues served in
                                    descending weight order; entitlement
                                    is greedy cumulative demand
    ("deadline", boost, horizon_s)  DRF with deadline-boosted effective
                                    weights + earliest-deadline-first
                                    candidate/preemption ordering

The DRF spec adds no key and keeps the original cost measure.

This module is the HOST half (numpy mirrors and config plumbing); the
device half lives in kernel.py (``_policy_cost``, ``_policy_fair_shares``,
``_policy_rank_key``) and must stay bit-matching with the mirrors here.
"""

from __future__ import annotations

import numpy as np

from . import drf

POLICY_KINDS = ("drf", "proportional", "priority", "deadline")

# Job annotation carrying an absolute unix deadline (seconds); the
# earliest deadline across a queue's live jobs becomes the queue's
# deadline under the deadline policy (snapshot/round.py).
DEADLINE_ANNOTATION = "armadaproject.io/deadline"

DEFAULT_DEADLINE_BOOST = 2.0
DEFAULT_DEADLINE_HORIZON_S = 3600.0

DEFAULT_SPEC = ("drf",)


def normalize_spec(spec) -> tuple:
    """Coerce a policy spec (str | tuple | list) to its canonical tuple.

    Raises ValueError on unknown kinds or malformed parameters — shared
    by config validation, the control-plane setter, and trace decode.
    """
    if isinstance(spec, str):
        spec = (spec,)
    if isinstance(spec, list):
        spec = tuple(spec)
    if not isinstance(spec, tuple) or not spec or not isinstance(spec[0], str):
        raise ValueError(f"malformed fairness policy spec: {spec!r}")
    kind = spec[0]
    if kind not in POLICY_KINDS:
        raise ValueError(
            f"unknown fairness policy {kind!r} (known: {', '.join(POLICY_KINDS)})"
        )
    if kind == "deadline":
        boost = float(spec[1]) if len(spec) > 1 else DEFAULT_DEADLINE_BOOST
        horizon = float(spec[2]) if len(spec) > 2 else DEFAULT_DEADLINE_HORIZON_S
        if not np.isfinite(boost) or boost < 0:
            raise ValueError(f"deadline policy boost must be finite >= 0: {boost}")
        if not np.isfinite(horizon) or horizon <= 0:
            raise ValueError(
                f"deadline policy horizon must be finite > 0: {horizon}"
            )
        return ("deadline", boost, horizon)
    if len(spec) != 1:
        raise ValueError(f"policy {kind!r} takes no parameters: {spec!r}")
    return (kind,)


def spec_kind(spec) -> str:
    return normalize_spec(spec)[0]


def spec_to_str(spec) -> str:
    """Render a spec for operators: 'drf', 'deadline(boost=2,horizon=3600)'."""
    spec = normalize_spec(spec)
    if spec[0] == "deadline":
        return f"deadline(boost={spec[1]:g},horizon={spec[2]:g})"
    return spec[0]


def spec_from_config(config, pool: str) -> tuple:
    """The active policy spec for a pool under a SchedulingConfig."""
    kind = (getattr(config, "fairness_policy_pools", None) or {}).get(
        pool, getattr(config, "fairness_policy_default", "drf")
    )
    if spec_kind(kind) == "deadline":
        return normalize_spec(
            (
                "deadline",
                getattr(
                    config, "fairness_deadline_boost", DEFAULT_DEADLINE_BOOST
                ),
                getattr(
                    config,
                    "fairness_deadline_horizon_s",
                    DEFAULT_DEADLINE_HORIZON_S,
                ),
            )
        )
    return normalize_spec(kind)


# ---------------------------------------------------------------------------
# (b) cost measure — host mirror of kernel._policy_cost
# ---------------------------------------------------------------------------


def policy_cost(spec, alloc, total, multipliers) -> np.ndarray:
    """Policy cost of allocation(s): alloc [..., R]; total/multipliers [R].

    DRF/priority/deadline price by the dominant resource (max fraction);
    proportional fairness prices by the SUM of resource fractions, so a
    queue hogging two resources pays twice — the measure 1404.2266 shows
    improves aggregate throughput over max-min on mixed workloads.
    """
    kind = spec_kind(spec)
    if kind == "proportional":
        alloc = np.asarray(alloc, dtype=np.float64)
        total = np.asarray(total, dtype=np.float64)
        safe_total = np.where(total > 0, total, 1.0)
        frac = np.where(total > 0, alloc / safe_total, 0.0) * multipliers
        return np.maximum(frac.sum(axis=-1), 0.0)
    return drf.unweighted_cost(alloc, total, multipliers)


# ---------------------------------------------------------------------------
# (a) entitlement — host mirror of kernel._policy_fair_shares
# ---------------------------------------------------------------------------


def deadline_factors(queue_deadline, boost, horizon) -> np.ndarray:
    """Per-queue weight boost for the deadline policy, elementwise IEEE
    ops only so the jnp form in kernel.py matches bit-for-bit:
    factor = 1 + boost / (1 + max(0, deadline - min_deadline) / horizon);
    queues with no deadline (+inf) keep factor 1.0.
    """
    dl = np.asarray(queue_deadline, dtype=np.float64)
    fin = np.isfinite(dl)
    dmin = np.min(np.where(fin, dl, np.inf)) if dl.size else np.inf
    rel = np.maximum(dl - (dmin if np.any(fin) else 0.0), 0.0)
    factor = 1.0 + boost / (1.0 + rel / horizon)
    return np.where(fin, factor, 1.0)


def effective_weights(spec, weights, queue_deadline=None) -> np.ndarray:
    """The weights the entitlement computation actually runs on."""
    spec = normalize_spec(spec)
    weights = np.asarray(weights, dtype=np.float64)
    if spec[0] == "deadline" and queue_deadline is not None:
        return weights * deadline_factors(queue_deadline, spec[1], spec[2])
    return weights


def priority_shares(
    queue_names, weights, demand_costs, total_is_zero: bool = False
):
    """Strict-priority entitlement: queues sorted by descending weight
    (name-order tiebreak) greedily take their whole demand from what the
    higher-priority queues left. Returns (fair_share, capped, uncapped)
    matching update_fair_shares' contract; zero-weight queues hold no
    entitlement and a zero total weight yields all-zero shares.
    """
    Q = len(queue_names)
    weights = np.asarray(weights, dtype=np.float64)
    wsum = weights.sum()
    fair_share = weights / wsum if Q and wsum > 0.0 else np.zeros(Q)
    demand = (
        np.ones(Q)
        if total_is_zero
        else np.asarray(demand_costs, dtype=np.float64)
    )
    order = sorted(range(Q), key=lambda i: (-weights[i], queue_names[i]))
    capped = np.zeros(Q)
    uncapped = np.zeros(Q)
    # Cumulative DEMAND (not takes) decides what is left: takes saturate
    # at capacity, so clip(1 - cum_prev, 0, 1) equals the remaining
    # capacity — and the single-accumulator form is what the device mirror
    # computes, keeping host/device bit-exact.
    cum_prev = 0.0
    for i in order:
        if not weights[i] > 0.0:
            continue
        unc = min(max(1.0 - cum_prev, 0.0), 1.0)
        uncapped[i] = unc
        capped[i] = min(demand[i], unc)
        cum_prev = cum_prev + demand[i]
    return fair_share, capped, uncapped


def policy_fair_shares(
    spec,
    queue_names,
    weights,
    demand_costs,
    total_is_zero: bool = False,
    queue_deadline=None,
):
    """Entitlement under a policy — the host parity oracle for the
    device form. Returns (fair_share, demand_capped, uncapped), each float64[Q].
    """
    spec = normalize_spec(spec)
    if spec[0] == "priority":
        return priority_shares(queue_names, weights, demand_costs, total_is_zero)
    eff = effective_weights(spec, weights, queue_deadline)
    return drf.update_fair_shares(
        list(queue_names), eff, demand_costs, total_is_zero
    )


# ---------------------------------------------------------------------------
# (c) candidate/preemption rank — host mirror of kernel._policy_rank_key
# ---------------------------------------------------------------------------


def policy_rank(spec, weights, queue_deadline=None):
    """Optional leading lex key ordering queues ahead of cost (smaller
    wins). None for drf/proportional (no structural key change — the DRF
    program stays bit-exact with pre-policy builds).
    """
    kind = spec_kind(spec)
    if kind == "priority":
        return -np.asarray(weights, dtype=np.float64)
    if kind == "deadline":
        if queue_deadline is None:
            return None
        return np.asarray(queue_deadline, dtype=np.float64)
    return None
