"""Dominant-resource-fairness cost and fair-share water-filling (host numpy).

Mirrors the reference's DominantResourceFairness cost
(internal/scheduler/scheduling/fairness/fairness.go:99-105)
and the iterative fair-share redistribution in
context/scheduling.go:252-331 (updateFairShares): unused share from queues
whose demand is below their entitlement is re-shared among the rest, up to
10 iterations or until 99% of capacity is allocated.

A torch version of the same fixed-point lives in kernel.py; this numpy
version is the host form and is itself vectorized over queues.
"""

from __future__ import annotations

import numpy as np

MAX_ITERATIONS = 10


def unweighted_cost(alloc, total, multipliers) -> np.ndarray:
    """DRF cost of allocation(s): max over resources of alloc/total*multiplier.

    alloc: [..., R]; total, multipliers: [R]. Returns [...] float64.
    Resources with zero total contribute nothing (DivideZeroOnError).
    """
    alloc = np.asarray(alloc, dtype=np.float64)
    total = np.asarray(total, dtype=np.float64)
    safe_total = np.where(total > 0, total, 1.0)
    frac = np.where(total > 0, alloc / safe_total, 0.0) * multipliers
    return np.maximum(frac.max(axis=-1), 0.0)


def update_fair_shares(
    queue_names: list,
    weights: np.ndarray,
    constrained_demand_costs: np.ndarray,
    total_is_zero: bool = False,
):
    """Water-filling fair-share computation.

    Returns (fair_share, demand_capped_adjusted, uncapped_adjusted), each
    float64[Q]. constrained_demand_costs[q] is the DRF cost of queue q's
    (constrained) demand; when the pool has zero resources every queue's
    demand share is treated as 1.0 (scheduling.go:257-259).
    """
    Q = len(queue_names)
    weights = np.asarray(weights, dtype=np.float64)
    # Guard the all-zero-weight pool (every queue cordoned down to
    # weight 0): 0/0 here would NaN-poison every fair-share output and
    # trip the round admission firewall. Zero total weight means no
    # queue holds entitlement — every share is 0.
    wsum = weights.sum()
    fair_share = weights / wsum if Q and wsum > 0.0 else np.zeros(Q)
    demand_share = (
        np.ones(Q) if total_is_zero else np.asarray(constrained_demand_costs, np.float64)
    )

    # Iterate queues in name order for deterministic float accumulation,
    # as the reference sorts queueInfos by name (scheduling.go:274-277).
    order = sorted(range(Q), key=lambda i: queue_names[i])

    capped = np.zeros(Q)
    uncapped = np.zeros(Q)
    achieved = np.zeros(Q, dtype=bool)
    spare = np.zeros(Q)

    unallocated = 1.0
    for _ in range(MAX_ITERATIONS):
        if not unallocated > 0.01:
            break
        total_weight = 0.0
        for i in order:
            if not achieved[i]:
                total_weight += weights[i]

        for i in order:
            total_incl = total_weight + (weights[i] if achieved[i] else 0.0)
            # Guard the 0/0 of an unachieved zero-weight queue once every
            # weighted queue has achieved (total_weight == 0): its share
            # is 0, not NaN — same guard as the kernel form.
            if total_incl > 0.0:
                uncapped[i] += (
                    (weights[i] / total_incl) * (unallocated - spare[i])
                )

        if total_weight <= 0.0:
            break

        for i in order:
            if not achieved[i]:
                capped[i] += (weights[i] / total_weight) * unallocated

        unallocated = 0.0
        for i in order:
            s = capped[i] - demand_share[i]
            if s > 0:
                capped[i] = demand_share[i]
                achieved[i] = True
                spare[i] = s
                unallocated += s
            else:
                spare[i] = 0.0

    from .validate import maybe_assert_finite

    maybe_assert_finite(
        {"fair_share": fair_share, "demand_capped": capped, "uncapped": uncapped},
        "drf.update_fair_shares",
    )
    return fair_share, capped, uncapped
