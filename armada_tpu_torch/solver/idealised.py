"""Idealised vs realised value: the market "expectation gap" metric.

Port of internal/scheduler/scheduling/idealised_value.go:23
(CalculateIdealisedValue) + idealised_value_scheduler.go: on market-driven
pools, the idealised value per queue is the value of the jobs that WOULD
schedule if the whole pool were one giant node — no node boundaries, static
requirements (selectors/affinity/gang uniformity) ignored, per-round caps
and rate limits disabled — scheduling running + queued jobs in price order.
The realised value is what the actual round placed. Tracking both exposes
the gap between what users expect (they don't know node boundaries) and
what packing achieves.

Value of a job = bid × resource units, resource units =
max_r(request_r / unit_r) (DivideZeroOnError().Max() in the reference),
with the per-pool unit from the bid-price snapshot
(services/pricing.py resource_units; scheduling_algo.go:801-808).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import JobSpec, NodeSpec
from ..snapshot.round import build_round_snapshot


def _strip(spec: JobSpec, pool: str, running: bool) -> JobSpec:
    """Static requirements ignored on the mega node
    (StaticRequirementsIgnoringIterator): no selector/affinity, gangs keep
    atomicity but not uniformity. Previously-running jobs keep their
    running-phase bid (the market iterator feeds them at that price)."""
    gang = spec.gang
    if gang is not None and gang.node_uniformity_label:
        gang = dataclasses.replace(gang, node_uniformity_label="")
    bids = spec.bid_prices
    if running:
        bids = {pool: spec.bid_price(pool, running=True)}
    return spec.with_(
        node_selector={}, affinity=None, gang=gang, bid_prices=bids
    )


def calculate_idealised_value(
    config, pool, nodes, queues, running, queued, solve_fn, resource_unit
) -> dict[str, float]:
    """Idealised value per queue (empty dict off market pools)."""
    if not config.market_driven or not nodes:
        return {}
    # The mega node: every resource in the pool on one node
    # (createMegaNode, idealised_value_scheduler.go).
    from fractions import Fraction

    from ..core.resources import parse_quantity

    total: dict[str, Fraction] = {}
    for node in nodes:
        for name, qty in node.total_resources.items():
            total[name] = total.get(name, Fraction(0)) + parse_quantity(qty)
    mega = NodeSpec(
        id="mega-node",
        pool=pool,
        total_resources={
            k: str(int(v)) if v.denominator == 1 else str(float(v))
            for k, v in total.items()
        },
    )
    jobs = [_strip(r.job, pool, running=True) for r in running]
    jobs += [_strip(j, pool, running=False) for j in queued]
    # Round constraints off (permissive CheckRoundConstraints + the no-op
    # rate limiter): only per-queue/PC limits still apply.
    from ..core.config import RateLimits

    cfg = dataclasses.replace(
        config,
        maximum_resource_fraction_to_schedule={},
        rate_limits=RateLimits(
            maximum_scheduling_burst=10**9,
            maximum_per_queue_scheduling_burst=10**9,
        ),
    )
    snap = build_round_snapshot(cfg, pool, [mega], queues, [], jobs)
    result = solve_fn(snap)
    return value_by_queue(
        snap, np.asarray(result["scheduled_mask"], bool), resource_unit
    )


def value_by_queue(snap, placed_mask, resource_unit) -> dict[str, float]:
    """Σ bid × resource-units over placed jobs, per queue
    (valueFromSchedulingResult). req and unit share the factory's integer
    scaling, so the ratio is scale-free."""
    factory = snap.factory
    unit = factory.from_map(resource_unit or {}, ceil=False).astype(float)
    req = np.asarray(snap.job_req, dtype=float)
    with np.errstate(divide="ignore", invalid="ignore"):
        units = np.where(unit[None, :] > 0, req / np.maximum(unit, 1), 0.0)
    units = units.max(axis=1) if units.size else np.zeros(snap.num_jobs)
    value = np.where(placed_mask, snap.job_bid * units, 0.0)
    out: dict[str, float] = {}
    for q, name in enumerate(snap.queue_names):
        out[name] = float(value[np.asarray(snap.job_queue) == q].sum())
    return out
