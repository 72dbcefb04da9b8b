"""Indicative gang pricing: the minimum bid at which a gang shape would fit.

Answers the market-mode question "what would I have to bid right now to get
this shape scheduled?" for a configured set of gang shapes, without touching
real state. Mirrors the reference's pricer stack:

- per-(job, node) minimum price = evict bound jobs cheapest-bid-first until
  the member fits; price is the last evicted bid, 0 if it fits free
  (scheduling/pricer/node_scheduler.go:39-100)
- gang price = max over members, members placed sequentially with node-state
  updates between them (scheduling/pricer/gang_pricer.go:113-160)
- candidates grouped by the gang's node-uniformity label; cheapest group
  wins (gang_pricer.go:49-108)
- shape iteration with capacity/constraint pre-checks and a deadline
  (scheduling/market_driven_indicative_pricer.go:54-130)

The re-design is data-parallel instead of node-at-a-time: free capacity is
one row read of the snapshot's dense allocatable tensor, per-member fit is a
vectorized compare over all candidate nodes at once, and the evict-until-fit
search is a cumulative sum over each node's bid-sorted bound jobs — the
argmin over (price, node-rank) replaces the reference's sort of per-node
result objects.

Deterministic deviations (same spirit as docs/parity.md #3): the reference
tie-breaks equal-price nodes and equal-cost groups on freshly generated
ULIDs — i.e. nondeterministically; here ties break on node-id rank and
sorted uniformity value. Evict order within a node is (bid, job id); the
reference inserts lease age between them (pricer/preemption_info.go:21-29),
which the dense snapshot does not carry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..snapshot.round import RoundSnapshot

# Unschedulable reasons (pricer/gang_pricer.go:17-20,
# market_driven_indicative_pricer.go:23-27, scheduling/constraints).
REASON_NOT_INDEXED = "uniformity label is not indexed"
REASON_NO_UNIFORMITY_NODES = "no nodes with uniformity label"
REASON_DOES_NOT_FIT = "job does not fit on any node"
REASON_GANG_DOES_NOT_FIT = "gang does not fit on any node group"
REASON_EXCEEDS_CAPACITY = (
    "The requested gang resources exceed the available capacity for scheduling"
)
REASON_CARDINALITY_ZERO = "The gang has cardinality zero"


@dataclass(frozen=True)
class GangPricingResult:
    """pricer.GangPricingResult: evaluated=False means the pricer gave up
    (deadline) before looking at this shape."""

    evaluated: bool
    schedulable: bool
    price: float = 0.0
    unschedulable_reason: str = ""


class _NodeState:
    """Mutable pricing state over the snapshot's nodes: free capacity plus
    each node's bound jobs in eviction (bid, id) order. Shared across the
    shapes priced in one call; member binds mutate copies per group.

    With `result` (the round's solve output), the state reflects the
    POST-round cluster — the reference prices against the nodedb as updated
    by the round (preempting_queue_scheduler.go:637-646): this round's
    placements consume capacity and become evictable; its preemptions
    release capacity."""

    def __init__(self, snap: RoundSnapshot, result=None):
        self.snap = snap
        # Free without evicting anyone: the EVICTED_PRIORITY row
        # (AllocatableByPriority[EvictedPriority], node_scheduler.go:53).
        self.free0 = snap.allocatable[0].copy()  # int64 [N, R]
        self.req_fit = snap.job_req_fit()
        # Eviction prices: the reference reads job.GetBidPrice on the
        # POST-round jobdb, where a job this round just leased resolves to
        # its running-phase bid — so re-resolve those here.
        self.bid = snap.job_bid.copy()
        node_of = snap.job_node.copy()
        if result is not None:
            assigned = np.asarray(result["assigned_node"])
            scheduled = np.asarray(result["scheduled_mask"], bool)
            preempted = np.asarray(result["preempted_mask"], bool)
            # Newly scheduled work consumes its assigned node.
            for j in np.flatnonzero(scheduled):
                self.free0[int(assigned[j])] -= self.req_fit[j]
                node_of[j] = int(assigned[j])
                self.bid[j] = snap.job_bid_running[j]
            for j in np.flatnonzero(snap.job_is_running):
                if preempted[j]:
                    # Preempted: capacity returns, job leaves the node.
                    if node_of[j] >= 0:
                        self.free0[int(node_of[j])] += self.req_fit[j]
                    node_of[j] = -1
                elif int(assigned[j]) != int(node_of[j]) and assigned[j] >= 0:
                    # Evicted-and-rebound elsewhere within the round.
                    if node_of[j] >= 0:
                        self.free0[int(node_of[j])] += self.req_fit[j]
                    self.free0[int(assigned[j])] -= self.req_fit[j]
                    node_of[j] = int(assigned[j])
        bound = np.flatnonzero(node_of >= 0)
        # Eviction order (bid asc, job id asc) applied globally once;
        # per-node slices inherit it.
        ids = np.asarray([snap.job_ids[j] for j in bound])
        order = np.lexsort((ids, self.bid[bound])) if len(bound) else []
        bound = bound[order] if len(bound) else bound
        self.node_jobs: list[list[int]] = [[] for _ in range(snap.num_nodes)]
        for j in bound:
            self.node_jobs[int(node_of[j])].append(int(j))


def price_gangs(
    snap: RoundSnapshot,
    shapes: dict,
    *,
    result=None,
    scheduled_this_round: np.ndarray | None = None,
    timeout_s: float | None = None,
) -> dict[str, GangPricingResult]:
    """Price every shape in `shapes` ({name: core.config.GangDefinition})
    against the snapshot as updated by `result` (the round's solve output —
    the reference prices the post-round nodedb). `scheduled_this_round`
    (int64[R], resources the round just scheduled) feeds the round-limit
    pre-check applied before pricing each gang
    (market_driven_indicative_pricer.go:95-111). No side effects."""
    deadline = time.monotonic() + timeout_s if timeout_s else None
    results: dict[str, GangPricingResult] = {}
    state = _NodeState(snap, result)
    # Remaining round headroom (CheckRoundConstraints): fraction caps over
    # total resources minus what the round already scheduled.
    headroom = None
    caps = snap.config.maximum_resource_fraction_to_schedule
    if caps:
        total = snap.total_resources.astype(np.float64)
        cap_vec = np.full(snap.factory.num_resources, np.inf)
        for name, frac in caps.items():
            i = snap.factory.name_to_index.get(name)
            if i is not None:
                cap_vec[i] = frac * total[i]
        used = (
            scheduled_this_round.astype(np.float64)
            if scheduled_this_round is not None
            else 0.0
        )
        headroom = cap_vec - used

    out_of_time = False
    for name in sorted(shapes):
        shape = shapes[name]
        if out_of_time or (deadline is not None and time.monotonic() > deadline):
            out_of_time = True
            results[name] = GangPricingResult(evaluated=False, schedulable=False)
            continue
        results[name] = _price_shape(snap, state, shape, headroom)
    return results


def _price_shape(snap, state, shape, headroom) -> GangPricingResult:
    size = int(shape.size)
    if size < 1:
        return GangPricingResult(True, False, 0.0, REASON_CARDINALITY_ZERO)
    req = snap.factory.from_map(dict(shape.resources), ceil=True)
    gang_req = req * size
    if (gang_req > snap.total_resources).any():
        return GangPricingResult(True, False, 0.0, REASON_EXCEEDS_CAPACITY)
    if headroom is not None and (gang_req.astype(np.float64) > headroom).any():
        return GangPricingResult(True, False, 0.0, REASON_EXCEEDS_CAPACITY)

    # Static member-vs-node feasibility, one vectorized pass
    # (StaticJobRequirementsMet, nodematching.go:161-190).
    sel_bits, possible = snap.label_vocab.selector_bits(shape.node_selector or {})
    if not possible:
        reason = REASON_GANG_DOES_NOT_FIT if size > 1 else REASON_DOES_NOT_FIT
        return GangPricingResult(True, False, 0.0, reason)
    tol_bits = snap.taint_vocab.tolerated_bits(tuple(shape.tolerations or ()))
    req_fit = np.where(snap.floating_mask, 0, req)
    static_ok = (
        ~snap.node_unschedulable
        & ((snap.node_taint_bits & ~tol_bits[None, :]) == 0).all(axis=1)
        & ((sel_bits[None, :] & ~snap.node_label_bits) == 0).all(axis=1)
        & (req_fit[None, :] <= snap.node_total).all(axis=1)
    )

    # Candidate node groups by uniformity label (gang_pricer.go:195-225).
    uniformity = shape.node_uniformity or ""
    if not uniformity:
        groups = [np.flatnonzero(static_ok)]
    else:
        if uniformity not in snap.label_vocab.keys:
            return GangPricingResult(True, False, 0.0, REASON_NOT_INDEXED)
        values = sorted(
            v for (k, v) in snap.label_vocab.pairs if k == uniformity
        )
        if not values:
            return GangPricingResult(True, False, 0.0, REASON_NO_UNIFORMITY_NODES)
        groups = []
        for value in values:
            bits, ok = snap.label_vocab.selector_bits({uniformity: value})
            if not ok:
                continue
            in_group = ((bits[None, :] & ~snap.node_label_bits) == 0).all(axis=1)
            members = np.flatnonzero(static_ok & in_group)
            if len(members):
                groups.append(members)

    best: float | None = None
    for nodes in groups:
        if not len(nodes):
            continue
        cost = _price_on_group(snap, state, nodes, req_fit, size)
        if cost is not None and (best is None or cost < best):
            best = cost
    if best is None:
        reason = REASON_GANG_DOES_NOT_FIT if size > 1 else REASON_DOES_NOT_FIT
        return GangPricingResult(True, False, 0.0, reason)
    return GangPricingResult(True, True, float(best), "")


def _price_on_group(snap, state, nodes, req_fit, size) -> float | None:
    """Place `size` identical members on `nodes`, cheapest-eviction-first,
    updating per-node state between members (gang_pricer.go:113-160).
    Returns max member price, or None if any member cannot be placed.

    The evict-until-fit search (node_scheduler.go:63-99) runs over a FLAT
    segmented layout — one row per bound job in the group, per-node prefix
    sums via one global cumsum minus segment bases — so memory is
    O(bound jobs x R), never nodes x max-jobs-per-node padded."""
    free = state.free0[nodes].copy()  # int64 [Ng, R]
    # Per-node evictable lists (already bid-sorted); copied so binds in one
    # shape/group never leak into the next.
    jobs = [list(state.node_jobs[int(n)]) for n in nodes]
    rank = snap.node_id_rank[nodes]
    gang_cost = 0.0
    for _ in range(size):
        fits = (free >= req_fit[None, :]).all(axis=1)
        hit = np.flatnonzero(fits)
        if len(hit):
            # Price-0 placement (node_scheduler.go:54-61); deterministic
            # node-rank tie-break where the reference uses a fresh ULID.
            g = int(hit[np.argmin(rank[hit])])
            free[g] -= req_fit
            continue
        lengths = np.asarray([len(js) for js in jobs], dtype=np.int64)
        total = int(lengths.sum())
        if total == 0:
            return None
        flat = np.fromiter(
            (j for js in jobs for j in js), dtype=np.int64, count=total
        )
        seg = np.repeat(np.arange(len(nodes)), lengths)
        csum = np.cumsum(state.req_fit[flat], axis=0)  # [B, R]
        starts = np.zeros(len(nodes), dtype=np.int64)
        starts[1:] = np.cumsum(lengths)[:-1]
        # Per-node prefix k (inclusive) = global cumsum minus the base just
        # before the node's segment.
        base = np.zeros_like(csum)
        nz = starts[seg] > 0
        base[nz] = csum[starts[seg][nz] - 1]
        prefix = csum - base
        fits_flat = ((free[seg] + prefix) >= req_fit[None, :]).all(axis=1)
        # First fitting position per node; LARGE = infeasible segment.
        LARGE = total
        pos = np.where(fits_flat, np.arange(total), LARGE)
        first = np.full(len(nodes), LARGE, dtype=np.int64)
        nonempty = lengths > 0
        first[nonempty] = np.minimum.reduceat(pos, starts[nonempty])
        feasible = first < LARGE
        if not feasible.any():
            return None
        price = np.where(feasible, state.bid[flat[first % total]], np.inf)
        order = np.lexsort((rank, price))
        g = int(order[0])
        k = int(first[g] - starts[g]) + 1
        evicted = jobs[g][:k]
        jobs[g] = jobs[g][k:]
        free[g] += state.req_fit[evicted].sum(axis=0) - req_fit
        gang_cost = max(gang_cost, float(price[g]))
    return gang_cost
